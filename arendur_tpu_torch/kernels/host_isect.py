"""The cluster closest-hit / any-hit kernels' per-thread loop (K1 / K2)
on the host: ``intersect_host.cpp`` built by a host C++ compiler (no
nvcc, no card) and called through ctypes.  For the CPU tests of the
kernels' code and for counts of their work (tools/isect_cpu_counts.py),
never on a render's path.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

import numpy as np

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "intersect_host.cpp")
CHUNK = 64   # triangles per staged chunk (intersect.cuh isect::CHUNK)


def build(out_dir: str):
    """The host entry arendur_isect_host, built into out_dir; None where
    no host C++ compiler is found."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return None
    lib = os.path.join(out_dir, "libisect_host.so")
    # -ffp-contract=off: no multiply-add contraction, as nvcc -fmad=false
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off",
                    "-shared", "-fPIC", "-o", lib, SRC],
                   check=True, capture_output=True, timeout=600)
    fn = ctypes.CDLL(lib).arendur_isect_host
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    fn.argtypes = [I, I, P, P, P, P, P, I, P, I, I, L, I, I, I, P, P, P]
    fn.restype = I
    return fn


def run(fn, any_hit: bool, w_clusters, cbox, o, d, tmax, n_alive=None,
        period: int = 0, sph_tab=None, full_phi: bool = False,
        rays_per_thread: int = 2):
    """The host build on CPU tensors or arrays: (t [N] f32, slot [N]
    int32) for the closest hit (t unset for the any hit), or (None,
    blocked [N] bool) for the any hit, and need [N, C] uint8: the
    64-triangle chunks each ray needs of each cluster (0 where it does
    not enter the box; the any hit stops at the chunk that blocks it)."""
    a = lambda x: np.ascontiguousarray(np.asarray(x), np.float32)  # noqa
    w, cb, o, d, tm = (a(x) for x in (w_clusters, cbox, o, d, tmax))
    c, _, k4 = w.shape
    n = o.shape[0]
    sph = None if sph_tab is None else a(sph_tab)
    ns = 0 if sph is None else sph.shape[0]
    na = n if n_alive is None else int(n_alive)
    t = np.empty(n, np.float32)
    out = np.empty(n, np.int32)
    need = np.empty((n, c), np.uint8)
    p = lambda x: None if x is None else x.ctypes.data  # noqa: E731
    code = fn(int(any_hit), rays_per_thread, p(o), p(d), p(tm), p(w),
              p(cb), na, p(sph), ns, int(bool(full_phi)), n, c, k4 // 4,
              int(period), p(t), p(out), p(need))
    if code != 0:
        raise ValueError("the intersect kernels refuse these arguments")
    if any_hit:
        return None, out != 0, need
    return t, out, need
