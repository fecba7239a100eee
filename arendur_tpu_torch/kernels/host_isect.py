"""The cluster closest-hit / any-hit kernels' per-thread loops (K1 / K2,
the world and the instanced entries) on the host:
``intersect_host.cpp`` built by a host C++ compiler (no nvcc, no card)
and called through ctypes.  For the CPU tests of the
kernels' code and for counts of their work (tools/isect_cpu_counts.py),
never on a render's path.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os

import numpy as np

from arendur_tpu_torch import native

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "intersect_host.cpp")
CHUNK = 64   # triangles per staged chunk (intersect.cuh isect::CHUNK)


@dataclasses.dataclass(frozen=True)
class HostIsect:
    """The host build's entries: arendur_isect_host (the world launches,
    `run`) and arendur_isect_inst_host (the instanced ones,
    `run_instanced`)."""
    isect: object
    inst: object


def build(out_dir: str):
    """The host build, compiled into out_dir: a HostIsect, or None where
    no host C++ compiler is found."""
    if native.host_cxx() is None:
        return None
    lib = native.compile_library(SRC, out_dir)
    dll = ctypes.CDLL(lib)
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    fn = dll.arendur_isect_host
    fn.argtypes = [I, I, P, P, P, P, P, I, P, I, I, L, I, I, I, P, P, P]
    fn.restype = I
    inst = dll.arendur_isect_inst_host
    inst.argtypes = [I, P, P, P, P, P, P, I, P, L, I, I, I, P, P, P, P, P]
    inst.restype = I
    return HostIsect(isect=fn, inst=inst)


def _f32(x):
    return np.ascontiguousarray(np.asarray(x), np.float32)


def _ptr(x):
    return None if x is None else x.ctypes.data


def run(lib, any_hit: bool, w_clusters, cbox, o, d, tmax, n_alive=None,
        period: int = 0, sph_tab=None, full_phi: bool = False,
        rays_per_thread: int = 2):
    """The host build on CPU tensors or arrays: (t [N] f32, slot [N]
    int32) for the closest hit (t unset for the any hit), or (None,
    blocked [N] bool) for the any hit, and need [N, C] uint8: the
    64-triangle chunks each ray needs of each cluster (0 where it does
    not enter the box; the any hit stops at the chunk that blocks it)."""
    w, cb, o, d, tm = (_f32(x) for x in (w_clusters, cbox, o, d, tmax))
    c, _, k4 = w.shape
    n = o.shape[0]
    sph = None if sph_tab is None else _f32(sph_tab)
    ns = 0 if sph is None else sph.shape[0]
    na = n if n_alive is None else int(n_alive)
    t = np.empty(n, np.float32)
    out = np.empty(n, np.int32)
    need = np.empty((n, c), np.uint8)
    code = lib.isect(int(any_hit), rays_per_thread, _ptr(o), _ptr(d),
                     _ptr(tm), _ptr(w), _ptr(cb), na, _ptr(sph), ns,
                     int(bool(full_phi)), n, c, k4 // 4, int(period),
                     _ptr(t), _ptr(out), _ptr(need))
    if code != 0:
        raise ValueError("the intersect kernels refuse these arguments")
    if any_hit:
        return None, out != 0, need
    return t, out, need


def run_instanced(lib, any_hit: bool, w_clusters, cbox, itab, o, d, bound,
                  n_alive=None, blocked=None):
    """The instanced entries' per-ray loop on CPU tensors or arrays: N
    world rays against one instanced mesh (its cluster tables and its
    instance table itab [I, 20], scene.instance_table).  Returns (t [N]
    f32, local slot [N] int32, instance [N] int32) for the closest hit,
    (None, blocked [N] bool, None) for the any hit (blocked [N]: the
    world's flags, ORed in), and (ibox [N, I] bool: the world-box test
    admits the instance at the ray's running bound, need [N, I, C]
    uint8: the chunks the ray needs of each cluster of each
    instance)."""
    w, cb, it, o, d, bd = (_f32(x) for x in (w_clusters, cbox, itab, o, d,
                                             bound))
    c, _, k4 = w.shape
    n, ni = o.shape[0], it.shape[0]
    na = n if n_alive is None else int(n_alive)
    blk = None if blocked is None else np.ascontiguousarray(
        np.asarray(blocked), np.uint8)
    t = np.empty(n, np.float32)
    slot = np.empty(n, np.int32)
    inst = np.empty(n, np.int32)
    ibox = np.empty((n, ni), np.uint8)
    need = np.empty((n, ni, c), np.uint8)
    code = lib.inst(int(any_hit), _ptr(o), _ptr(d), _ptr(bd), _ptr(w),
                    _ptr(cb), _ptr(it), na, _ptr(blk), n, c, k4 // 4, ni,
                    _ptr(t), _ptr(slot), _ptr(inst), _ptr(ibox), _ptr(need))
    if code != 0:
        raise ValueError("the instanced intersect kernels refuse these "
                         "arguments")
    work = (ibox != 0, need)
    if any_hit:
        return None, slot != 0, None, work
    return t, slot, inst, work
