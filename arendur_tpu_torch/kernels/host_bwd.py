"""The bounce-shade backward's per-lane code (K4) on the host:
``cbounce_bwd_host.cpp`` built by a host C++ compiler (no nvcc, no
card) and called through ctypes.  It walks the lanes in order on one
host tape: for the CPU tests of K4's code and for counts of its work
(tools/k4_cpu_counts.py), never on a render's path.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from arendur_tpu_torch import native
from arendur_tpu_torch.kernels import ops
from arendur_tpu_torch.render import cbounce as cb
from arendur_tpu_torch.shapes import sphere as sph

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "cbounce_bwd_host.cpp")


def build(out_dir: str):
    """The host entry arendur_bounce_shade_bwd_host, built into out_dir;
    None where no host C++ compiler is found."""
    if native.host_cxx() is None:
        return None
    lib = native.compile_library(SRC, out_dir)
    fn = ctypes.CDLL(lib).arendur_bounce_shade_bwd_host
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    fn.argtypes = [P, P, P, I, I, P, I, P, I, L, L, P, I, P, P, P, P, P, P]
    fn.restype = I
    return fn


def run(fn, xt, ct, ltab, mtab, stab, static, min_depth, rr, n_alive=None):
    """(dx, dltab, dmtab, dstab, need [N] bool, nodes [N], lanes past
    the tape's cap) of the host build on CPU tensors, as numpy, under
    the dead-lane contract for the live count n_alive (None: every lane
    is live)."""
    xt, ct, lt, mt, st = (np.ascontiguousarray(t.numpy(), np.float32)
                          for t in (xt, ct, ltab, mtab, stab))
    n = xt.shape[1]
    na = n if n_alive is None else int(n_alive)
    cfg = ops.pack_shade_cfg(static, min_depth, rr,
                             sph.THETA_UNIFORM_COMPAT)
    dx = np.empty((cb.IN_COLS, n), np.float32)
    dlt, dmt, dst = np.empty_like(lt), np.empty_like(mt), np.empty_like(st)
    need = np.empty(n, np.int32)
    nodes = np.empty(n, np.int32)
    p = lambda a: a.ctypes.data  # noqa: E731
    failed = fn(p(xt), p(ct), p(lt), lt.shape[0], lt.shape[1], p(mt),
                mt.shape[0], p(st), st.shape[0], n, na, p(cfg), ops.TAPE_CAP,
                p(dx), p(dlt), p(dmt), p(dst), p(need), p(nodes))
    return dx, dlt, dmt, dst, need.astype(bool), nodes, failed
