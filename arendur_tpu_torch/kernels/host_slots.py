"""The slot sweeps' per-lane code (K8 / K9) and their material-recipe
order on the host: ``slot_shade_host.cpp`` built by a host C++ compiler
(no nvcc, no card) and called through ctypes.  For the CPU tests of the
kernels' code, never on a render's path.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os

import numpy as np

from arendur_tpu_torch import native
from arendur_tpu_torch.kernels import ops

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "slot_shade_host.cpp")


@dataclasses.dataclass(frozen=True)
class HostSlots:
    """The host build's entries: the in-place sweeps (`sample`, K8, in a
    given lane order; `eval_pdf`, K9, in wave order), the earlier packed
    sweeps in wave order (`packed`) and the recipe order (`order`)."""
    sample: object
    eval_pdf: object
    packed: object
    order: object


def build(out_dir: str):
    """The host build, compiled into out_dir: a HostSlots, or None where
    no host C++ compiler is found."""
    if native.host_cxx() is None:
        return None
    lib = native.compile_library(SRC, out_dir)
    dll = ctypes.CDLL(lib)
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    sample = dll.arendur_slot_sample_host
    sample.argtypes = [P] * 15 + [L, I, P, P, P, P, P]
    eval_pdf = dll.arendur_slot_eval_pdf_host
    eval_pdf.argtypes = [P] * 14 + [L, I, P, P, P]
    packed = dll.arendur_slot_host_packed
    packed.argtypes = [I, P, L, I, P, P]
    order = dll.arendur_slot_order_host
    order.argtypes = [P, L, P, P, P]
    for fn in (sample, eval_pdf, packed, order):
        fn.restype = I
    return HostSlots(sample=sample, eval_pdf=eval_pdf, packed=packed,
                     order=order)


def _np(t, dtype):
    """A CPU tensor or an array as a contiguous numpy array."""
    if isinstance(t, ops.torch.Tensor):
        t = t.detach().numpy()
    return np.ascontiguousarray(t, dtype)


def _cfg(b):
    return ops.pack_slot_cfg(b.present, b.dists)


def _fields(b):
    return [_np(getattr(b, name), np.float32 if dt == ops.torch.float32
                else np.int32) for name, dt, _ in ops.SLOT_FIELDS]


def sample(lib, b, wo, u, types: int, order):
    """K8's in-place sweep on CPU tensors, lane order[i] shaded i-th:
    (f [N,3], wi [N,3], pdf [N], kind [N] int32), as numpy."""
    fields = _fields(b)
    n = fields[0].shape[0]
    ins = [_np(wo, np.float32), _np(u, np.float32), _np(order, np.int32)]
    f, wi = np.empty((n, 3), np.float32), np.empty((n, 3), np.float32)
    pdf, kind = np.empty(n, np.float32), np.empty(n, np.int32)
    lib.sample(*(a.ctypes.data for a in fields + ins), n, int(types),
               _cfg(b).ctypes.data, f.ctypes.data, wi.ctypes.data,
               pdf.ctypes.data, kind.ctypes.data)
    return f, wi, pdf, kind


def eval_pdf(lib, b, wo, wi, types: int):
    """K9's in-place sweep on CPU tensors, in wave order: (f [N,3], pdf
    [N]), as numpy."""
    fields = _fields(b)
    n = fields[0].shape[0]
    ins = [_np(wo, np.float32), _np(wi, np.float32)]
    f, pdf = np.empty((n, 3), np.float32), np.empty(n, np.float32)
    lib.eval_pdf(*(a.ctypes.data for a in fields + ins), n, int(types),
                 _cfg(b).ctypes.data, f.ctypes.data, pdf.ctypes.data)
    return f, pdf


def sweep_packed(lib, sample: bool, xt, types: int, present, dists):
    """The earlier packed sweep in wave order on a pack_slots input:
    [8, N] (sample) or [4, N] float32, as numpy."""
    xt = _np(xt, np.float32)
    n = xt.shape[1]
    out = np.empty((8 if sample else 4, n), np.float32)
    cfg = ops.pack_slot_cfg(present, dists)
    lib.packed(int(sample), xt.ctypes.data, n, int(types), cfg.ctypes.data,
               out.ctypes.data)
    return out


def order(lib, b):
    """(recipe keys [N], the stable recipe order [N], the number of keys)
    of the host sort, as numpy."""
    t = _np(b.type, np.int32)
    n = t.shape[0]
    keys, od = np.empty(n, np.int32), np.empty(n, np.int32)
    cfg = _cfg(b)
    nkeys = lib.order(t.ctypes.data, n, cfg.ctypes.data, keys.ctypes.data,
                      od.ctypes.data)
    if nkeys < 0:
        raise ValueError("more recipe keys than the order kernels hold")
    return keys, od, nkeys
