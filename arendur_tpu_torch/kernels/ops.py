"""Launch wrappers of the hand-written kernels.

Each wrapper checks device, dtype, shape and contiguity, allocates the
outputs and scratch, launches its kernel on PyTorch's current stream,
raises if the launch was refused, and adds one to its ``launches``
count.  The callers (shapes/cluster_intersect.py, render/cbounce.py,
bxdf/slot_shade.py) reach these only for CUDA tensors.  Each
configuration a kernel takes is packed once and cached (_shade_cfg,
_slot_cfg); no numpy runs on a launch.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import weakref

import numpy as np
import torch

from arendur_tpu_torch.bxdf import slots as sl
from arendur_tpu_torch.kernels import build
from arendur_tpu_torch.render import cbounce as cb
from arendur_tpu_torch.shapes import cluster_intersect as ci
from arendur_tpu_torch.shapes import sphere as sph


class Kernel:
    """A named kernel entry with its launch count."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0

    def launched(self):
        self.launches += 1


CLOSEST_HIT = Kernel("closest_hit")
ANY_HIT = Kernel("any_hit")
# K1 / K2 launches that carry a sphere table (the port of the Pallas
# kernels' _sphere_best branch); each is also one of CLOSEST_HIT's /
# ANY_HIT's launches
CLOSEST_HIT_SPHERES = Kernel("closest_hit_spheres")
ANY_HIT_SPHERES = Kernel("any_hit_spheres")
# the instanced entries of K1 / K2 (N world rays against one instanced
# mesh, kernels/intersect.cu instanced_kernel); the earlier [I * N]-lane
# launches with period N count as CLOSEST_HIT's / ANY_HIT's
CLOSEST_HIT_INSTANCED = Kernel("closest_hit_instanced")
ANY_HIT_INSTANCED = Kernel("any_hit_instanced")
BOUNCE_SHADE = Kernel("bounce_shade")
BOUNCE_SHADE_BWD = Kernel("bounce_shade_bwd")
HIT_SHADE = Kernel("hit_shade")
SHADE_SPLIT = Kernel("shade_split")
SLOT_SAMPLE = Kernel("slot_sample")
SLOT_EVAL_PDF = Kernel("slot_eval_pdf")
# the material-recipe order K8 shades its lanes in (one call, two
# launches, once per BSDF)
SLOT_ORDER = Kernel("slot_order")
KERNELS = (CLOSEST_HIT, ANY_HIT, CLOSEST_HIT_SPHERES, ANY_HIT_SPHERES,
           CLOSEST_HIT_INSTANCED, ANY_HIT_INSTANCED, BOUNCE_SHADE,
           BOUNCE_SHADE_BWD, HIT_SHADE, SHADE_SPLIT, SLOT_SAMPLE,
           SLOT_EVAL_PDF, SLOT_ORDER)


def reset_counts():
    for k in KERNELS:
        k.launches = 0


def counts() -> dict:
    return {k.name: k.launches for k in KERNELS}


def _check(t: torch.Tensor, name: str, dtype=torch.float32, shape=None):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")


def _raise_on(code: int, what: str):
    if code != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {code}")


def _stream(t: torch.Tensor) -> int:
    """PyTorch's current stream on t's card, as the raw handle (the
    lookup torch.cuda.current_stream makes, without its Stream
    object)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def _n_alive_tensor(n_alive, n: int, device) -> torch.Tensor:
    if n_alive is None:
        return torch.full((), n, dtype=torch.int32, device=device)
    return n_alive.to(device=device, dtype=torch.int32).reshape(())


def _cluster_args(w_clusters, cbox, o, d, tmax, n_alive, sph_tab, period):
    n = o.shape[0]
    c, f16, k4 = w_clusters.shape
    if f16 != 16 or k4 % 4:
        raise ValueError("w_clusters must be [C, 16, 4K]")
    _check(w_clusters, "w_clusters")
    if c and w_clusters.data_ptr() % 16:
        raise ValueError("w_clusters must be 16-byte aligned (the kernels "
                         "stage it by bulk copies)")
    _check(cbox, "cbox", shape=(c, 8))
    _check(o, "o", shape=(n, 3))
    _check(d, "d", shape=(n, 3))
    _check(tmax, "tmax", shape=(n,))
    na = _n_alive_tensor(n_alive, n, o.device)
    ns = 0
    if sph_tab is not None:
        ns = sph_tab.shape[0]
        _check(sph_tab, "sph_tab", shape=(ns, 24))
        if ns and period:
            raise ValueError("a sphere table with batched instancing "
                             "(period > 0) is not supported")
    sph = sph_tab.data_ptr() if ns else None
    return n, c, k4 // 4, na, sph, ns


def isect_occupancy(any_hit: bool):
    """What a K1 (any_hit False) or K2 launch holds: (dynamic shared
    memory of a block, the same for a sphere table of any size, blocks
    an SM holds at once; negative: a cudaError)."""
    smem = ctypes.c_int()
    blocks = build.load().arendur_isect_occupancy(int(any_hit),
                                                  ctypes.byref(smem))
    return smem.value, blocks


def isect_encodes() -> int:
    """The TMA descriptors K1 / K2 encoded since the kernels were loaded
    (a launch on weights whose descriptor is cached encodes none)."""
    return int(build.load().arendur_isect_encodes())


def closest_hit(w_clusters, cbox, o, d, tmax, n_alive=None,
                period: int = 0, sph_tab=None, full_phi: bool = False):
    """K1: (t [N] f32, slot [N] int32); slot -1 = miss (t = tmax), -(2+s)
    = a hit on sphere s of sph_tab [S,24] (sphere.kernel_table rows;
    full_phi: skip the phi clip, every sphere being full).  w_clusters
    may hold no cluster (C = 0): the sphere branch alone."""
    lib = build.load()
    n, c, k, na, sph, ns = _cluster_args(w_clusters, cbox, o, d, tmax,
                                         n_alive, sph_tab, period)
    t = torch.empty(n, dtype=torch.float32, device=o.device)
    slot = torch.empty(n, dtype=torch.int32, device=o.device)
    code = lib.arendur_closest_hit(
        o.data_ptr(), d.data_ptr(), tmax.data_ptr(), w_clusters.data_ptr(),
        cbox.data_ptr(), na.data_ptr(), sph, ns, int(bool(full_phi)), n, c,
        k, int(period), t.data_ptr(), slot.data_ptr(), _stream(o))
    _raise_on(code, "closest_hit")
    CLOSEST_HIT.launched()
    if ns:
        CLOSEST_HIT_SPHERES.launched()
    return t, slot


def any_hit(w_clusters, cbox, o, d, tmax, n_alive=None, period: int = 0,
            sph_tab=None, full_phi: bool = False):
    """K2: blocked [N] bool (any hit in (teps, tmax), the spheres of
    sph_tab included)."""
    lib = build.load()
    n, c, k, na, sph, ns = _cluster_args(w_clusters, cbox, o, d, tmax,
                                         n_alive, sph_tab, period)
    blocked = torch.empty(n, dtype=torch.int32, device=o.device)
    code = lib.arendur_any_hit(
        o.data_ptr(), d.data_ptr(), tmax.data_ptr(), w_clusters.data_ptr(),
        cbox.data_ptr(), na.data_ptr(), sph, ns, int(bool(full_phi)), n, c,
        k, int(period), blocked.data_ptr(), _stream(o))
    _raise_on(code, "any_hit")
    ANY_HIT.launched()
    if ns:
        ANY_HIT_SPHERES.launched()
    return blocked != 0


def _instanced_args(w_clusters, cbox, itab, o, d, bound, n_alive):
    n, ni = o.shape[0], itab.shape[0]
    c, f16, k4 = w_clusters.shape
    if f16 != 16 or k4 % 4 or c < 1:
        raise ValueError("w_clusters must be [C, 16, 4K] with C >= 1")
    _check(w_clusters, "w_clusters")
    _check(itab, "itab", shape=(ni, ci.ITAB_COLS))
    if w_clusters.data_ptr() % 16 or itab.data_ptr() % 16:
        raise ValueError("w_clusters and itab must be 16-byte aligned (the "
                         "kernels stage them by bulk and float4 copies)")
    _check(cbox, "cbox", shape=(c, 8))
    _check(o, "o", shape=(n, 3))
    _check(d, "d", shape=(n, 3))
    _check(bound, "bound / tmax", shape=(n,))
    return n, c, k4 // 4, ni, _n_alive_tensor(n_alive, n, o.device)


def closest_hit_instanced(w_clusters, cbox, itab, o, d, bound,
                          n_alive=None):
    """The instanced K1: N world rays against one instanced mesh's
    cluster tables and instance table itab [I, 20], each ray's nearest
    hit over the instances within bound [N]: (t [N] f32, the bound on a
    miss; local slot [N] int32, -1 on a miss; instance [N] int32, 0 on a
    miss, the lowest at equal t)."""
    lib = build.load()
    n, c, k, ni, na = _instanced_args(w_clusters, cbox, itab, o, d, bound,
                                      n_alive)
    t = torch.empty(n, dtype=torch.float32, device=o.device)
    slot = torch.empty(n, dtype=torch.int32, device=o.device)
    inst = torch.empty(n, dtype=torch.int32, device=o.device)
    code = lib.arendur_closest_hit_instanced(
        o.data_ptr(), d.data_ptr(), bound.data_ptr(), w_clusters.data_ptr(),
        cbox.data_ptr(), itab.data_ptr(), na.data_ptr(), n, c, k, ni,
        t.data_ptr(), slot.data_ptr(), inst.data_ptr(), _stream(o))
    _raise_on(code, "closest_hit_instanced")
    CLOSEST_HIT_INSTANCED.launched()
    return t, slot, inst


def any_hit_instanced(w_clusters, cbox, itab, o, d, tmax, n_alive=None,
                      blocked=None):
    """The instanced K2: blocked [N] bool, an instance's triangle within
    tmax ORed with the world's flags `blocked` [N] bool (a ray blocked
    there tests nothing); rays past n_alive are not blocked."""
    lib = build.load()
    n, c, k, ni, na = _instanced_args(w_clusters, cbox, itab, o, d, tmax,
                                      n_alive)
    if blocked is not None:
        _check(blocked, "blocked", dtype=torch.bool, shape=(n,))
    out = torch.empty(n, dtype=torch.bool, device=o.device)
    code = lib.arendur_any_hit_instanced(
        o.data_ptr(), d.data_ptr(), tmax.data_ptr(), w_clusters.data_ptr(),
        cbox.data_ptr(), itab.data_ptr(), na.data_ptr(),
        None if blocked is None else blocked.data_ptr(), n, c, k, ni,
        out.data_ptr(), _stream(o))
    _raise_on(code, "any_hit_instanced")
    ANY_HIT_INSTANCED.launched()
    return out


def isect_inst_occupancy(any_hit: bool, ni: int):
    """What an instanced K1 (any_hit False) or K2 launch over ni
    instances holds: (dynamic shared memory of a block, blocks an SM
    holds at once; negative: a cudaError)."""
    smem = ctypes.c_int()
    blocks = build.load().arendur_isect_inst_occupancy(
        int(any_hit), ni, ctypes.byref(smem))
    return smem.value, blocks


_LCOLS = ("ltype", "emission", "pos", "aux", "params", "tri_v0", "tri_v1",
          "tri_v2", "tri_n0", "tri_n1", "tri_n2", "s_o2w", "s_w2o",
          "s_radius", "s_zmin", "s_zmax", "s_thetamin", "s_thetamax",
          "s_phimax")
CFG_WORDS = 42
SMEM_LIMIT = 227 * 1024


def _mask(types) -> int:
    m = 0
    for t in types:
        m |= 1 << int(t)
    return m


def _slot_words(presence, dist_sets) -> list:
    """The ShadeCfg's slot fields: per-column type masks, their union,
    the single-column flag and the per-family distribution masks."""
    all_types = (1 << 10) - 1
    pres = ([_mask(c) for c in presence]
            if presence is not None else [all_types] * 3)
    nonempty = sum(1 for p in pres if p)
    fam = [0] * 10
    if dist_sets is not None:
        for t, ds in dist_sets:
            fam[int(t)] = _mask(ds)
    return pres + [pres[0] | pres[1] | pres[2],
                   int(presence is not None and nonempty <= 1)] + fam


def _cfg(ints, floats) -> np.ndarray:
    words = np.concatenate([np.asarray(ints, np.int32),
                            np.asarray(floats, np.float32).view(np.int32)])
    assert words.shape == (CFG_WORDS,)
    return words


def pack_shade_cfg(static, min_depth: int, rr_threshold: float,
                   theta_compat: bool) -> np.ndarray:
    """The kernels' ShadeCfg (kernels/cbounce.cuh) as 42 int32 words."""
    lpres = _mask(static.lpresent) if static.lpresent is not None \
        else (1 << 5) - 1
    cidx = dict(static.lcidx)
    cols = [cidx[c][0] if c in cidx else -1 for c in _LCOLS]
    q = max(float(rr_threshold), 0.05)
    ints = _slot_words(static.presence, static.dist_sets) + [lpres] + cols \
        + [int(static.emi_cols[0]), int(min_depth),
           int(bool(static.full_phi)), int(bool(theta_compat))]
    return _cfg(ints, [rr_threshold, q, 1.0 / (1.0 - q)])


def pack_slot_cfg(present, dists) -> np.ndarray:
    """The ShadeCfg of the slot-sweep kernels: the slot fields from a
    BsdfSlots' present / dists sets, no light types, no light columns."""
    ints = _slot_words(present, dists) + [0] + [-1] * len(_LCOLS) \
        + [0, 0, 0, 0]
    return _cfg(ints, [0.0, 0.0, 0.0])


def shade_smem(nl: int, cl: int, nm: int = 0, ns: int = 0) -> int:
    """Bytes of shared memory K3 (K6: nm = ns = 0) takes to stage all
    its tables: each row at the least odd pitch that holds it
    (kernels/cbounce.cuh odd_pitch)."""
    return 4 * (nl * (cl | 1) + nm * 17 + ns * 25)


# the tables K3-K6 stage in shared memory, one bit a table
# (kernels/cbounce.cuh STAGE_*)
STAGE_L, STAGE_M, STAGE_S = 1, 2, 4
STAGE_ALL = STAGE_L | STAGE_M | STAGE_S
# K4's tape kernel also holds a static tape handle in shared memory
# (ptxas: 544 B), which its dynamic part must leave room for
K4_STATIC_SMEM = 1024


@dataclasses.dataclass(frozen=True)
class StagePlan:
    staged: int  # STAGE_* bits of the tables staged in shared memory
    smem: int    # dynamic shared memory of a block (B)


@functools.lru_cache(maxsize=256)
def stage_plan(kernel: str, nl: int = 0, cl: int = 0, nm: int = 0,
               ns: int = 0) -> StagePlan:
    """Which of its tables a launch of `kernel` ("K3", "K4", "K5" or
    "K6") stages in shared memory, and the bytes a block then takes:
    the material, sphere and light tables, those the kernel reads, each
    staged whole, in that order, while it fits beside the ones before in
    SMEM_LIMIT; a table that does not fit is read in place from global
    memory at its dense pitch.  K3 / K6 pad each staged row to an odd
    pitch, K4 / K5 keep the dense rows.  Where every table fits this is
    the launch the kernels always made (K3: shade_smem)."""
    odd = kernel in ("K3", "K6")
    sizes = {STAGE_M: 4 * nm * (17 if odd else 16),
             STAGE_S: 4 * ns * (25 if odd else 24),
             STAGE_L: 4 * nl * ((cl | 1) if odd else cl)}
    reads = {"K3": STAGE_ALL, "K4": STAGE_ALL, "K5": STAGE_S,
             "K6": STAGE_L}[kernel]
    limit = SMEM_LIMIT - (K4_STATIC_SMEM if kernel == "K4" else 0)
    staged, smem = 0, 0
    for bit in (STAGE_M, STAGE_S, STAGE_L):
        if reads & bit and smem + sizes[bit] <= limit:
            staged |= bit
            smem += sizes[bit]
    return StagePlan(staged=staged, smem=smem)


@functools.lru_cache(maxsize=256)
def _shade_cfg(static, min_depth: int, rr_threshold: float,
               theta_compat: bool):
    """A pointer to the packed ShadeCfg, packed once per configuration
    (the pointer keeps its array alive)."""
    return pack_shade_cfg(static, min_depth, rr_threshold,
                          theta_compat).ctypes.data_as(ctypes.c_void_p)


def _n_alive_ptr(n_alive, device):
    """(pointer, tensor) of the live count as an int32 device scalar; a
    null pointer where n_alive is None (every lane live).  The tensor
    must outlive the launch's enqueue."""
    if n_alive is None:
        return None, None
    if n_alive.dtype != torch.int32 or n_alive.device != device:
        n_alive = n_alive.to(device=device, dtype=torch.int32)
    return n_alive.data_ptr(), n_alive


def _shade_args(xt, ltab, mtab, stab):
    """Checked, contiguous inputs of K3 / K4 (their data pointers are
    read directly: no detach is needed)."""
    xt, ltab, mtab, stab = (t.contiguous() for t in (xt, ltab, mtab, stab))
    _check(xt, "xt")
    if xt.dim() != 2 or xt.shape[0] != cb.IN_COLS:
        raise ValueError(f"xt has shape {tuple(xt.shape)}, expected "
                         f"({cb.IN_COLS}, N)")
    _check(ltab, "ltab")
    _check(mtab, "mtab", shape=(mtab.shape[0], 16))
    _check(stab, "stab", shape=(stab.shape[0], 24))
    return xt, ltab, mtab, stab


def bounce_shade(xt, ltab, mtab, stab, static, min_depth: int,
                 rr_threshold: float, n_alive=None):
    """K3: [IN_COLS, N] -> [OUT_COLS, N] on the card, under the dead-lane
    contract for the live count n_alive (render/cbounce.py)."""
    lib = build.load()
    xt, ltab, mtab, stab = _shade_args(xt, ltab, mtab, stab)
    cfg = _shade_cfg(static, min_depth, rr_threshold,
                     sph.THETA_UNIFORM_COMPAT)
    na, _live = _n_alive_ptr(n_alive, xt.device)
    n = xt.shape[1]
    nl, cl = ltab.shape
    nm, ns = mtab.shape[0], stab.shape[0]
    plan = stage_plan("K3", nl, cl, nm, ns)
    out = torch.empty(cb.OUT_COLS, n, dtype=torch.float32, device=xt.device)
    code = lib.arendur_bounce_shade(
        xt.data_ptr(), ltab.data_ptr(), nl, cl, mtab.data_ptr(), nm,
        stab.data_ptr(), ns, plan.staged, n, na, cfg, out.data_ptr(),
        _stream(xt))
    _raise_on(code, "bounce_shade")
    BOUNCE_SHADE.launched()
    return out


def shade_occupancy(ltab, mtab=None, stab=None) -> dict:
    """What a K3 launch over these tables holds (K6's, where mtab and
    stab are None), under its stage_plan: dynamic shared memory of a
    block (B), blocks an SM holds at once, registers and local memory
    (B) a thread, and the plan's staged bits."""
    lib = build.load()
    info = (ctypes.c_int * 4)()
    nl, cl = ltab.shape
    if mtab is None:
        plan = stage_plan("K6", nl, cl)
        code = lib.arendur_shade_split_occupancy(nl, cl, plan.staged, info)
    else:
        plan = stage_plan("K3", nl, cl, mtab.shape[0], stab.shape[0])
        code = lib.arendur_bounce_shade_occupancy(
            nl, cl, mtab.shape[0], stab.shape[0], plan.staged, info)
    _raise_on(code, "shade occupancy")
    return dict(zip(("smem", "blocks_per_sm", "registers", "local_bytes"),
                    info), staged=plan.staged)


def hit_shade(xt, stab):
    """K5: the hit body, [HIT_IN_COLS, N] -> [HIT_OUT_COLS, N] on the
    card (geometry only: no gradient)."""
    lib = build.load()
    xt, stab = xt.detach().contiguous(), stab.detach().contiguous()
    n = xt.shape[1]
    _check(xt, "xt", shape=(cb.HIT_IN_COLS, n))
    _check(stab, "stab", shape=(stab.shape[0], 24))
    ns = stab.shape[0]
    out = torch.empty(cb.HIT_OUT_COLS, n, dtype=torch.float32,
                      device=xt.device)
    code = lib.arendur_hit_shade(xt.data_ptr(), stab.data_ptr(), ns,
                                 stage_plan("K5", ns=ns).staged, n,
                                 out.data_ptr(), _stream(xt))
    _raise_on(code, "hit_shade")
    HIT_SHADE.launched()
    return out


def shade_split(xt, ltab, static, min_depth: int, rr_threshold: float,
                n_alive=None):
    """K6: the split shade body over texture-resolved columns,
    [SHADE_IN_COLS, N] -> [OUT_COLS, N] on the card, under the dead-lane
    contract for the live count n_alive (render/cbounce.py)."""
    lib = build.load()
    xt, ltab = xt.contiguous(), ltab.contiguous()
    _check(xt, "xt")
    if xt.dim() != 2 or xt.shape[0] != cb.SHADE_IN_COLS:
        raise ValueError(f"xt has shape {tuple(xt.shape)}, expected "
                         f"({cb.SHADE_IN_COLS}, N)")
    _check(ltab, "ltab")
    nl, cl = ltab.shape
    cfg = _shade_cfg(static, min_depth, rr_threshold,
                     sph.THETA_UNIFORM_COMPAT)
    na, _live = _n_alive_ptr(n_alive, xt.device)
    n = xt.shape[1]
    out = torch.empty(cb.OUT_COLS, n, dtype=torch.float32, device=xt.device)
    code = lib.arendur_shade_split(
        xt.data_ptr(), ltab.data_ptr(), nl, cl,
        stage_plan("K6", nl, cl).staged, n, na, cfg, out.data_ptr(),
        _stream(xt))
    _raise_on(code, "shade_split")
    SHADE_SPLIT.launched()
    return out


@functools.lru_cache(maxsize=256)
def _slot_cfg(present, dists):
    """(a pointer to the slot sweeps' packed ShadeCfg, its number of
    material-recipe keys), packed once per (present, dists) set (the
    pointer keeps its array alive).  A column of P present types has P +
    1 key codes (kernels/slot_shade.cuh recipe_key)."""
    words = pack_slot_cfg(present, dists)
    nkeys = 1
    for w in words[:sl.MAX_SLOTS]:
        nkeys *= bin(int(w)).count("1") + 1
    return words.ctypes.data_as(ctypes.c_void_p), nkeys


# the BsdfSlots fields the slot sweeps read, in the C entries' order,
# with their dtypes and their shapes past N
_K = sl.MAX_SLOTS
SLOT_FIELDS = (("ns", torch.float32, (3,)), ("ts", torch.float32, (3,)),
               ("bs", torch.float32, (3,)), ("ng", torch.float32, (3,)),
               ("type", torch.int32, (_K,)), ("kind", torch.int32, (_K,)),
               ("dist", torch.int32, (_K,)),
               ("c0", torch.float32, (_K, 3)), ("c1", torch.float32, (_K, 3)),
               ("p0", torch.float32, (_K,)), ("p1", torch.float32, (_K,)),
               ("p2", torch.float32, (_K,)))
ORDER_TILE = 1024   # lanes a block of the order kernels takes


# per BsdfSlots (frozen, eq=False: keyed by identity) the slot sweeps'
# checked arguments, kept for its later calls and dropped with it
_SLOT_ARGS = weakref.WeakKeyDictionary()


def _slot_args(b):
    """(the BSDF's field pointers, N, its device, the ShadeCfg pointer,
    the number of recipe keys): the fields checked and made contiguous
    (a contiguous field is not copied) once per BsdfSlots and kept in
    _SLOT_ARGS with the tensors they point into."""
    got = _SLOT_ARGS.get(b)
    if got is None:
        n = b.ns.shape[0]
        held = []
        for name, dtype, tail in SLOT_FIELDS:
            t = getattr(b, name).contiguous()
            _check(t, name, dtype, (n,) + tail)
            held.append(t)
        if any(t.device != held[0].device for t in held):
            raise ValueError("the BsdfSlots fields lie on several devices")
        cfg, nkeys = _slot_cfg(b.present, b.dists)
        got = _SLOT_ARGS[b] = (
            tuple(t.data_ptr() for t in held), n, held[0].device, cfg,
            nkeys, held)
    return got[:5]


def _lane_args(dev, n: int, *named):
    """Pointers of the per-lane inputs (name, tensor, width), checked to
    lie on dev as contiguous [n, width] f32 (a contiguous input is not
    copied); the tensors are returned to outlive the launch's
    enqueue."""
    held = []
    for name, t, width in named:
        t = t.contiguous()
        _check(t, name, shape=(n, width))
        if t.device != dev:
            raise ValueError(f"{name} lies on {t.device}, the BSDF on {dev}")
        held.append(t)
    return [t.data_ptr() for t in held], held


def _order_ptr(order, n: int, dev):
    _check(order, "order", dtype=torch.int32, shape=(n,))
    if order.device != dev:
        raise ValueError(f"order lies on {order.device}, the BSDF on {dev}")
    return order.data_ptr()


def slot_order(b):
    """The material-recipe order of b's lanes on the card: order [N]
    int32, a stable sort of the lanes by their slot types' key
    (kernels/slot_shade.cuh recipe_key; plain twin:
    bxdf/slot_shade.py lane_order_reference).  One call, two launches
    (each tile's key counts, then its lanes placed); no host sync."""
    lib = build.load()
    ptrs, n, dev, cfg, nkeys = _slot_args(b)
    order = torch.empty(n, dtype=torch.int32, device=dev)
    counts = torch.empty(nkeys * max(1, -(-n // ORDER_TILE)),
                         dtype=torch.int32, device=dev)
    code = lib.arendur_slot_order(ptrs[4], n, cfg, nkeys, counts.data_ptr(),
                                  order.data_ptr(), _stream(order))
    _raise_on(code, "slot_order")
    SLOT_ORDER.launched()
    return order


def slot_sample(b, wo, u, types: int, order):
    """K8: the slot-mixture sample of the BsdfSlots b on the card, read
    where its fields lie: (f [N,3], wi [N,3], pdf [N], kind [N] int32).
    order [N] int32, b's recipe order (slot_order): thread i shades lane
    order[i] (a lane's results do not depend on the order)."""
    lib = build.load()
    ptrs, n, dev, cfg, _ = _slot_args(b)
    ins, _held = _lane_args(dev, n, ("wo", wo, 3), ("u", u, 2))
    f32 = dict(dtype=torch.float32, device=dev)
    f, wi = torch.empty(n, 3, **f32), torch.empty(n, 3, **f32)
    pdf = torch.empty(n, **f32)
    kind = torch.empty(n, dtype=torch.int32, device=dev)
    code = lib.arendur_slot_sample(
        *ptrs, *ins, _order_ptr(order, n, dev), n, int(types), cfg,
        f.data_ptr(), wi.data_ptr(), pdf.data_ptr(), kind.data_ptr(),
        _stream(f))
    _raise_on(code, "slot_sample")
    SLOT_SAMPLE.launched()
    return f, wi, pdf, kind


def slot_eval_pdf(b, wo, wi, types: int):
    """K9: the fused evaluate + pdf of the slot mixture of b on the card,
    read where its fields lie, its lanes in wave order: (f [N,3], pdf
    [N])."""
    lib = build.load()
    ptrs, n, dev, cfg, _ = _slot_args(b)
    ins, _held = _lane_args(dev, n, ("wo", wo, 3), ("wi", wi, 3))
    f = torch.empty(n, 3, dtype=torch.float32, device=dev)
    pdf = torch.empty(n, dtype=torch.float32, device=dev)
    code = lib.arendur_slot_eval_pdf(
        *ptrs, *ins, n, int(types), cfg, f.data_ptr(), pdf.data_ptr(),
        _stream(f))
    _raise_on(code, "slot_eval_pdf")
    SLOT_EVAL_PDF.launched()
    return f, pdf


def _slot_sweep_packed(lib_fn, kernel: Kernel, xt, in_rows: int,
                       out_rows: int, types: int, present, dists):
    xt = xt.detach().contiguous()
    _check(xt, "xt")
    if xt.dim() != 2 or xt.shape[0] != in_rows:
        raise ValueError(f"xt has shape {tuple(xt.shape)}, expected "
                         f"({in_rows}, N)")
    n = xt.shape[1]
    cfg, _ = _slot_cfg(present, dists)
    out = torch.empty(out_rows, n, dtype=torch.float32, device=xt.device)
    code = lib_fn(xt.data_ptr(), n, int(types), cfg, out.data_ptr(),
                  _stream(xt))
    _raise_on(code, kernel.name)
    kernel.launched()
    return out


def slot_sample_packed(xt, types: int, present, dists):
    """The earlier route of K8, kept to be timed beside the new one (no
    render launches it): the lane-major pack of bxdf/slot_shade.py
    pack_slots, [SLOT_COLS + 5, N] -> f wi pdf kind [8, N]."""
    from arendur_tpu_torch.bxdf import slot_shade as ssh
    return _slot_sweep_packed(build.load().arendur_slot_sample_packed,
                              SLOT_SAMPLE, xt, ssh.SAMPLE_IN_COLS,
                              ssh.SAMPLE_OUT_COLS, types, present, dists)


def slot_eval_pdf_packed(xt, types: int, present, dists):
    """The earlier route of K9 (as slot_sample_packed):
    [SLOT_COLS + 6, N] -> f pdf [4, N]."""
    from arendur_tpu_torch.bxdf import slot_shade as ssh
    return _slot_sweep_packed(build.load().arendur_slot_eval_pdf_packed,
                              SLOT_EVAL_PDF, xt, ssh.EVAL_IN_COLS,
                              ssh.EVAL_OUT_COLS, types, present, dists)


# K4's tape: nodes per lane (a fuzzed lane records up to ~2,300, a
# camera-wave lane ~940), 16 bytes a node, and the most lanes in flight
# at once (the kernel walks longer lists in turns).  BWD_BLOCK and
# RED_LANES are kernels/cbounce_bwd.cu's.
TAPE_CAP = 4096
TAPE_THREADS = 1 << 16
NODE_BYTES = 16
BWD_BLOCK = 128
RED_LANES = 256


def bounce_shade_bwd(xt, ltab, mtab, stab, ct, static, min_depth: int,
                     rr_threshold: float, n_alive=None, stats: dict = None):
    """K4: the VJP of K3 (under the dead-lane contract for n_alive) for
    the output cotangent ct [OUT_COLS, N] on the card: (dx [IN_COLS, N],
    dltab, dmtab, dstab).  Only the lanes whose VJP needs the body
    (render/cbounce.py bwd_needs_body) are taped; the others, lanes past
    n_alive among them, take the pass-through.  A taped lane whose
    forward needs more than TAPE_CAP tape nodes comes back NaN.  stats,
    when given, receives "nodes": an int64 device tensor [3], the most
    tape nodes a lane used, their sum over lanes and the number of lanes
    that needed the body (reading it syncs)."""
    lib = build.load()
    xt, ltab, mtab, stab = _shade_args(xt, ltab, mtab, stab)
    cfg = _shade_cfg(static, min_depth, rr_threshold,
                     sph.THETA_UNIFORM_COMPAT)
    na, _live = _n_alive_ptr(n_alive, xt.device)
    n = xt.shape[1]
    ct = ct.detach().to(torch.float32).contiguous()
    _check(ct, "ct", shape=(cb.OUT_COLS, n))
    nl, cl = ltab.shape
    nm, ns = mtab.shape[0], stab.shape[0]
    dev = xt.device
    threads = min(TAPE_THREADS, -(-n // BWD_BLOCK) * BWD_BLOCK)
    f32 = dict(dtype=torch.float32, device=dev)
    tape = torch.empty(TAPE_CAP * threads * NODE_BYTES, dtype=torch.uint8,
                       device=dev)
    lists = torch.empty(2 * n + 1, dtype=torch.int32, device=dev)
    lane_tab = torch.empty(n, 16 + 2 * cl + 24, **f32)
    lane_rows = torch.empty(4, n, dtype=torch.int32, device=dev)
    partials = torch.empty(-(-n // RED_LANES),
                           16 * nm + 2 * nl * cl + 24 * ns, **f32)
    dx = torch.empty(cb.IN_COLS, n, **f32)
    dlt = torch.empty(nl, cl, **f32)
    dmt = torch.empty(nm, 16, **f32)
    dst = torch.empty(ns, 24, **f32)
    nodes = torch.empty(3, dtype=torch.int64, device=dev)
    code = lib.arendur_bounce_shade_bwd(
        xt.data_ptr(), ct.data_ptr(), ltab.data_ptr(), nl, cl,
        mtab.data_ptr(), nm, stab.data_ptr(), ns,
        stage_plan("K4", nl, cl, nm, ns).staged, n, na, cfg,
        tape.data_ptr(), threads,
        TAPE_CAP, lists.data_ptr(), dx.data_ptr(), lane_tab.data_ptr(),
        lane_rows.data_ptr(), partials.data_ptr(), dlt.data_ptr(),
        dmt.data_ptr(), dst.data_ptr(), nodes.data_ptr(), _stream(xt))
    _raise_on(code, "bounce_shade_bwd")
    BOUNCE_SHADE_BWD.launched()
    if stats is not None:
        stats["nodes"] = nodes
    return dx, dlt, dmt, dst
