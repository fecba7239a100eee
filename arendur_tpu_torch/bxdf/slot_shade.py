"""The BSDF slot sweeps as hand-written kernels: the counterpart of
arendur_tpu/bxdf/pallas_shade.py.

``bsdf_sample(b, wo, u, types)`` (kernel K8, replacing the Pallas
``_sample_kernel``) and ``bsdf_eval_pdf(b, wo, wi, types)`` (kernel K9,
replacing ``_eval_pdf_kernel``) keep the return contract of
bxdf/slots.py, their plain versions: (f [N,3], wi [N,3], pdf [N], kind
[N] int32) and (f [N,3], pdf [N]).  The composed bounce, BPT, Whitted
and the leftover API (slots.bsdf_evaluate / bsdf_pdf / rho_hd /
rho_hh) call them.

On CPU tensors each entry runs its plain version.  On CUDA tensors it
launches its kernel (kernels/slot_shade.cu) on the BsdfSlots fields
where they lie, with wo and u or wi, into outputs the wrapper
allocates; a build or launch failure raises.  K8 shades its lanes in
the BSDF's material-recipe order (``lane_order``: a stable sort by the
lanes' slot types, built on the card once per BsdfSlots and kept in
ORDERS for the BSDF's later samples), so that a warp's lanes
take one path through the slot families; each lane's outputs land at
its own index and equal the plain version's.  K9 shades its lanes in
wave order: on a BPT wave's 161 evaluations the order saved it nothing
and on a composed wave it cost (PERF.md §6).  Each entry is a
torch.autograd.Function whose backward is autograd over the plain
version, as the JAX package's custom_vjp backward is jax.vjp of
slots.*: only the f and pdf cotangents flow, the sampled direction and
kind stay detached.  The TPU kernels' launch slicing for scoped VMEM
has no counterpart.

``pack_slots`` and ``sample_packed`` / ``eval_pdf_packed`` are the
earlier route (a lane-major copy of the BSDF, then the split of the
lane-major outputs), kept only so that it can be timed beside the new
one; no render runs it.
"""

from __future__ import annotations

import weakref

import torch

from arendur_tpu_torch.bxdf import slots as sl
from arendur_tpu_torch.bxdf.types import ALL

SLOT_COLS = 12 + 12 * sl.MAX_SLOTS
SAMPLE_IN_COLS = SLOT_COLS + 5     # + wo, u
SAMPLE_OUT_COLS = 8                # f, wi, pdf, kind
EVAL_IN_COLS = SLOT_COLS + 6       # + wo, wi
EVAL_OUT_COLS = 4                  # f, pdf

# the float fields of a BsdfSlots a gradient may reach
_DIFF = ("ns", "ts", "bs", "ng", "c0", "c1", "p0", "p1", "p2")


def recipe_key_reference(b: sl.BsdfSlots) -> torch.Tensor:
    """The material-recipe key of each lane, [N] int64 (plain twin of
    kernels/slot_shade.cuh recipe_key): per slot column, the place of
    the lane's type in the column's presence set, a type outside it by
    the set's size; the columns' codes in mixed radix (set size + 1)."""
    key = torch.zeros(b.type.shape[0], dtype=torch.int64,
                      device=b.type.device)
    for k in range(b.nslots):
        pres = (tuple(range(10)) if b.present is None
                else tuple(sorted({int(t) for t in b.present[k]})))
        code = torch.full_like(key, len(pres))
        t = b.type[:, k].to(torch.int64)
        for i, ty in enumerate(pres):
            code = torch.where(t == ty, i, code)
        key = key * (len(pres) + 1) + code
    return key


def lane_order_reference(b: sl.BsdfSlots) -> torch.Tensor:
    """The lanes in material-recipe order, [N] int32: a stable sort by
    recipe_key_reference (plain twin of ops.slot_order)."""
    return torch.argsort(recipe_key_reference(b),
                         stable=True).to(torch.int32)


# the recipe order of each BsdfSlots (frozen, eq=False: keyed by
# identity) K8 has sampled, kept for its later samples and dropped with it
ORDERS = weakref.WeakKeyDictionary()


def lane_order(b: sl.BsdfSlots) -> torch.Tensor:
    """b's material-recipe order, built once (on the card by
    ops.slot_order, on the CPU by its plain twin) and kept in ORDERS for
    every later call on b."""
    order = ORDERS.get(b)
    if order is None:
        if b.type.is_cuda:
            from arendur_tpu_torch.kernels import ops
            order = ops.slot_order(b)
        else:
            order = lane_order_reference(b)
        ORDERS[b] = order
    return order


def _replayed(ctx, run, grads, n_in: int = 2):
    """Autograd over the plain version: the input cotangents of
    run(b', wo', x') for the output cotangents `grads`, where wo', x'
    and the float fields of b' are leaf copies of the saved tensors
    (wo, x, *fields)."""
    saved = ctx.saved_tensors
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in saved]
        b = ctx.b.replace(**dict(zip(_DIFF, leaves[n_in:])))
        outs = run(b, *leaves[:n_in])
        pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
        got = torch.autograd.grad([o for o, _ in pairs],
                                  leaves, [g for _, g in pairs],
                                  allow_unused=True)
    need = ctx.needs_input_grad[2:]
    return tuple(g if w else None for g, w in zip(got, need))


class _SampleKernel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, b, types, wo, u, *fields):
        from arendur_tpu_torch.kernels import ops
        f, wi, pdf, kind = ops.slot_sample(b, wo, u, types, lane_order(b))
        ctx.b, ctx.types = b, types
        ctx.save_for_backward(wo, u, *fields)
        ctx.mark_non_differentiable(wi, kind)
        return f, wi, pdf, kind

    @staticmethod
    def backward(ctx, gf, gwi, gpdf, gkind):
        run = lambda b, wo, u: sl.bsdf_sample(b, wo, u, ctx.types)[0::2]
        return (None, None) + _replayed(ctx, run, (gf, gpdf))


class _EvalPdfKernel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, b, types, wo, wi, *fields):
        from arendur_tpu_torch.kernels import ops
        f, pdf = ops.slot_eval_pdf(b, wo, wi, types)
        ctx.b, ctx.types = b, types
        ctx.save_for_backward(wo, wi, *fields)
        return f, pdf

    @staticmethod
    def backward(ctx, gf, gpdf):
        run = lambda b, wo, wi: sl.bsdf_eval_pdf(b, wo, wi, ctx.types)
        return (None, None) + _replayed(ctx, run, (gf, gpdf))


def bsdf_sample(b: sl.BsdfSlots, wo, u, types: int = ALL):
    """Slot-mixture sample (twin: pallas_shade.bsdf_sample): K8 on CUDA
    tensors, slots.bsdf_sample on CPU tensors."""
    if not wo.is_cuda:
        return sl.bsdf_sample(b, wo, u, types)
    return _SampleKernel.apply(b, types, wo, u,
                               *(getattr(b, k) for k in _DIFF))


def bsdf_eval_pdf(b: sl.BsdfSlots, wo, wi, types: int = ALL):
    """Fused evaluate + pdf (twin: pallas_shade.bsdf_eval_pdf): K9 on
    CUDA tensors, slots.bsdf_eval_pdf on CPU tensors."""
    if not wo.is_cuda:
        return sl.bsdf_eval_pdf(b, wo, wi, types)
    return _EvalPdfKernel.apply(b, types, wo, wi,
                                *(getattr(b, k) for k in _DIFF))


# ---------------------------------------------------------------------------
# the earlier route, for timing only
# ---------------------------------------------------------------------------

def pack_slots(b: sl.BsdfSlots, *extra) -> torch.Tensor:
    """The earlier kernels' lane-major input [SLOT_COLS + extra columns,
    N] (detached): b's columns ns ts bs ng, then per slot type kind dist
    (as floats) c0 c1 p0 p1 p2, then the [N, c] tensors of `extra`."""
    n = b.ns.shape[0]
    f = lambda t: t.to(torch.float32)
    x = torch.cat([b.ns, b.ts, b.bs, b.ng, f(b.type), f(b.kind), f(b.dist),
                   b.c0.reshape(n, -1), b.c1.reshape(n, -1), b.p0, b.p1,
                   b.p2] + list(extra), 1)
    return x.detach().T.contiguous()


def sample_packed(b: sl.BsdfSlots, wo, u, types: int = ALL):
    """K8's whole entry call by the earlier route on the card (no
    autograd): the pack, the launch, the split of its [8, N] output."""
    from arendur_tpu_torch.kernels import ops
    out = ops.slot_sample_packed(pack_slots(b, wo, u), types, b.present,
                                 b.dists)
    return (out[0:3].T.contiguous(), out[3:6].T.contiguous(),
            out[6].clone(), out[7].to(torch.int32))


def eval_pdf_packed(b: sl.BsdfSlots, wo, wi, types: int = ALL):
    """K9's whole entry call by the earlier route on the card (as
    sample_packed): the pack, the launch, the split of its [4, N]
    output."""
    from arendur_tpu_torch.kernels import ops
    out = ops.slot_eval_pdf_packed(pack_slots(b, wo, wi), types, b.present,
                                   b.dists)
    return out[0:3].T.contiguous(), out[3].clone()
