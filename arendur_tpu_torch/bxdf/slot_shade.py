"""The BSDF slot sweeps as hand-written kernels: the counterpart of
arendur_tpu/bxdf/pallas_shade.py.

``bsdf_sample(b, wo, u, types)`` (kernel K8, replacing the Pallas
``_sample_kernel``) and ``bsdf_eval_pdf(b, wo, wi, types)`` (kernel K9,
replacing ``_eval_pdf_kernel``) keep the return contract of
bxdf/slots.py, their plain versions: (f [N,3], wi [N,3], pdf [N], kind
[N] int32) and (f [N,3], pdf [N]).  The composed bounce calls them for
the continuation sample and for the NEE light branch.

On CPU tensors each entry runs its plain version.  On CUDA tensors it
launches its kernel (kernels/slot_shade.cu) on the lane-major pack of
the BSDF (``pack_slots``: [SLOT_COLS, N] columns ns ts bs ng, then per
slot type kind dist c0 c1 p0 p1 p2), followed by wo and u or wi; a
build or launch failure raises.  Each entry is a torch.autograd.Function
whose backward is autograd over the plain version, as the JAX package's
custom_vjp backward is jax.vjp of slots.*: only the f and pdf
cotangents flow, the sampled direction and kind stay detached.  The
TPU kernels' launch slicing for scoped VMEM has no counterpart.
"""

from __future__ import annotations

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


def pack_slots(b: sl.BsdfSlots, *extra) -> torch.Tensor:
    """The kernels' lane-major input [SLOT_COLS + extra columns, N]
    (detached): b's columns, then the [N, c] tensors of `extra`."""
    n = b.ns.shape[0]
    f = lambda t: t.to(torch.float32)
    x = torch.cat([b.ns, b.ts, b.bs, b.ng, f(b.type), f(b.kind), f(b.dist),
                   b.c0.reshape(n, -1), b.c1.reshape(n, -1), b.p0, b.p1,
                   b.p2] + list(extra), 1)
    return x.detach().T.contiguous()


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
        out = ops.slot_sample(pack_slots(b, wo, u), types, b.present,
                              b.dists)
        f = out[0:3].T.contiguous()
        wi = out[3:6].T.contiguous()
        pdf = out[6].clone()
        kind = out[7].to(torch.int32)
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
        out = ops.slot_eval_pdf(pack_slots(b, wo, wi), types, b.present,
                                b.dists)
        ctx.b, ctx.types = b, types
        ctx.save_for_backward(wo, wi, *fields)
        return out[0:3].T.contiguous(), out[3].clone()

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
