"""Slot-table BSDF in row form (port of arendur_tpu/bxdf/slots.py).

``BsdfSlots`` holds one hit's shading frame ([N,3] rows ns, ts, bs, ng)
and K = MAX_SLOTS slots ([N,K] type, kind, dist, p0-p2; [N,K,3] c0, c1),
with the host-static per-column type sets ``present`` and the
per-family microfacet-model sets ``dists`` of the JAX package.  The
mixture math itself is the component form of render/cmath.py (CSlots),
which the bounce-shade kernels and their plain versions already run:
the row-form functions here convert and call it, so there is one copy
of the math.

``bsdf_sample`` and ``bsdf_eval_pdf`` are the plain versions of the
slot-sweep kernels (bxdf/slot_shade.py); they keep the JAX return
contract (f [N,3], wi [N,3], pdf [N], sampled kind [N] int32; f [N,3],
pdf [N]).  The JAX package's two separate sweeps ``bsdf_evaluate`` and
``bsdf_pdf`` and the albedo estimators ``rho_hd`` / ``rho_hh`` go
through the dispatchers of bxdf/slot_shade.py: on CUDA tensors the
fused evaluate + pdf kernel (K9) and the sample kernel (K8), on CPU
tensors the plain versions here.
"""

from __future__ import annotations

import dataclasses

import torch

from arendur_tpu_torch.bxdf.types import ALL, REFLECTION, TRANSMISSION
from arendur_tpu_torch.render import cmath as cm

MAX_SLOTS = 3  # glass uses 3 (fresnel + TS-R + TS-T); others fewer


def _c(x: torch.Tensor):
    """[N,3] rows -> a component 3-tuple."""
    return (x[:, 0], x[:, 1], x[:, 2])


def _r(v) -> torch.Tensor:
    """A component 3-tuple -> [N,3] rows."""
    return torch.stack(v, -1)


@dataclasses.dataclass(frozen=True, eq=False)
class BsdfSlots:
    """Per-hit shading frame + K bxdf slots (row form)."""
    ns: torch.Tensor    # [N,3] shading normal (local +z)
    ts: torch.Tensor    # [N,3] shading tangent
    bs: torch.Tensor    # [N,3] shading bitangent
    ng: torch.Tensor    # [N,3] geometric normal
    eta: torch.Tensor   # [N]
    type: torch.Tensor  # [N,K] int32 slot type ids
    kind: torch.Tensor  # [N,K] int32 kind bitflags
    c0: torch.Tensor    # [N,K,3]
    c1: torch.Tensor    # [N,K,3]
    p0: torch.Tensor    # [N,K]
    p1: torch.Tensor    # [N,K]
    p2: torch.Tensor    # [N,K]
    dist: torch.Tensor  # [N,K] int32
    present: tuple = None   # per slot column: sorted type ids (None = any)
    dists: tuple = None     # ((type, (dist ids...)), ...) (None = any)

    @property
    def nslots(self) -> int:
        return self.type.shape[-1]

    def replace(self, **kw) -> "BsdfSlots":
        return dataclasses.replace(self, **kw)

    def to_c(self) -> cm.CSlots:
        """The same slots in component form."""
        k = range(self.nslots)
        return cm.CSlots(
            ns=_c(self.ns), ts=_c(self.ts), bs=_c(self.bs), ng=_c(self.ng),
            eta=self.eta, type=[self.type[:, j] for j in k],
            kind=[self.kind[:, j] for j in k],
            c0=[_c(self.c0[:, j]) for j in k],
            c1=[_c(self.c1[:, j]) for j in k],
            p0=[self.p0[:, j] for j in k], p1=[self.p1[:, j] for j in k],
            p2=[self.p2[:, j] for j in k], dist=[self.dist[:, j] for j in k],
            present=self.present, dists=self.dists)

    @staticmethod
    def from_c(b: cm.CSlots) -> "BsdfSlots":
        st = lambda cols: torch.stack(list(cols), -1)
        return BsdfSlots(
            ns=_r(b.ns), ts=_r(b.ts), bs=_r(b.bs), ng=_r(b.ng), eta=b.eta,
            type=st(b.type), kind=st(b.kind),
            c0=torch.stack([_r(c) for c in b.c0], 1),
            c1=torch.stack([_r(c) for c in b.c1], 1),
            p0=st(b.p0), p1=st(b.p1), p2=st(b.p2), dist=st(b.dist),
            present=b.present, dists=b.dists)


def make_bsdf_frame(ns, ng, dpdu):
    """(ts, bs) [N,3] from the shading normal and the dpdu hint (ref:
    bsdf.rs:36-44)."""
    t, b = cm.make_bsdf_frame(_c(ns), _c(ng), _c(dpdu))
    return _r(t), _r(b)


def match_count(b: BsdfSlots, types: int = ALL) -> torch.Tensor:
    """Number of slots whose kind intersects `types` (ref:
    bsdf.rs:52-62), [N] int32."""
    return ((b.kind & types) != 0).sum(-1, dtype=torch.int32)


def bsdf_eval_pdf(b: BsdfSlots, wow, wiw, types: int = ALL):
    """Fused evaluate + pdf of the mixture (ref: bsdf.rs:82-98,
    205-222): (f [N,3], pdf [N]).  The plain version of kernel K9."""
    f, pdf = cm.bsdf_eval_pdf(b.to_c(), _c(wow), _c(wiw), types)
    return _r(f), pdf


def bsdf_sample(b: BsdfSlots, wow, u, types: int = ALL):
    """Mixture sampling (ref: bsdf.rs:100-144): (f [N,3], wi [N,3],
    pdf [N], sampled kind [N] int32).  The sampled local direction is
    detached.  The plain version of kernel K8."""
    f, wi, pdf, kind = cm.bsdf_sample(b.to_c(), _c(wow), (u[:, 0], u[:, 1]),
                                      types)
    return _r(f), _r(wi), pdf, kind.to(torch.int32)


def _sweeps():
    # slot_shade imports this module
    from arendur_tpu_torch.bxdf import slot_shade
    return slot_shade


def bsdf_evaluate(b: BsdfSlots, wow, wiw, types: int = ALL):
    """Sum of the slots whose kind matches `types` and the side of wi
    (ref: bsdf.rs:82-98): (f [N,3], kinds [N] int32, the matching
    slots' kinds ORed).  f is the fused sweep's (K9 on CUDA tensors)."""
    f, _ = _sweeps().bsdf_eval_pdf(b, wow, wiw, types)
    is_refl = (cm.vdot(_c(wow), _c(b.ng)) * cm.vdot(_c(wiw), _c(b.ng))
               > 0.0)[:, None]
    kind = b.kind
    sel = ((kind & types) != 0) & (
        (is_refl & ((kind & REFLECTION) != 0))
        | (~is_refl & ((kind & TRANSMISSION) != 0)))
    picked = torch.where(sel, kind & types, 0)
    kinds = torch.zeros_like(kind[:, 0])
    for k in range(b.nslots):
        if b.present is None or len(b.present[k]):
            kinds = kinds | picked[:, k]
    return f, kinds.to(torch.int32)


def bsdf_pdf(b: BsdfSlots, wow, wiw, types: int = ALL):
    """Mean pdf over the slots whose kind matches `types` (ref:
    bsdf.rs:205-222), [N]: the fused sweep's (K9 on CUDA tensors)."""
    return _sweeps().bsdf_eval_pdf(b, wow, wiw, types)[1]


def _cos_local(b: BsdfSlots, wiw):
    """|cos theta| of a world direction in the shading frame."""
    wi = cm.vnormalize(cm.to_local(_c(b.ts), _c(b.bs), _c(b.ns), _c(wiw)))
    return torch.abs(wi[2])


def rho_hd(b: BsdfSlots, wow, samples, types: int = ALL):
    """Monte-Carlo hemispherical-directional albedo (ref:
    bxdf/mod.rs:87-99): the mean of f(wo, wi) |cos wi| / pdf over wi
    drawn by bsdf_sample (K8 on CUDA tensors).  samples: [S, N, 2];
    returns [N, 3]."""
    acc = torch.zeros_like(wow)
    for s in range(samples.shape[0]):
        f, wiw, pdf, _ = _sweeps().bsdf_sample(b, wow, samples[s], types)
        term = f * (_cos_local(b, wiw) / torch.clamp(pdf, min=1e-20))[:, None]
        acc = acc + torch.where((pdf > 0.0)[:, None], term, 0.0)
    return acc / samples.shape[0]


def rho_hh(b: BsdfSlots, samples1, samples2, types: int = ALL):
    """Monte-Carlo hemispherical-hemispherical albedo (ref:
    bxdf/mod.rs:101-116): wo uniform over the hemisphere (samples1), wi
    drawn by bsdf_sample (samples2, K8 on CUDA tensors).  samples1 /
    samples2: [S, N, 2]; returns [N, 3]."""
    from arendur_tpu_torch.sampling import warps
    acc = torch.zeros_like(b.ns)
    for s in range(samples1.shape[0]):
        wo = warps.sample_uniform_hemisphere(samples1[s])
        wow = _r(cm.to_world(_c(b.ts), _c(b.bs), _c(b.ns), _c(wo)))
        f, wiw, pdf, _ = _sweeps().bsdf_sample(b, wow, samples2[s], types)
        w = _cos_local(b, wiw) * torch.abs(wo[:, 2]) / torch.clamp(
            pdf * warps.pdf_uniform_hemisphere(), min=1e-20)
        acc = acc + torch.where((pdf > 0.0)[:, None], f * w[:, None], 0.0)
    return acc / (cm.PI * samples1.shape[0])
