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
pdf [N]).
"""

from __future__ import annotations

import dataclasses

import torch

from arendur_tpu_torch.bxdf.types import ALL
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
