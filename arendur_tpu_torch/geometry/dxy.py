"""uv footprint of a ray cone at a hit (port of
arendur_tpu/geometry/dxy.py:53-121, row form).

The wavefront carries a per-ray cone (width and spread) instead of the
reference's differential rays (interaction.rs:204-224, 236-252);
``cone_duv`` turns the cone's footprint ellipse at a hit into the two
uv derivatives the texture lookups take.  The bounce's hit kernel
computes the same in component form (render/cbounce.py
``_cone_duv_c``); these row-form functions are the tests' reference.
"""

from __future__ import annotations

import torch


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], -1)


def _normalize(a):
    n2 = torch.clamp(_dot(a, a)[..., None], min=1e-30)
    return a * torch.sqrt(1.0 / n2)


def _solve_duv(nrm, dpdu, dpdv, dp):
    """Least-squares duv from dp = dpdu du + dpdv dv, dropping the axis
    where |n| is largest (ref: interaction.rs:216-224,318-325)."""
    amax = torch.argmax(torch.abs(nrm), dim=-1)
    # the two other axes: (1,2), (0,2), (0,1) for amax = 0, 1, 2
    a0 = torch.where(amax == 0, 1, 0)[:, None]
    a1 = torch.where(amax == 2, 1, 2)[:, None]
    pick = lambda v, a: torch.gather(v, 1, a)[:, 0]
    A00, A01 = pick(dpdu, a0), pick(dpdv, a0)
    A10, A11 = pick(dpdu, a1), pick(dpdv, a1)
    b0, b1 = pick(dp, a0), pick(dp, a1)
    det = A00 * A11 - A01 * A10
    ok = torch.abs(det) > 1e-20
    inv = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    du = (A11 * b0 - A01 * b1) * inv
    dv = (A00 * b1 - A10 * b0) * inv
    return du, dv


def cone_duv(r, d, ng, dpdu, dpdv):
    """uv footprint of a ray cone of width r [N] arriving along d [N,3]:
    an ellipse with major axis r / |cos theta| along the projected view
    direction and minor axis r across it (ray-cone LOD).  Returns
    (duvdx [N,2], duvdy [N,2]).  The inverse length is 1 / sqrt, the
    form the hit kernel and its plain version use."""
    cos_i = _dot(d, ng)
    proj = d - cos_i[..., None] * ng
    p2 = torch.sum(proj * proj, -1, keepdim=True)
    rs = 1.0 / torch.sqrt(torch.clamp(p2, min=1e-30))
    e1 = torch.where(p2 > 1e-12, proj * rs, _normalize(dpdu))
    e2 = _cross(ng, e1)
    a1 = (r / torch.clamp(torch.abs(cos_i), min=0.1))[..., None] * e1
    a2 = r[..., None] * e2
    dudx, dvdx = _solve_duv(ng, dpdu, dpdv, a1)
    dudy, dvdy = _solve_duv(ng, dpdu, dpdv, a2)
    return torch.stack([dudx, dvdx], -1), torch.stack([dudy, dvdy], -1)
