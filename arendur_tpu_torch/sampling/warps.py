"""Warp functions and MIS heuristics over row tensors (port of
arendur_tpu/sampling/warps.py; ref: src/sample/mod.rs:132-254).

Each warp takes u as an [N, 2] uniform sample and returns [N, 2] or
[N, 3] rows.  The concentric disk, the cosine hemisphere and the
uniform triangle are the component forms of render/cmath.py, stacked,
and the power heuristic is cmath's, so there is one copy of that math.
"""

from __future__ import annotations

import math

import torch

from arendur_tpu_torch.render import cmath as cm
# the beta = 2 power heuristic (ref: sample/mod.rs:243-247), the
# denominator clamped so 0/0 lanes stay finite
from arendur_tpu_torch.render.cmath import power_heuristic  # noqa: F401

PI = math.pi
INV_PI = 1.0 / PI


def _u(u):
    return (u[..., 0], u[..., 1])


def sample_uniform_hemisphere(u):
    """Uniform direction about +z (ref: sample/mod.rs:132-137, whose
    formula sin(theta) = sqrt(max(1 - cos(theta), 0)) is kept)."""
    costheta = u[..., 0]
    sintheta = torch.sqrt(torch.clamp(1.0 - costheta, min=0.0))
    phi = 2.0 * PI * u[..., 1]
    return torch.stack([sintheta * torch.cos(phi), sintheta * torch.sin(phi),
                        costheta], -1)


def pdf_uniform_hemisphere():
    return 0.5 * INV_PI


def sample_uniform_disk(u):
    """Uniform point on the unit disk (polar): [N, 2]."""
    r = torch.sqrt(u[..., 0])
    theta = 2.0 * PI * u[..., 1]
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], -1)


def sample_concentric_disk(u):
    """Concentric disk warp (ref: sample/mod.rs:165-177): [N, 2]."""
    return torch.stack(cm.sample_concentric_disk(_u(u)), -1)


def sample_cosw_hemisphere(u):
    """Cosine-weighted hemisphere about +z (ref: sample/mod.rs:203-207)."""
    return torch.stack(cm.sample_cosw_hemisphere(_u(u)), -1)


def pdf_cosw_hemisphere(cos_theta):
    return cos_theta * INV_PI


def sample_uniform_sphere(u):
    costheta = 1.0 - 2.0 * u[..., 0]
    sintheta = torch.sqrt(torch.clamp(1.0 - costheta * costheta, min=0.0))
    phi = 2.0 * PI * u[..., 1]
    return torch.stack([sintheta * torch.cos(phi), sintheta * torch.sin(phi),
                        costheta], -1)


def pdf_uniform_sphere():
    return 0.25 * INV_PI


def sample_uniform_cone(u, cos_max):
    """Uniform direction in the cone of cos_max [N] about +z."""
    costheta = (1.0 - u[..., 0]) + u[..., 0] * cos_max
    sintheta = torch.sqrt(torch.clamp(1.0 - costheta * costheta, min=0.0))
    phi = 2.0 * PI * u[..., 1]
    return torch.stack([sintheta * torch.cos(phi), sintheta * torch.sin(phi),
                        costheta], -1)


def pdf_uniform_cone(cos_max):
    return 1.0 / ((1.0 - cos_max) * 2.0 * PI)


def sample_uniform_triangle(u):
    """Uniform barycentrics (x, y, 1 - x - y) (ref: sample/mod.rs:234-239):
    [N, 3]."""
    return torch.stack(cm.sample_uniform_triangle(_u(u)), -1)


def balance_heuristic(nf, pdff, ng, pdfg):
    """Balance heuristic, the denominator clamped as the power
    heuristic's."""
    f = nf * pdff
    g = ng * pdfg
    return f / torch.clamp(f + g, min=1e-30)
