"""Warp functions over row tensors (port of the part of
arendur_tpu/sampling/warps.py that light emission and camera importance
use; ref: src/sample/mod.rs:132-254).

Each takes u as an [N, 2] uniform sample and returns [N, 2] or [N, 3]
rows.  The concentric disk and the cosine hemisphere are the component
forms of render/cmath.py, stacked, so there is one copy of that math.
"""

from __future__ import annotations

import math

import torch

from arendur_tpu_torch.render import cmath as cm

PI = math.pi
INV_PI = 1.0 / PI


def _u(u):
    return (u[..., 0], u[..., 1])


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
