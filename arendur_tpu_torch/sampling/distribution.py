"""Piecewise-constant 1-D and 2-D distributions on the device (port of
arendur_tpu/sampling/distribution.py; ref: src/sample/distribution.rs).

The CDFs are built on the host (``build_distribution_1d``, the
scene's, and ``build_distribution_2d``, NumPy); the samplers and pdfs
read a ``Distribution1D`` / ``Distribution2D`` whose leaves are NumPy
arrays or tensors (``DeviceScene.light_distribution`` holds them on
the render's device) and run on the device of their sample or index
tensor.  Light selection by power (NEE's and BPT's) goes through
``sample_discrete``; ``texturing.texture.texture_distribution_2d``
builds the 2-D one over a texture's texels.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from arendur_tpu_torch.scene import Distribution1D, build_distribution_1d

__all__ = ["Distribution1D", "build_distribution_1d", "discrete_pdf",
           "sample_discrete", "sample_continuous", "Distribution2D",
           "build_distribution_2d", "sample_continuous_2d", "pdf_2d"]


def _t(a, device, dtype=torch.float32):
    return torch.as_tensor(a, dtype=dtype, device=device)


def _leaves(dist, device):
    return _t(dist.func, device), _t(dist.cdf, device), float(dist.func_int)


def discrete_pdf(dist, idx: torch.Tensor) -> torch.Tensor:
    """Probability of index idx [N] (ref: distribution.rs:99-118)."""
    func, _, func_int = _leaves(dist, idx.device)
    n = func.shape[0]
    if func_int > 0.0:
        return func[idx.long()] / (torch.tensor(func_int,
                                                dtype=torch.float32) * n)
    return torch.full(idx.shape, 1.0 / n, dtype=torch.float32,
                      device=idx.device)


def sample_discrete(dist, u: torch.Tensor):
    """Sample an index for uniforms u [N]: (idx int64 [N], pdf [N])
    (ref: distribution.rs:99-118)."""
    func, cdf, _ = _leaves(dist, u.device)
    n = func.shape[0]
    idx = torch.clamp(torch.searchsorted(cdf, u, right=True) - 1, 0, n - 1)
    return idx, discrete_pdf(dist, idx)


def sample_continuous(dist, u: torch.Tensor):
    """Sample x in [0, 1) for uniforms u [...]: (x, pdf, idx int64)
    (ref: distribution.rs:61-96)."""
    func, cdf, func_int = _leaves(dist, u.device)
    n = func.shape[0]
    idx = torch.clamp(torch.searchsorted(cdf, u.contiguous(), right=True)
                      - 1, 0, n - 1)
    c0, c1 = cdf[idx], cdf[idx + 1]
    denom = torch.where(c1 > c0, c1 - c0, 1.0)
    x = (idx.to(u.dtype) + (u - c0) / denom) / n
    if func_int > 0.0:
        pdf = func[idx] / torch.tensor(func_int, dtype=torch.float32)
    else:
        pdf = torch.ones_like(u)
    return x, pdf, idx


@dataclasses.dataclass(frozen=True)
class Distribution2D:
    """Conditional rows and their marginal (ref: distribution.rs:163-213),
    the row CDFs stacked into one [ny, nx+1] array, so a sample is two
    batched searches."""
    cond_func: np.ndarray       # [ny, nx]
    cond_cdf: np.ndarray        # [ny, nx+1]
    cond_int: np.ndarray        # [ny]
    marginal: Distribution1D    # over rows

    @property
    def shape(self):
        return tuple(self.cond_func.shape)


def build_distribution_2d(func) -> Distribution2D:
    """Host-side build; func: [ny, nx] non-negative (e.g. a luminance
    image).  A row of zeros samples uniformly."""
    f = np.asarray(func, np.float32)
    ny, nx = f.shape
    cdf = np.zeros((ny, nx + 1), np.float32)
    cdf[:, 1:] = np.cumsum(f / nx, axis=1)
    func_int = cdf[:, -1].copy()
    uniform = np.arange(nx + 1, dtype=np.float32) / nx
    for y in range(ny):
        if func_int[y] == 0.0:
            cdf[y] = uniform
        else:
            cdf[y] /= func_int[y]
    return Distribution2D(cond_func=f, cond_cdf=cdf, cond_int=func_int,
                          marginal=build_distribution_1d(func_int))


def sample_continuous_2d(dist: Distribution2D, u2: torch.Tensor):
    """Sample (x, y) in [0, 1)^2 for uniforms u2 [..., 2]: (xy [..., 2],
    pdf [...]) (ref: distribution.rs:189-204)."""
    dev = u2.device
    ny, nx = dist.shape
    cond_func = _t(dist.cond_func, dev)
    y, pdf_y, yi = sample_continuous(dist.marginal, u2[..., 1])
    cdf_row = _t(dist.cond_cdf, dev)[yi]                  # [..., nx+1]
    u = u2[..., 0]
    xi = torch.clamp(torch.searchsorted(cdf_row, u[..., None].contiguous(),
                                        right=True)[..., 0] - 1, 0, nx - 1)
    c0 = torch.gather(cdf_row, -1, xi[..., None])[..., 0]
    c1 = torch.gather(cdf_row, -1, xi[..., None] + 1)[..., 0]
    denom = torch.where(c1 > c0, c1 - c0, 1.0)
    x = (xi.to(u.dtype) + (u - c0) / denom) / nx
    fint = _t(dist.cond_int, dev)[yi]
    pdf_x = torch.where(fint > 0.0,
                        cond_func[yi, xi] / torch.clamp(fint, min=1e-20), 1.0)
    return torch.stack([x, y], -1), pdf_x * pdf_y


def pdf_2d(dist: Distribution2D, xy: torch.Tensor) -> torch.Tensor:
    """pdf of sample_continuous_2d at xy [..., 2] (ref:
    distribution.rs:206-213)."""
    ny, nx = dist.shape
    xi = torch.clamp((xy[..., 0] * nx).to(torch.int64), 0, nx - 1)
    yi = torch.clamp((xy[..., 1] * ny).to(torch.int64), 0, ny - 1)
    mint = float(dist.marginal.func_int)
    if mint > 0.0:
        return _t(dist.cond_func, xy.device)[yi, xi] \
            / torch.tensor(max(mint, 1e-20), dtype=torch.float32)
    return torch.ones(xy.shape[:-1], dtype=torch.float32, device=xy.device)
