"""Piecewise-constant 1-D distributions on the device (port of
arendur_tpu/sampling/distribution.py; ref: src/sample/distribution.rs).

The CDF is built on the host (``scene.build_distribution_1d``, NumPy);
``sample_discrete`` and ``discrete_pdf`` read a ``scene.Distribution1D``
whose leaves are NumPy arrays or tensors (``DeviceScene.light_distribution``
holds them on the render's device) and run on the device of their
sample or index tensor.  Light selection by power (NEE's and BPT's)
goes through them.
"""

from __future__ import annotations

import torch


def _leaves(dist, device):
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    return f(dist.func), f(dist.cdf), float(dist.func_int)


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
