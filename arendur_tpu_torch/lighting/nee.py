"""Light selection for next-event estimation (port of
arendur_tpu/lighting/nee.py:41, ``sample_one_light``; ref:
src/renderer/scene.rs:169-173).

The per-type light sampling, light pdf and MIS weights run inside the
bounce shade (render/cbounce.py), as in the JAX package's fused path.
"""

from __future__ import annotations

import torch


def sample_discrete(cdf: torch.Tensor, func: torch.Tensor,
                    func_int: float, u: torch.Tensor):
    """Sample an index of a piecewise-constant distribution; returns
    (idx int64, pdf) (ref: distribution.rs:99-118)."""
    n = func.shape[0]
    idx = torch.clamp(torch.searchsorted(cdf, u, right=True) - 1, 0, n - 1)
    if func_int > 0.0:
        pdf = func[idx] / (torch.tensor(func_int, dtype=torch.float32)
                           * n)
    else:
        pdf = torch.full_like(u, 1.0 / n)
    return idx, pdf


def sample_one_light(scene, u: torch.Tensor):
    """Power-weighted light pick for a DeviceScene: (lidx, selpdf)."""
    return sample_discrete(scene.light_cdf, scene.light_func,
                           scene.light_func_int, u)
