"""Port of arendur_tpu.sampling: sampler, warps, distributions, filters
(ref: src/sample/)."""

from arendur_tpu_torch.sampling.warps import (  # noqa: F401
    sample_uniform_hemisphere, pdf_uniform_hemisphere,
    sample_uniform_sphere, pdf_uniform_sphere,
    sample_concentric_disk, sample_uniform_disk,
    sample_cosw_hemisphere, pdf_cosw_hemisphere,
    sample_uniform_cone, pdf_uniform_cone,
    sample_uniform_triangle, power_heuristic, balance_heuristic,
)
