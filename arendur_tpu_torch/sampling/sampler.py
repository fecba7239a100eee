"""Stateless wavefront sampler (port of arendur_tpu/sampling/sampler.py).

Every ray owns a key derived from (seed, pixel_id, sample_id) and each
consumed dimension hashes a static dimension counter with it (pcg4d,
Jarzynski & Olano, JCGT 2020), so a render is a pure function of the
seed and lanes may be reordered freely.

The hash is u32 integer arithmetic.  PyTorch cannot shift uint32
tensors on every device, so words are int64 tensors holding values in
[0, 2^32) and every multiply and add is masked back to 32 bits; the
results match the JAX package bit for bit.  No RNG state is held
anywhere.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
# 1/2^24 : uniforms from the top 24 bits, exactly representable in f32
_INV24 = 1.0 / 16777216.0


def _mul(a, b):
    return (a * b) & _M32


def _add(a, b):
    return (a + b) & _M32


def _pcg4d(a, b, c, d):
    """One pcg4d round over four u32 words (int64 tensors)."""
    a = _add(_mul(a, 1664525), 1013904223)
    b = _add(_mul(b, 1664525), 1013904223)
    c = _add(_mul(c, 1664525), 1013904223)
    d = _add(_mul(d, 1664525), 1013904223)
    a = _add(a, _mul(b, d))
    b = _add(b, _mul(c, a))
    c = _add(c, _mul(a, b))
    d = _add(d, _mul(b, c))
    a = a ^ (a >> 16)
    b = b ^ (b >> 16)
    c = c ^ (c >> 16)
    d = d ^ (d >> 16)
    a = _add(a, _mul(b, d))
    b = _add(b, _mul(c, a))
    c = _add(c, _mul(a, b))
    d = _add(d, _mul(b, c))
    return a, b, c, d


def make_base_key(seed: int) -> tuple:
    """The JAX package's ``jax.random.PRNGKey(seed)`` key data: the
    two u32 words (0, seed)."""
    return (0, int(seed) & _M32)


def ray_keys(base_key, pixel_id: torch.Tensor,
             sample_id: torch.Tensor) -> torch.Tensor:
    """One key per ray: [N, 2] int64 holding u32 words (seed-mixed
    pixel word, sample word)."""
    k_hi, k_lo = base_key
    mix = (k_lo * 0x9E3779B9 + k_hi) & _M32
    k0 = (pixel_id.to(torch.int64) & _M32) ^ mix
    k1 = sample_id.to(torch.int64) & _M32
    return torch.stack([k0, k1], dim=-1)


def _full(keys, v):
    return torch.full(keys.shape[:-1], v, dtype=torch.int64,
                      device=keys.device)


def _to_unit(a):
    return (a >> 8).to(torch.float32) * _INV24


def uniform_1d(keys, dim: int):
    """One uniform per ray for static dimension index `dim`."""
    a, _, _, _ = _pcg4d(keys[..., 0], keys[..., 1], _full(keys, dim),
                        _full(keys, 0x2545F491))
    return _to_unit(a)


def uniform_2d(keys, dim: int):
    """[N, 2] uniforms for dimensions (dim, dim+1)."""
    a, b, _, _ = _pcg4d(keys[..., 0], keys[..., 1], _full(keys, dim),
                        _full(keys, 0x2545F491))
    return torch.stack([_to_unit(a), _to_unit(b)], dim=-1)


def _permute_pow2(i, n: int, seed):
    """Stateless bijective permutation of [0, n) for power-of-two n
    (Kensler, "Correlated Multi-Jittered Sampling", 2013)."""
    w = n - 1
    i = i & w
    i = i ^ seed
    i = _mul(i, 0xe170893d)
    i = i ^ (seed >> 16)
    i = i ^ ((i & w) >> 4)
    i = i ^ (seed >> 8)
    i = _mul(i, 0x0929eb3f)
    i = i ^ (seed >> 23)
    i = i ^ ((i & w) >> 1)
    i = _mul(i, 1 | (seed >> 27))
    i = _mul(i, 0x6935fa69)
    i = i ^ ((i & w) >> 11)
    i = _mul(i, 0x74dcca23)
    i = i ^ (seed >> 2)
    i = _mul(i, 0x9e501cc3)
    i = i ^ ((i & w) >> 2)
    i = _mul(i, 0xc860a3df)
    i = i & w
    i = i ^ (i >> 5)
    return (i + seed) & w


def _dim_seed(keys, dim: int):
    """Per-(pixel, dim) permutation key, decorrelated from the jitter
    stream (different mixing constant)."""
    a, _, _, _ = _pcg4d(keys[..., 0], _full(keys, dim),
                        _full(keys, 0x8F1BBCDC), _full(keys, 0xCA62C1D6))
    return a


def _pow2(n: int) -> bool:
    return n >= 2 and (n & (n - 1)) == 0


def stratified_1d(keys, spp: int, dim: int):
    """Per-pixel stratified 1-D draw: sample s lands in stratum
    permute(s) of spp strata, jittered.  Non-power-of-two spp falls
    back to the independent uniform."""
    u = uniform_1d(keys, dim)
    if not _pow2(spp):
        return u
    stratum = _permute_pow2(keys[..., 1], spp, _dim_seed(keys, dim))
    return (stratum.to(torch.float32) + u) / spp


def stratified_2d(keys, dx: int, dy: int, dim: int):
    """Per-pixel stratified 2-D draw over a dx*dy cell grid with a
    per-(pixel, dim) cell shuffle + jitter."""
    u = uniform_2d(keys, dim)
    spp = dx * dy
    if not _pow2(spp) or dx < 1 or dy < 1:
        return u
    cell = _permute_pow2(keys[..., 1], spp, _dim_seed(keys, dim))
    cx = (cell % dx).to(torch.float32)
    cy = (cell // dx).to(torch.float32)
    jx = (cx + u[..., 0]) / dx
    jy = (cy + u[..., 1]) / dy
    return torch.stack([jx, jy], dim=-1)


def stratified_film_sample(keys, sample_id, dx: int, dy: int,
                           dim: int = 0):
    """Stratified sub-pixel offset in [0,1)^2: sample s maps to stratum
    ((s % dx), (s // dx) % dy), jittered inside it."""
    u = uniform_2d(keys, dim)
    sx = (sample_id % dx).to(torch.float32)
    sy = ((sample_id // dx) % dy).to(torch.float32)
    jx = (sx + u[..., 0]) / dx
    jy = (sy + u[..., 1]) / dy
    return torch.stack([jx, jy], dim=-1)


# Static per-bounce dimension layout of the path tracer: the camera
# consumes dims [0, 4); bounce b consumes DIMS_PER_BOUNCE dims from
# BOUNCE_DIM_BASE + b * DIMS_PER_BOUNCE.
BOUNCE_DIM_BASE = 4
DIMS_PER_BOUNCE = 8
DIM_LIGHT_SELECT = 0
DIM_LIGHT_U = 1       # 2 dims
DIM_SCATTER_U = 3     # 2 dims, reserved
DIM_BSDF_U = 5        # 2 dims
DIM_RR = 7


class WaveSampler:
    """Per-wave sample-stream facade.

    kind "strata": stratified film dims + independent uniforms;
    kind "sobol": XOR-scrambled Sobol across all dimensions
    (sampling/sobol.py; sobol_table [spp, D] u32 from
    build_sobol_table);
    kind "uniform": independent uniforms everywhere."""

    def __init__(self, base_key, pixel_id, sample_id, kind="strata",
                 sobol_table=None, sample_dx=4, sample_dy=4):
        if kind not in ("strata", "sobol", "uniform"):
            raise ValueError(f"unknown sampler kind {kind!r}")
        if kind == "sobol" and sobol_table is None:
            raise ValueError("the sobol sampler needs a sobol_table")
        self.kind = kind
        self.base_key = base_key
        self.pixel_id = pixel_id
        self.sample_id = sample_id
        self.keys = ray_keys(base_key, pixel_id, sample_id)
        self.sobol_table = None
        if kind == "sobol":
            from arendur_tpu_torch.sampling import sobol
            self.sobol_table = sobol.sobol_tensor(sobol_table,
                                                  self.keys.device)
        self.dx = sample_dx
        self.dy = sample_dy

    def u1(self, dim):
        if self.kind == "sobol":
            from arendur_tpu_torch.sampling import sobol
            return sobol.sobol_from_keys(self.sobol_table, self.keys, dim)
        return uniform_1d(self.keys, dim)

    def u2(self, dim):
        if self.kind == "sobol":
            from arendur_tpu_torch.sampling import sobol
            return sobol.sobol_2d_from_keys(self.sobol_table, self.keys, dim)
        return uniform_2d(self.keys, dim)

    def film_jitter(self):
        if self.kind in ("sobol", "uniform"):
            return self.u2(0)
        return stratified_film_sample(
            self.keys, self.sample_id, self.dx, self.dy, dim=0)
