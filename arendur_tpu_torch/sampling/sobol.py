"""XOR-scrambled Sobol sampling (port of arendur_tpu/sampling/sobol.py).

Host side: scipy generates the base Sobol points for (spp, ndims) as
u32 fixed-point.  Device side: each (pixel, dim) gets a
Cranley-Patterson XOR scramble word from the pcg4d hash the stratified
sampler uses (sampler._pcg4d).  The sequence is a pure function of
(seed, pixel, sample, dim), the stateless contract of the other
samplers, so lanes may be reordered freely.

Words are int64 tensors holding values in [0, 2^32), as in
sampling/sampler.py (PyTorch cannot shift uint32 tensors on every
device).  A scrambled word becomes a float32 by one round to nearest
(the JAX package's uint32 -> float32 cast), so a word within 128 of
2^32 gives exactly 1.0 there and here.
"""

from __future__ import annotations

import numpy as np
import torch

from arendur_tpu_torch.sampling.sampler import _M32, _pcg4d, ray_keys

_INV32 = 2.0 ** -32


def build_sobol_table(spp: int, ndims: int) -> np.ndarray:
    """[spp, ndims] uint32 base Sobol points (host, scipy)."""
    from scipy.stats import qmc
    m = int(np.ceil(np.log2(max(spp, 2))))
    eng = qmc.Sobol(d=ndims, scramble=False)
    pts = eng.random_base2(m)[:spp]
    return (pts * (2.0 ** 32)).astype(np.uint64).astype(np.uint32)


def sobol_tensor(table, device) -> torch.Tensor:
    """The host table as an int64 tensor on `device` (a tensor already
    there is returned as it is)."""
    if isinstance(table, torch.Tensor):
        return table.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(table, np.int64), device=device)


def _scramble_words(k0, d):
    """Two per-(pixel, dim) scramble words (for dims d and d + 1); k0 is
    the ray key's seed-mixed pixel word (the JAX package's pixel_id ^
    _seed_word)."""
    full = lambda v: torch.full_like(k0, v)  # noqa: E731
    a, b, _, _ = _pcg4d(k0, d, full(0x6A09E667), full(0xBB67AE85))
    return a, b


def _to_unit(w):
    return w.to(torch.float32) * _INV32


def _dims(keys, dim):
    return torch.as_tensor(dim, dtype=torch.int64,
                           device=keys.device).expand(keys.shape[:-1]) & _M32


def sobol_from_keys(table, keys, dim):
    """u in [0, 1) per lane from the lane's ray key (sampler.ray_keys:
    the seed-mixed pixel word and the sample id); table [spp, D] int64
    tensor; dim a scalar or [N]."""
    spp, ndims = table.shape
    d = _dims(keys, dim)
    base = table[keys[..., 1] % spp, torch.clamp(d, max=ndims - 1)]
    bits, _ = _scramble_words(keys[..., 0], d)
    return _to_unit(base ^ bits)


def sobol_2d_from_keys(table, keys, dim):
    """[N, 2] uniforms for dims (dim, dim + 1) with one hash call and
    one table row gather."""
    spp, ndims = table.shape
    d = _dims(keys, dim)
    row = table[keys[..., 1] % spp]
    d0 = torch.clamp(d, max=ndims - 1)
    d1 = torch.clamp(d + 1, max=ndims - 1)
    base0 = row.gather(1, d0[:, None])[:, 0]
    base1 = row.gather(1, d1[:, None])[:, 0]
    b0, b1 = _scramble_words(keys[..., 0], d)
    return torch.stack([_to_unit(base0 ^ b0), _to_unit(base1 ^ b1)], -1)


def sobol_uniform(table, base_key, pixel_id, sample_id, dim):
    """u in [0, 1) for lanes: table [spp, D] u32 (NumPy or an int64
    tensor); pixel_id / sample_id [N]; dim a scalar or [N].
    XOR-scrambled per (pixel, dim)."""
    keys = ray_keys(base_key, pixel_id, sample_id)
    return sobol_from_keys(sobol_tensor(table, keys.device), keys, dim)


def sobol_uniform_2d(table, base_key, pixel_id, sample_id, dim):
    """[N, 2] uniforms for dims (dim, dim + 1)."""
    keys = ray_keys(base_key, pixel_id, sample_id)
    return sobol_2d_from_keys(sobol_tensor(table, keys.device), keys, dim)
