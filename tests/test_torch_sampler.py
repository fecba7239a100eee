"""The port's stateless sampler against arendur_tpu.sampling.sampler:
u32 hashes must agree bit for bit, and the uniforms built from them
exactly."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from arendur_tpu.sampling import sampler as jsmp
from arendur_tpu_torch.sampling import sampler as tsmp

torch.set_num_threads(2)

N = 4096


def _ids(seed):
    rng = np.random.default_rng(seed)
    pid = rng.integers(0, 1 << 22, N).astype(np.int32)
    sid = rng.integers(0, 1 << 10, N).astype(np.int32)
    return pid, sid


def _keys(seed, pid, sid):
    jk = jsmp.ray_keys(jsmp.make_base_key(seed), jnp.asarray(pid),
                       jnp.asarray(sid))
    tk = tsmp.ray_keys(tsmp.make_base_key(seed), torch.tensor(pid),
                       torch.tensor(sid))
    return jk, tk


def _u32(t):
    return t.numpy().astype(np.uint32)


@pytest.mark.parametrize("seed", [0, 7, 123456789])
def test_ray_keys_bitexact(seed):
    pid, sid = _ids(seed)
    jk, tk = _keys(seed, pid, sid)
    np.testing.assert_array_equal(np.asarray(jk), _u32(tk))


@pytest.mark.parametrize("dim", [0, 2, 5, 11, 63])
def test_pcg4d_uniforms_bitexact(dim):
    pid, sid = _ids(dim)
    jk, tk = _keys(3, pid, sid)
    np.testing.assert_array_equal(np.asarray(jsmp.uniform_1d(jk, dim)),
                                  tsmp.uniform_1d(tk, dim).numpy())
    np.testing.assert_array_equal(np.asarray(jsmp.uniform_2d(jk, dim)),
                                  tsmp.uniform_2d(tk, dim).numpy())
    np.testing.assert_array_equal(np.asarray(jsmp._dim_seed(jk, dim)),
                                  _u32(tsmp._dim_seed(tk, dim)))


@pytest.mark.parametrize("n", [1, 4, 16, 1024])
def test_permute_pow2_bitexact(n):
    rng = np.random.default_rng(n)
    i = rng.integers(0, 1 << 32, N, dtype=np.uint64).astype(np.uint32)
    s = rng.integers(0, 1 << 32, N, dtype=np.uint64).astype(np.uint32)
    ref = np.asarray(jsmp._permute_pow2(jnp.asarray(i), n, jnp.asarray(s)))
    out = tsmp._permute_pow2(torch.tensor(i.astype(np.int64)), n,
                             torch.tensor(s.astype(np.int64)))
    np.testing.assert_array_equal(ref, _u32(out))
    if n > 1:
        # a bijection of [0, n) for a fixed seed
        perm = tsmp._permute_pow2(torch.arange(n), n,
                                  torch.full((n,), int(s[0])))
        assert sorted(perm.tolist()) == list(range(n))


@pytest.mark.parametrize("spp,dxy", [(1, (1, 1)), (4, (2, 2)),
                                     (16, (4, 4)), (8, (4, 2))])
def test_stratified_bitexact(spp, dxy):
    dx, dy = dxy
    pid, sid = _ids(spp)
    sid = sid % spp
    jk, tk = _keys(1, pid, sid)
    for dim in (4, 9, 12):
        np.testing.assert_array_equal(
            np.asarray(jsmp.stratified_1d(jk, spp, dim)),
            tsmp.stratified_1d(tk, spp, dim).numpy())
        np.testing.assert_array_equal(
            np.asarray(jsmp.stratified_2d(jk, dx, dy, dim)),
            tsmp.stratified_2d(tk, dx, dy, dim).numpy())
    np.testing.assert_array_equal(
        np.asarray(jsmp.stratified_film_sample(jk, jnp.asarray(sid), dx,
                                               dy)),
        tsmp.stratified_film_sample(tk, torch.tensor(sid), dx, dy).numpy())


@pytest.mark.parametrize("kind", ["strata", "uniform"])
def test_wave_sampler_bitexact(kind):
    pid, sid = _ids(11)
    sid = sid % 16
    jw = jsmp.WaveSampler(jsmp.make_base_key(5), jnp.asarray(pid),
                          jnp.asarray(sid), kind=kind)
    tw = tsmp.WaveSampler(tsmp.make_base_key(5), torch.tensor(pid),
                          torch.tensor(sid), kind=kind)
    np.testing.assert_array_equal(np.asarray(jw.film_jitter()),
                                  tw.film_jitter().numpy())
    np.testing.assert_array_equal(np.asarray(jw.u1(6)), tw.u1(6).numpy())
    np.testing.assert_array_equal(np.asarray(jw.u2(2)), tw.u2(2).numpy())


def test_sobol_kind_not_ported():
    """The Sobol kind, which once refused (the name is its), equals
    sampling/sobol.py's uniforms and the JAX package's WaveSampler to
    the bit (tests/test_torch_sobol.py holds the rest)."""
    from arendur_tpu.sampling import sobol as jsob
    from arendur_tpu_torch.sampling import sobol as tsob
    table = tsob.build_sobol_table(16, 80)
    pid, sid = _ids(11)
    sid = sid % 16
    tw = tsmp.WaveSampler(tsmp.make_base_key(5), torch.tensor(pid),
                          torch.tensor(sid), kind="sobol", sobol_table=table)
    jw = jsmp.WaveSampler(jsmp.make_base_key(5), jnp.asarray(pid),
                          jnp.asarray(sid), kind="sobol", sobol_table=table)
    assert torch.equal(tw.u1(6), tsob.sobol_uniform(
        table, tsmp.make_base_key(5), torch.tensor(pid), torch.tensor(sid),
        6))
    np.testing.assert_array_equal(np.asarray(jw.film_jitter()),
                                  tw.film_jitter().numpy())
    np.testing.assert_array_equal(np.asarray(jw.u1(6)), tw.u1(6).numpy())
    np.testing.assert_array_equal(np.asarray(jw.u2(2)), tw.u2(2).numpy())
    with pytest.raises(ValueError):
        tsmp.WaveSampler(tsmp.make_base_key(0), torch.zeros(4),
                         torch.zeros(4), kind="sobol")
