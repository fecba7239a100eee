"""The port's Sobol sampler (arendur_tpu_torch/sampling/sobol.py and the
"sobol" kind of WaveSampler and of the render) against the JAX
package's (arendur_tpu/sampling/sobol.py): the host table, the
scrambled uniforms bit for bit on random ids (words within 128 of 2^32
included, which round to 1.0 in both), and tests/test_sobol.py's Sobol
render of the plane scene (tests/torch_oracles.py ``sobol_plane``).

Tolerance: the uniforms are equal to the bit; the render within
PIXEL_ATOL per pixel, the JAX package's gate between its render paths
(measured: 1.2e-7)."""

import os
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from arendur_tpu.sampling import sampler as jsmp
from arendur_tpu.sampling import sobol as jsob
from arendur_tpu_torch import convert
from arendur_tpu_torch.render import integrator as tint
from arendur_tpu_torch.sampling import sampler as tsmp
from arendur_tpu_torch.sampling import sobol as tsob

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_oracles as orc  # noqa: E402

torch.set_num_threads(2)

PIXEL_ATOL = 3e-3


@pytest.mark.parametrize("spp,dims", [(16, 80), (64, 8), (5, 3)])
def test_table_matches_jax(spp, dims):
    t = tsob.build_sobol_table(spp, dims)
    assert t.dtype == np.uint32 and t.shape == (spp, dims)
    np.testing.assert_array_equal(t, jsob.build_sobol_table(spp, dims))


def _ids(seed, n=4096, spp=16):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 1 << 22, n).astype(np.int32),
            rng.integers(0, 1 << 12, n).astype(np.int32) % spp)


def _bits(a):
    return np.asarray(a).view(np.uint32)


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("dim", [0, 7, 78, 79, 90])
def test_uniforms_bitexact(seed, dim):
    """sobol_uniform / _2d on random pixel and sample ids; dims past the
    table's last column clamp to it in both."""
    table = jsob.build_sobol_table(16, 80)
    pid, sid = _ids(seed + dim)
    jk, tk = jsmp.make_base_key(seed), tsmp.make_base_key(seed)
    for jf, tf in ((jsob.sobol_uniform, tsob.sobol_uniform),
                   (jsob.sobol_uniform_2d, tsob.sobol_uniform_2d)):
        j = jf(table, jk, jnp.asarray(pid), jnp.asarray(sid), dim)
        t = tf(table, tk, torch.tensor(pid), torch.tensor(sid), dim)
        np.testing.assert_array_equal(_bits(t.numpy()), _bits(j))


def test_words_near_two_to_32_round_like_jax():
    """A table whose words XOR each lane's scramble to the 384 words
    below 2^32 (lane i reads row i): the u32 -> f32 rounding gives 1.0
    on the same 128 lanes, all equal to the bit."""
    n = 384
    pid = np.arange(n, dtype=np.int32) * 7919
    sid = np.arange(n, dtype=np.int32)
    key = tsmp.make_base_key(3)
    k0 = tsmp.ray_keys(key, torch.tensor(pid), torch.tensor(sid))[:, 0]
    bits, _ = tsob._scramble_words(k0, torch.full_like(k0, 2))
    want = (1 << 32) - 1 - np.arange(n, dtype=np.int64)
    table = np.zeros((n, 3), np.uint32)
    table[:, 2] = (want ^ bits.numpy()).astype(np.uint32)
    t = tsob.sobol_uniform(table, key, torch.tensor(pid), torch.tensor(sid),
                           2).numpy()
    j = jsob.sobol_uniform(table, jsmp.make_base_key(3), jnp.asarray(pid),
                           jnp.asarray(sid), 2)
    np.testing.assert_array_equal(_bits(t), _bits(j))
    assert (t == 1.0).sum() == 128 and t.max() == 1.0


@pytest.mark.parametrize("dim", [0, 6])
def test_wave_sampler_sobol_equals_sobol_uniform(dim):
    table = tsob.build_sobol_table(16, 80)
    pid, sid = _ids(11)
    pid_t, sid_t = torch.tensor(pid), torch.tensor(sid)
    key = tsmp.make_base_key(2)
    ws = tsmp.WaveSampler(key, pid_t, sid_t, kind="sobol", sobol_table=table)
    assert torch.equal(ws.u1(dim),
                       tsob.sobol_uniform(table, key, pid_t, sid_t, dim))
    assert torch.equal(ws.u2(dim),
                       tsob.sobol_uniform_2d(table, key, pid_t, sid_t, dim))
    assert torch.equal(ws.film_jitter(), ws.u2(0))
    jw = jsmp.WaveSampler(jsmp.make_base_key(2), jnp.asarray(pid),
                          jnp.asarray(sid), kind="sobol", sobol_table=table)
    np.testing.assert_array_equal(_bits(ws.u2(dim).numpy()),
                                  _bits(jw.u2(dim)))


def test_sobol_render_matches_jax():
    scene, camera, film_cfg, config = orc.sobol_plane_setup()
    ref = orc.load("sobol_plane", orc.sobol_inputs())["img"]
    ds = convert.scene_from_numpy(scene, "cpu")
    cfg = tint.RenderConfig(max_depth=config.max_depth, spp=config.spp,
                            sample_dx=config.sample_dx,
                            sample_dy=config.sample_dy,
                            wave_size=config.wave_size, sampler="sobol",
                            sobol_table=config.sobol_table)
    img = tint.render(ds, convert.camera_from_numpy(camera),
                      convert.film_from_numpy(film_cfg), cfg).numpy()
    np.testing.assert_allclose(img, ref, rtol=0.0, atol=PIXEL_ATOL)
    # tests/test_sobol.py's own check: the analytic centre radiance
    np.testing.assert_allclose(img[3:5, 3:5].mean(), 0.6 / np.pi * 10.0 / 4.0,
                               rtol=0.1)
