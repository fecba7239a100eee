"""The port's bidirectional path tracer (arendur_tpu_torch/render/bpt.py)
against the JAX package's (arendur_tpu/render/bpt.py) on the CPU: one
depth-2 wave at 8x6, 4 spp on tests/test_bpt.py's box_scene (a diffuse
floor under a triangle light), every (s, t) strategy's contribution and
MIS weight and the wave's outputs (gates and residuals:
tests/torch_bpt_common.py); the sampler dimensions BPT draws, equal to
the bit; K9's fused evaluate + pdf against the JAX package's two sweeps
on the vertex sets of a port wave on the all-branches scene (glass and
translucent vertices, render/fuzz.py); the light choice.  cb.json's
wave is tests/test_torch_bpt_cornell.py."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from arendur_tpu.render import bpt as jbpt
from arendur_tpu.sampling import distribution as jdist
from arendur_tpu.sampling import sampler as jsmp
from arendur_tpu_torch.lighting import emission as temi
from arendur_tpu_torch.render import bpt as tbpt
from arendur_tpu_torch.sampling import distribution as tdist
from arendur_tpu_torch.sampling import sampler as tsmp

import torch_bpt_common as common

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def wave():
    return common.waves("box")


@pytest.mark.parametrize("st", common.STRATEGIES,
                         ids=lambda st: f"s{st[0]}t{st[1]}")
def test_strategy_matches_jax(wave, st):
    common.check_strategy(wave, "box", st)


def test_wave_outputs_match_jax(wave):
    common.check_wave_outputs(wave)


def test_sampler_dims_match_jax():
    """Every sampler dimension a depth-8 BPT wave draws, the port's
    against JAX's, equal to the bit."""
    _, pid, sid = common.ids()
    jws = jsmp.WaveSampler(jsmp.make_base_key(3), jnp.asarray(pid),
                           jnp.asarray(sid))
    tws = tsmp.WaveSampler(tsmp.make_base_key(3), torch.tensor(pid).long(),
                           torch.tensor(sid).long())
    base, conn = tbpt._LIGHT_WALK_BASE, tbpt._CONNECT_BASE
    assert (base, conn) == (jbpt._LIGHT_WALK_BASE, jbpt._CONNECT_BASE) \
        == (1024, 4096)
    np.testing.assert_array_equal(tws.u1(base - 1).numpy(),
                                  np.asarray(jws.u1(base - 1)))
    dims = [2, base, base + 2] + [base + 8 + 4 * i for i in range(8)] \
        + [tsmp.BOUNCE_DIM_BASE + 4 * i for i in range(9)] \
        + [conn + 4 * (t * 8 + 1) for t in range(2, 11)] \
        + [conn + 4 * (8 + s) + 2 for s in range(2, 10)]
    for dim in dims:
        np.testing.assert_array_equal(tws.u2(dim).numpy(),
                                      np.asarray(jws.u2(dim)), str(dim))
    np.testing.assert_array_equal(tws.film_jitter().numpy(),
                                  np.asarray(jws.film_jitter()))


def test_k9_against_two_sweeps_all_branches():
    (js, *_), port = common.setup("all-branches")
    _, col = common.port_wave(*port)
    common.check_k9_two_sweeps(js, port[0], col, "all-branches")


def test_light_choice_matches_jax():
    """sampling/distribution.py and emission.pdf_origin against the JAX
    package's on the all-branches scene's five lights (one of each
    type)."""
    (js, *_), (ds, *_) = common.setup("all-branches")
    u = np.random.default_rng(0).uniform(size=4096).astype(np.float32)
    u[:3] = (0.0, 0.5, np.nextafter(np.float32(1.0), np.float32(0.0)))
    ji, jp = jdist.sample_discrete(js.light_distribution, jnp.asarray(u))
    ti, tp = tdist.sample_discrete(ds.light_distribution, torch.tensor(u))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert len(np.unique(ti.numpy())) == 5
    np.testing.assert_array_equal(
        tdist.discrete_pdf(ds.light_distribution, ti).numpy(),
        np.asarray(jdist.discrete_pdf(js.light_distribution, ji)))
    np.testing.assert_array_equal(temi.pdf_origin(ds, ti).numpy(),
                                  np.asarray(jbpt.emi.pdf_origin(js, ji)))
