"""The port's BPT and Whitted renderers against the JAX package's on the
all-branches scene of render/fuzz.py: a triangle light, a partial
sphere light, point, spot and distant lights (delta positions and
directions in the light subpaths and in the s = 1 connections),
plastic, glass and translucent materials.  Every (s, t) strategy of a
depth-2 BPT wave at 8x6, 4 spp (the JAX wave runs once, eagerly, in a
module fixture), and one Whitted wave.  Gates and residuals:
tests/torch_bpt_common.py; the textured scene is
tests/test_torch_bpt_textured.py."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from arendur_tpu.render import whitted as jwhitted
from arendur_tpu.sampling import sampler as jsmp
from arendur_tpu_torch.render import whitted as twhitted
from arendur_tpu_torch.sampling import sampler as tsmp

import torch_bpt_common as common

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def wave():
    return common.waves("all-branches")


@pytest.mark.parametrize("st", common.STRATEGIES,
                         ids=lambda st: f"s{st[0]}t{st[1]}")
def test_strategy_matches_jax(wave, st):
    common.check_strategy(wave, "all-branches", st)


def test_wave_outputs_match_jax(wave):
    common.check_wave_outputs(wave)


def test_delta_lights_reach_the_wave(wave):
    """The all-branches wave's light subpaths start on every light type,
    and its s = 1 connections to point and spot lights carry energy."""
    w = wave
    ltype = np.asarray(w["js"].lights.ltype)
    lid = w["tcol"]["light_vs"][0]["light_id"].long().numpy()
    assert set(ltype[lid].tolist()) == {0, 1, 2, 3, 4}
    c, _ = w["tcol"][(1, 2)]
    delta = np.isin(ltype[lid], (2, 3))
    assert (c.numpy()[delta].sum(-1) > 0).any()


def test_whitted_all_branches_matches_jax():
    (js, jc, _, jcfg), (ds, tc, _, tcfg) = common.setup("all-branches")
    pxy, pid, sid = common.ids()
    _, l_j = jwhitted.whitted_wave(js, jc, jcfg, jnp.asarray(pxy),
                                   jnp.asarray(pid), jnp.asarray(sid),
                                   jsmp.make_base_key(0))
    _, l_t = twhitted.whitted_wave(ds, tc, tcfg, torch.tensor(pxy),
                                   torch.tensor(pid).long(),
                                   torch.tensor(sid).long(),
                                   tsmp.make_base_key(0))
    l_j, l_t = np.asarray(l_j), l_t.numpy()
    print(f"all-branches Whitted: max |dL| {np.abs(l_t - l_j).max():.3e}, "
          f"max L {l_j.max():.3e}")
    assert l_j.max() > 0.05
    np.testing.assert_allclose(l_t, l_j, rtol=common.C_RTOL,
                               atol=common.C_ATOL)
