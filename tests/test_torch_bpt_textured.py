"""The port's BPT renderer against the JAX package's on cb.json with
bench.py's checkerboard kd texture on every matte material (the vertex
BSDFs of both walks read the atlas at the vertices' uv): every (s, t)
strategy of a depth-2 wave at 8x6, 4 spp (the JAX wave runs once,
eagerly, in a module fixture) and the wave's outputs.  Gates and
residuals: tests/torch_bpt_common.py."""

import numpy as np
import pytest
import torch

import torch_bpt_common as common

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def wave():
    return common.waves("checker")


@pytest.mark.parametrize("st", common.STRATEGIES,
                         ids=lambda st: f"s{st[0]}t{st[1]}")
def test_strategy_matches_jax(wave, st):
    common.check_strategy(wave, "checker", st)


def test_wave_outputs_match_jax(wave):
    common.check_wave_outputs(wave)


def test_texture_reaches_the_vertices(wave):
    """The camera walk's first vertices on matte walls take the
    checker's kd: their BSDFs' diffuse colour varies across lanes of
    one material."""
    v = wave["tcol"]["cam_vs"][1]
    mats = v["mat_id"].numpy()
    kd = v["bsdf"].c0[:, 0].numpy()
    m = np.bincount(mats[v["valid"].numpy()]).argmax()
    lanes = v["valid"].numpy() & (mats == m)
    assert lanes.sum() > 20 and np.ptp(kd[lanes], axis=0).max() > 0.1
