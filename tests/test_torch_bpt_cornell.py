"""The port's bidirectional path tracer against the JAX package's on
examples/cornellbox/cb.json (two sphere lights: the light subpaths start
1e-4 off a sphere), one depth-2 wave at 8x6, 4 spp: every (s, t)
strategy's contribution and MIS weight, the wave's outputs, K9's fused
evaluate + pdf against the JAX package's two sweeps on the wave's vertex
sets, and the light walk's first closest hit on 4,096 sphere-started
rays (cb.json and the all-branches scene).  Gates and residuals:
tests/torch_bpt_common.py."""

import pytest
import torch

import torch_bpt_common as common

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def wave():
    return common.waves("cornell")


@pytest.mark.parametrize("st", common.STRATEGIES,
                         ids=lambda st: f"s{st[0]}t{st[1]}")
def test_strategy_matches_jax(wave, st):
    common.check_strategy(wave, "cornell", st)


def test_wave_outputs_match_jax(wave):
    common.check_wave_outputs(wave)


def test_k9_against_two_sweeps(wave):
    common.check_k9_two_sweeps(wave["js"], wave["ds"], wave["tcol"],
                               "cornell")


@pytest.mark.parametrize("name", ["cornell", "all-branches"])
def test_sphere_started_first_hits(name):
    common.check_sphere_started_hits(name)
