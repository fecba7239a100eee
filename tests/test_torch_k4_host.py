"""The per-lane code of the bounce-shade backward kernel K4 on the CPU:
kernels/cbounce_bwd_host.cpp builds the classifier, the pass-through
and cbody_lane_bwd on the 16-byte tape records (kernels/cbounce_ad.cuh,
kernels/ad.cuh) with a host C++ compiler, no nvcc, and walks the lanes
in order (kernels/host_bwd.py).  It is held against autograd over the
plain body (render/cbounce.py cbody_vjp_reference) with chip_smoke.py
phase 7's gates (the dx share on the lanes it tapes, dx equal to the
pass-through on the others), on fuzz lanes with a random cotangent in
every column (every lane taped) and on every bounce of one plain-path
train step (Cornell, 2,048 lanes, depth 8); its flags equal the plain
twin's (bwd_needs_body), and a lane that needs no body records no node.
Skips where no host compiler is found.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from arendur_tpu_torch import scene as sc
from arendur_tpu_torch.io import scenedesc
from arendur_tpu_torch.kernels import host_bwd, ops
from arendur_tpu_torch.render import cbounce as cb
from arendur_tpu_torch.render import fuzz
from arendur_tpu_torch.render import integrator as integ

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CB = os.path.join(REPO, "examples/cornellbox/cb.json")
RES, SPP, DEPTH = (32, 16), 4, 8   # one wave of 2,048 lanes
K4_GATE = 0.999                 # share of dx entries within rtol / atol
K4_RTOL, K4_ATOL = 1e-3, 1e-5   # summation order differs from autograd's
TAB_GATE = 1e-3                 # ||d - d_plain|| / ||d_plain||, tables


@pytest.fixture(scope="module")
def host_k4(tmp_path_factory):
    fn = host_bwd.build(str(tmp_path_factory.mktemp("k4")))
    if fn is None:
        pytest.skip("no host C++ compiler (g++) to build K4's lane code")
    return fn


def check(fn, xt, ct, tabs, static, min_depth, rr):
    """The host build against the plain VJP: the gates, its flags
    against bwd_needs_body's, no node on lanes that need no body.
    Returns the flags."""
    dx, dlt, dmt, dst, need, nodes, failed = host_bwd.run(
        fn, xt, ct, *tabs, static, min_depth, rr)
    ref = [g.numpy() for g in cb.cbody_vjp_reference(
        xt, *tabs, ct, static, min_depth, rr)]
    assert failed == 0 and nodes.max() <= ops.TAPE_CAP
    np.testing.assert_array_equal(need, cb.bwd_needs_body(
        xt, ct, tabs[2]).numpy())
    assert (nodes[~need] == 0).all() and (nodes[need] > 0).all()
    # the lanes let through: dx exactly the pass-through; the share gate
    # on the entries of the lanes taped alone
    np.testing.assert_array_equal(
        dx[:, ~need], cb.bwd_pass_through(ct[:, torch.tensor(~need)]).numpy())
    close = np.isclose(dx[:, need], ref[0][:, need], rtol=K4_RTOL,
                       atol=K4_ATOL) \
        | (np.isnan(dx[:, need]) & np.isnan(ref[0][:, need]))
    assert close.mean() >= K4_GATE
    for g, r in zip((dlt, dmt, dst), ref[1:]):
        assert np.isfinite(g).all()
        rel = np.linalg.norm(g - r) / max(np.linalg.norm(r), 1e-30)
        assert rel <= TAB_GATE
    return need


@pytest.mark.parametrize("which", ["cornell", "all-branches"])
def test_fuzz_lanes_match_plain(host_k4, which):
    if which == "cornell":
        scene, *_ = scenedesc.parse_scene(CB)
    else:
        scene = fuzz.all_branches_scene(sc.SceneBuilder())
    ds = sc.DeviceScene.build(scene, "cpu")
    tabs = (ds.ltab, ds.mtab, ds.stab)
    n = 2048
    xt = torch.tensor(fuzz.fuzz_bounce_inputs(
        *(t.numpy() for t in tabs), seed=0, n=n).T.copy())
    ct = torch.tensor(np.random.default_rng(7).normal(
        size=(cb.OUT_COLS, n)).astype(np.float32))
    need = check(host_k4, xt, ct, tabs, ds.static, 4, 0.05)
    assert need.all()   # a cotangent in every column: every lane taped


@pytest.fixture(scope="module")
def step():
    scene, camera, film, config, _ = scenedesc.parse_scene(
        CB, spp_override=SPP, resolution_override=RES)
    n = RES[0] * RES[1] * SPP
    config = dataclasses.replace(config, max_depth=DEPTH, wave_size=n)
    ds = sc.DeviceScene.build(scene, "cpu")
    target = torch.tensor(np.random.default_rng(0).uniform(
        0.0, 0.5, (RES[0] * RES[1], 3)).astype(np.float32))
    bounces = fuzz.train_step_bounces(ds, camera, film, config,
                                      integ.PLAIN_OPS, target,
                                      torch.arange(n))
    return ds, config, bounces


@pytest.mark.parametrize("bounce", range(DEPTH))
def test_train_step_bounce_matches_plain(host_k4, step, bounce):
    ds, config, bounces = step
    r = bounces[bounce]
    need = check(host_k4, r["xt"], r["ct"], (r["ltab"], r["mtab"],
                                             r["stab"]),
                 ds.static, config.min_depth, config.rr_threshold)
    assert need.any() and (bounce == 0 or not need.all())
