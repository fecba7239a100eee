"""The pass-through rule of the bounce-shade backward kernel K4 on the
CPU: a lane whose emission gate is off and whose output cotangent is
zero outside L (and finite on L) needs no body, because its VJP is the
pass-through (ct_L in dx's L columns, zero elsewhere, no table
cotangent).  The rule is kernels/cbounce_ad.cuh needs_body; its plain
twin is render/cbounce.py bwd_needs_body.

On every bounce of one plain-path train step (Cornell, 2,048 lanes,
depth 8; the inputs and cotangents recorded by
render/fuzz.py train_step_bounces), autograd over the plain body
(cbody_vjp_reference, itself held against jax.vjp in
tests/test_torch_grad.py) equals the pass-through exactly on the lanes
the rule lets through, and the rule lets some through on every bounce
after the first.  Each clause of the rule is checked on fuzz lanes.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from arendur_tpu_torch import scene as sc
from arendur_tpu_torch.io import scenedesc
from arendur_tpu_torch.render import cbounce as cb
from arendur_tpu_torch.render import fuzz
from arendur_tpu_torch.render import integrator as integ

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CB = os.path.join(REPO, "examples/cornellbox/cb.json")
RES, SPP, DEPTH = (32, 16), 4, 8   # one wave of 2,048 lanes


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


def test_every_bounce_is_captured(step):
    _, _, bounces = step
    assert len(bounces) == DEPTH
    for r in bounces:
        assert r["ct"].shape == (cb.OUT_COLS, r["xt"].shape[1])
        assert torch.isfinite(r["ct"]).all()


@pytest.mark.parametrize("bounce", range(DEPTH))
def test_pass_through_is_the_plain_vjp(step, bounce):
    ds, config, bounces = step
    r = bounces[bounce]
    xt, ct = r["xt"], r["ct"]
    tabs = (r["ltab"], r["mtab"], r["stab"])
    args = (ds.static, config.min_depth, config.rr_threshold)
    skip = ~cb.bwd_needs_body(xt, ct, r["stab"])
    if bounce >= 1:
        assert skip.any()
    dx = cb.cbody_vjp_reference(xt, *tabs, ct, *args)[0]
    assert torch.equal(dx[:, skip], cb.bwd_pass_through(ct)[:, skip])
    # the lanes let through add nothing to the table cotangents
    only = cb.cbody_vjp_reference(xt, *tabs, torch.where(skip, ct, 0.0),
                                  *args)
    for g in only[1:]:
        assert torch.equal(g, torch.zeros_like(g))


def test_each_clause_of_the_rule():
    """On fuzz lanes with a cotangent on L only: a lane needs the body
    exactly where its emission gate is on; a nonzero cotangent outside
    L, or a non-finite one on L, makes every lane need it.  A light id
    of -0.5 truncates to 0, a light."""
    ds = sc.DeviceScene.build(fuzz.all_branches_scene(sc.SceneBuilder()),
                              "cpu")
    tabs = (ds.ltab, ds.mtab, ds.stab)
    n = 512
    x = torch.tensor(fuzz.fuzz_bounce_inputs(
        *(t.numpy() for t in tabs), seed=11, n=n).T.copy())
    x[cb.C_TROW + 25, :8] = -0.5
    x[[cb.C_ALIVE, cb.C_HIT], :8] = 1.0
    x[cb.C_IS_SPH, :8] = 0.0
    rng = np.random.default_rng(12)
    ct = torch.zeros(cb.OUT_COLS, n)
    ct[cb.OUT_L:cb.OUT_L + 3] = torch.tensor(
        rng.normal(size=(3, n)).astype(np.float32))
    need = cb.bwd_needs_body(x, ct, ds.stab)
    le = cb.CRow(ds.stab, x[cb.C_S_IDX].to(torch.int32)).col_abs(21)
    light = torch.where(x[cb.C_IS_SPH] > 0.5, le,
                        x[cb.C_TROW + 25]).to(torch.int32)
    gate = (x[cb.C_ALIVE] > 0.5) & (x[cb.C_HIT] > 0.5) & (light >= 0)
    assert torch.equal(need, gate)
    assert need[:8].all() and 0 < int(need.sum()) < n
    # where the gate is off, the body adds nothing to L
    out = cb.cbody_reference(x, *tabs, ds.static, 4, 0.05)
    assert torch.equal(out[cb.OUT_L:cb.OUT_L + 3, ~gate],
                       x[cb.C_L:cb.C_L + 3, ~gate])
    for j, v in ((0, 1e-30), (24, -1.0), (27, float("nan")),
                 (cb.OUT_L + 1, float("inf")), (cb.OUT_L, float("nan"))):
        c = ct.clone()
        c[j] = v
        assert cb.bwd_needs_body(x, c, ds.stab).all(), (j, v)
    # columns 28..31 are constant outputs: their cotangent is ignored
    c = ct.clone()
    c[28:] = 1.0
    assert torch.equal(cb.bwd_needs_body(x, c, ds.stab), gate)
    # and where the rule lets a lane through, the plain VJP agrees
    skip = ~need
    dx = cb.cbody_vjp_reference(x, *tabs, ct, ds.static, 4, 0.05)[0]
    assert torch.equal(dx[:, skip], cb.bwd_pass_through(ct)[:, skip])
