"""The dead-lane contract of the bounce shades (kernels K3 and K6) on the
CPU.  The wave is compacted alive first, and the shades take its live
count n_alive: lanes below it are shaded as the JAX body shades them;
a lane at or past it (not alive) skips the body, passes L, beta,
specular, sel_prev and wb_prev through and takes the contract's
constants elsewhere (render/cbounce.py dead_lane_out; the kernels'
twin is kernels/cbounce.cuh dead_lane).

The plain versions with n_alive (cbody_reference, cbody_shade_reference)
against cbounce.xla_reference / xla_reference_shade of the JAX package
on fuzz lanes over the Cornell tables: the live lanes under
tests/test_torch_cbounce.py's tolerances, the dead lanes the contract
exactly and L equal to JAX's.  The VJP of the contract on dead lanes
against bwd_pass_through (K4's identity VJP there), in autograd and in
K4's host build; and a CPU wave that hands each bounce its live count
renders the same L, and a train step takes the same step, as one whose
shade runs the body on every lane.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from arendur_tpu import materials as jm
from arendur_tpu import scene as jsc
from arendur_tpu.io import scenedesc as jsd
from arendur_tpu.render import cbounce as jcb
from arendur_tpu.shapes import sphere as jsph
from arendur_tpu_torch import scene as tsc
from arendur_tpu_torch.io import scenedesc
from arendur_tpu_torch.kernels import host_bwd
from arendur_tpu_torch.parallel import mesh
from arendur_tpu_torch.render import cbounce as tcb
from arendur_tpu_torch.render import fuzz
from arendur_tpu_torch.render import integrator as integ
from arendur_tpu_torch.sampling import sampler as smp

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CB = os.path.join(REPO, "examples/cornellbox/cb.json")
N = 1024
MIN_DEPTH, RR = 4, 0.05
# the live lanes: tests/test_torch_cbounce.py's gate
ELEM_GATE = 0.999
RTOL, ATOL = 1e-4, 1e-5
FLAG_COLS = (12, 13, 16, 24)   # alive, specular, nee_prev, need_shadow
LIVE_COUNTS = (0, 700, N)


@pytest.fixture(scope="module")
def case():
    """The Cornell tables (numpy, and as a port DeviceScene) and the JAX
    bodies over them, jitted."""
    js, *_ = jsd.parse_scene(CB)
    pk, cidx, present = jsc.light_pack(js)
    tabs = (np.asarray(pk), np.asarray(jm.param_table(js.materials)),
            np.asarray(jsph.shade_table(js.spheres)))
    ds = tsc.DeviceScene.build(scenedesc.parse_scene(CB)[0], "cpu")
    for t, u in zip(tabs, (ds.ltab, ds.mtab, ds.stab)):
        np.testing.assert_array_equal(t, u.numpy())
    st = ds.static
    args = (st.presence, st.dist_sets, st.lcidx, st.lpresent, st.emi_cols,
            MIN_DEPTH, RR, st.full_phi)
    jl, jmt, js_ = (jnp.asarray(t) for t in tabs)
    return dict(
        ds=ds, tabs=tuple(torch.tensor(t) for t in tabs),
        fused=jax.jit(lambda x: jcb.xla_reference(x, jl, jmt, js_, *args)),
        shade=jax.jit(lambda x: jcb.xla_reference_shade(x, jl, *args)))


def _compacted(x, n_alive, c_alive):
    """x [C, N] with the lanes past n_alive not alive, as compaction
    leaves them."""
    x = x.clone()
    x[c_alive, n_alive:] = 0.0
    return x


def _check(out, ref, xt, n_alive, carried):
    live, dead = slice(0, n_alive), slice(n_alive, None)
    both_nan = np.isnan(out[:, live]) & np.isnan(ref[:, live])
    close = np.isclose(out[:, live], ref[:, live], rtol=RTOL,
                       atol=ATOL) | both_nan
    if n_alive:
        assert close.mean() >= ELEM_GATE, close.mean()
        for j in FLAG_COLS:
            assert (out[j, live] == ref[j, live]).mean() >= ELEM_GATE, j
    want = tcb.dead_lane_out(xt, carried).numpy()
    np.testing.assert_array_equal(out[:, dead], want[:, dead])
    # L on every dead lane: the body's, to the bit
    np.testing.assert_array_equal(out[tcb.OUT_L:tcb.OUT_L + 3, dead],
                                  ref[tcb.OUT_L:tcb.OUT_L + 3, dead])


@pytest.mark.parametrize("n_alive", LIVE_COUNTS)
def test_fused_shade_contract(case, n_alive):
    ltab, mtab, stab = case["tabs"]
    x = _compacted(torch.tensor(fuzz.fuzz_bounce_inputs(
        ltab.numpy(), mtab.numpy(), stab.numpy(), seed=3, n=N).T.copy()),
        n_alive, tcb.C_ALIVE)
    ref = np.asarray(case["fused"](jnp.asarray(x.numpy())))
    out = tcb.bounce_shade_t(x, ltab, mtab, stab, case["ds"].static,
                             MIN_DEPTH, RR, torch.tensor(n_alive)).numpy()
    _check(out, ref, x, n_alive, tcb.CARRIED)
    if n_alive == N:   # every lane live: the body on every lane
        np.testing.assert_array_equal(out, tcb.cbody_reference(
            x, ltab, mtab, stab, case["ds"].static, MIN_DEPTH, RR).numpy())


@pytest.mark.parametrize("n_alive", LIVE_COUNTS)
def test_split_shade_contract(case, n_alive):
    ltab, mtab, stab = case["tabs"]
    _, xs, _ = fuzz.fuzz_split_inputs(ltab, mtab, stab, seed=4, n=N)
    xs = _compacted(xs, n_alive, tcb.S_ALIVE)
    ref = np.asarray(case["shade"](jnp.asarray(xs.numpy())))
    out = tcb.shade_split_t(xs, ltab, case["ds"].static, MIN_DEPTH, RR,
                            torch.tensor(n_alive)).numpy()
    _check(out, ref, xs, n_alive, tcb.S_CARRIED)


@pytest.fixture(scope="module")
def host_k4(tmp_path_factory):
    fn = host_bwd.build(str(tmp_path_factory.mktemp("k4_alive")))
    if fn is None:
        pytest.skip("no host C++ compiler (g++) to build K4's lane code")
    return fn


def test_dead_lane_vjp_is_the_pass_through(case, host_k4):
    """Autograd over the contract on the lanes past n_alive: dx is the
    pass-through of L, beta and wb_prev, and they add nothing to the
    table cotangents; the classifier (plain twin and K4's host build)
    lists none of them, and the host build's dx is the pass-through."""
    ltab, mtab, stab = case["tabs"]
    n, n_alive = 256, 100
    x = _compacted(torch.tensor(fuzz.fuzz_bounce_inputs(
        ltab.numpy(), mtab.numpy(), stab.numpy(), seed=5, n=n).T.copy()),
        n_alive, tcb.C_ALIVE)
    ct = torch.tensor(np.random.default_rng(6).normal(
        size=(tcb.OUT_COLS, n)).astype(np.float32))
    na = torch.tensor(n_alive)
    dead = tcb.dead_lanes(na, n, "cpu")
    args = (case["ds"].static, MIN_DEPTH, RR)
    dx = tcb.cbody_vjp_reference(x, ltab, mtab, stab, ct, *args, na)[0]
    through = tcb.bwd_pass_through(ct)
    assert torch.equal(dx[:, dead], through[:, dead])
    only = tcb.cbody_vjp_reference(x, ltab, mtab, stab,
                                   torch.where(dead, ct, 0.0), *args, na)
    for g in only[1:]:
        assert torch.equal(g, torch.zeros_like(g))
    need = tcb.bwd_needs_body(x, ct, stab, na)
    assert not need[dead].any() and need[~dead].all()
    hdx, *_, hneed, nodes, failed = host_bwd.run(
        host_k4, x, ct, ltab, mtab, stab, *args, n_alive)
    assert failed == 0
    np.testing.assert_array_equal(hneed, need.numpy())
    np.testing.assert_array_equal(hdx[:, n_alive:], through[:, dead].numpy())
    assert (nodes[n_alive:] == 0).all()


def test_wave_with_live_counts_renders_the_body_L():
    """A depth-8 CPU wave whose shades take each bounce's live count
    (the plain path) gives the L of one whose shade runs the body on
    every lane, to the bit; each bounce's count is its alive lanes, and
    they come first."""
    scene, camera, film, config, _ = scenedesc.parse_scene(
        CB, spp_override=4, resolution_override=(16, 8))
    n = 16 * 8 * 4
    config = dataclasses.replace(config, max_depth=8, wave_size=n)
    ds = tsc.DeviceScene.build(scene, "cpu")
    shades = fuzz.wave_shades(ds, camera, film, config, integ.PLAIN_OPS)
    for r in shades:
        alive = r["xt"][tcb.C_ALIVE] > 0.5
        na = int(r["n_alive"])
        assert alive[:na].all() and not alive[na:].any()
    assert int(shades[-1]["n_alive"]) < n
    whole = dataclasses.replace(
        integ.PLAIN_OPS,
        bounce_shade=lambda *a, n_alive=None: tcb.cbody_reference(*a))
    ray = torch.arange(n)
    pid = ray // config.spp
    pxy = torch.stack([(pid % 16).float(), (pid // 16).float()], -1)
    wave = (ds, camera, config, pxy, pid, ray % config.spp,
            smp.make_base_key(config.seed))
    with torch.no_grad():
        _, l_alive = integ.trace_wave(*wave, ops=integ.PLAIN_OPS)
        _, l_whole = integ.trace_wave(*wave, ops=whole)
    assert torch.equal(l_alive, l_whole)
    assert l_alive.sum() > 0


def test_train_step_takes_the_body_step():
    """A CPU train step (kd and roughness, depth 8) whose shades take the
    live counts takes the step of one whose shade runs the body on every
    lane, to the bit: the lanes past the live count carry no cotangent
    outside L."""
    scene, camera, film, config, _ = scenedesc.parse_scene(
        CB, spp_override=4, resolution_override=(16, 8))
    n = 16 * 8 * 4
    config = dataclasses.replace(config, max_depth=8, wave_size=n)
    ds = tsc.DeviceScene.build(scene, "cpu")
    target = torch.tensor(np.random.default_rng(0).uniform(
        0.0, 0.5, (16 * 8, 3)).astype(np.float32))
    whole = dataclasses.replace(
        integ.PLAIN_OPS,
        bounce_shade=lambda *a, n_alive=None: tcb.cbody_reference(*a))
    params = {"kd": torch.tensor(ds.materials.kd) * 1.25,
              "roughness": torch.tensor(ds.materials.roughness)}
    steps = [mesh.train_step_fn(ds, camera, film, config, lr=1e3, ops=ops)(
        dict(params), target, torch.arange(n))
        for ops in (integ.PLAIN_OPS, whole)]
    (new_a, loss_a), (new_b, loss_b) = steps
    assert torch.equal(loss_a, loss_b)
    for k in params:
        assert torch.equal(new_a[k], new_b[k]), k
    assert not torch.equal(new_a["kd"], params["kd"])
