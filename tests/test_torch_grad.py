"""The backward of the bounce shade and the gradient path of the port,
on the CPU, against the JAX package.

* cbody_vjp_reference (the plain version of the backward kernel K4)
  against jax.vjp of arendur_tpu.render.cbounce.xla_reference, run
  eagerly (a jitted VJP of the body takes minutes to compile on the
  CPU), on fuzz input over the Cornell tables and over a table set that
  reaches every light and material branch: the full input cotangent and
  the three table cotangents.  The JAX body's backward is NaN on part of
  these entries: every family of BSDF runs on every lane, and the ones
  a lane does not use divide by the zero parameters of another slot,
  so their zero cotangent meets an infinite partial.  The port gives
  those evaluations finite stand-in parameters (render/cmath.py
  _family_params), so its cotangents are finite everywhere; the gates
  hold on the entries where JAX's are finite.
* a central finite difference of the kd gradient of a render loss at
  depth 3 without Russian roulette;
* no gradient reaches the hit distance or p_local from the ray;
* the torch material table and the film splat carry gradient.

The train step against the JAX one: tests/test_torch_train.py.  The CUDA
kernel K4 against cbody_vjp_reference: tests/test_torch_gpu.py.
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
from arendur_tpu_torch import materials as tmats
from arendur_tpu_torch import scene as tsc
from arendur_tpu_torch.filming import film as tflm
from arendur_tpu_torch.io import scenedesc as tsd
from arendur_tpu_torch.parallel import mesh as tmesh
from arendur_tpu_torch.render import cbounce as tcb
from arendur_tpu_torch.render import fuzz
from arendur_tpu_torch.render import integrator as tint
from arendur_tpu_torch.sampling import sampler as tsmp

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CB = os.path.join(REPO, "examples/cornellbox/cb.json")
N = 2048
MIN_DEPTH, RR = 4, 0.05
# input cotangent: share of the entries (where JAX's is finite) within
# rtol / atol; lanes at sampling thresholds split, as in the forward
ELEM_GATE = 0.999
RTOL, ATOL = 1e-3, 1e-5
TAB_GATE = 1e-3     # ||d - d_jax|| / ||d_jax|| of a table cotangent
# input columns the body reads only as flags or indices (t, hit,
# is_sphere, s_idx, the two ids of the triangle row, specular,
# sel_prev, nee_prev, alive, lidx, the six sample numbers, bounce)
ZERO_COLS = (6, 7, 8, 9, 37, 38, 45, 46, 48, 49, 50,
             52, 53, 54, 55, 56, 57)
FD_RTOL, FD_ATOL = 0.08, 1e-5   # the JAX package's own FD gate


def _tables(jscene):
    pk, cidx, present = jsc.light_pack(jscene)
    phimax = np.asarray(jscene.spheres.phimax)
    lt = np.asarray(jscene.lights.ltype)
    prim = np.clip(np.asarray(jscene.lights.prim), 0, len(phimax) - 1)
    static = tsc.ShadeStatic(
        presence=jm.slot_presence(jscene.materials),
        dist_sets=jm.dist_presence(jscene.materials),
        lcidx=tuple(sorted(cidx.items())), lpresent=tuple(present),
        emi_cols=tuple(cidx["emission"]),
        full_phi=bool((phimax[prim[lt == jsc.L_AREA_SPHERE]]
                       >= 2.0 * np.pi - 1e-5).all()))
    tabs = (np.asarray(pk), np.asarray(jm.param_table(jscene.materials)),
            np.asarray(jsph.shade_table(jscene.spheres)))
    return tabs, static


@pytest.fixture(scope="module")
def vjps():
    """Per table set: (JAX cotangents, port cotangents, ltype column)."""
    js, *_ = jsd.parse_scene(CB)
    out = {}
    for name, scene in (("cornell", js),
                        ("all-branches",
                         fuzz.all_branches_scene(jsc.SceneBuilder()))):
        tabs, st = _tables(scene)
        x = fuzz.fuzz_bounce_inputs(*tabs, seed=0, n=N).T.copy()
        ct = np.random.default_rng(1).normal(
            size=(tcb.OUT_COLS, N)).astype(np.float32)
        args = (st.presence, st.dist_sets, st.lcidx, st.lpresent,
                st.emi_cols, MIN_DEPTH, RR, st.full_phi)
        _, vjp = jax.vjp(
            lambda x_, l_, m_, s_: jcb.xla_reference(x_, l_, m_, s_, *args),
            *(jnp.asarray(a) for a in (x,) + tabs))
        ref = [np.asarray(r) for r in vjp(jnp.asarray(ct))]
        got = [g.numpy() for g in tcb.cbody_vjp_reference(
            *(torch.tensor(a) for a in (x,) + tabs + (ct,)), st,
            MIN_DEPTH, RR)]
        out[name] = (ref, got, dict(st.lcidx)["ltype"][0])
    return out


@pytest.mark.parametrize("name", ["cornell", "all-branches"])
def test_vjp_input_cotangent_matches_jax(vjps, name):
    ref, got, _ = vjps[name]
    dx, dr = got[0], ref[0]
    assert dx.shape == (tcb.IN_COLS, N)
    assert np.isfinite(dx).all()
    fin = np.isfinite(dr)
    close = np.isclose(dx, dr, rtol=RTOL, atol=ATOL)
    assert close[fin].mean() >= ELEM_GATE, (
        close[fin].mean(), [(j, int((~close[j] & fin[j]).sum()))
                            for j in range(tcb.IN_COLS)])
    # the columns read only as flags and indices get zero, as jax.vjp
    # gives them
    assert (dx[list(ZERO_COLS)] == 0.0).all()
    zero_ref = dr[list(ZERO_COLS)]
    assert (zero_ref[np.isfinite(zero_ref)] == 0.0).all()
    # and the rest is reached: beta, L, wb_prev and the geometry
    for j in (0, 3, 10, 13, 39, 42, 47):
        assert np.abs(dx[j]).max() > 0.0, j


@pytest.mark.parametrize("name", ["cornell", "all-branches"])
@pytest.mark.parametrize("which", [1, 2, 3])   # dltab, dmtab, dstab
def test_vjp_table_cotangents_match_jax(vjps, name, which):
    ref, got, ltype_col = vjps[name]
    d, dr = got[which], ref[which]
    assert d.shape == dr.shape and np.isfinite(d).all()
    fin = np.isfinite(dr)
    assert fin.any()
    rel = np.linalg.norm((d - dr)[fin]) / max(np.linalg.norm(dr[fin]),
                                              1e-30)
    assert rel <= TAB_GATE, rel
    # type and id columns get zero
    zero = {1: d[:, ltype_col], 2: np.concatenate([d[:, :1], d[:, 11:]], 1),
            3: d[:, 20:]}[which]
    assert (zero == 0.0).all()


def _cornell(res, spp, depth, **changes):
    scene, camera, film, config, _ = tsd.parse_scene(
        CB, spp_override=spp, resolution_override=res)
    config = dataclasses.replace(config, max_depth=depth, **changes)
    return tsc.DeviceScene.build(scene, "cpu"), camera, film, config


def _render_mean(ds, camera, film, config, kd):
    """Mean pixel of one full wave's film, with the material kd given."""
    w, h = film.resolution
    ray_idx = torch.arange(w * h * config.spp)
    pid, sid = ray_idx // config.spp, ray_idx % config.spp
    pxy = torch.stack([(pid % w).float(), (pid // w).float()], -1)
    ds2 = dataclasses.replace(
        ds, mtab=tmats.param_table_t(ds.materials, "cpu", kd=kd))
    pfilm, L = tint.trace_wave(ds2, camera, config, pxy, pid, sid,
                               tsmp.make_base_key(config.seed))
    state = tflm.film_splat(film, tflm.film_init(film, "cpu"), pfilm, L)
    return tflm.film_finalize(state, film).mean()


def test_kd_gradient_matches_finite_difference():
    """The twin of tests/test_grad.py:75-101: Cornell 16x16, 4 spp,
    depth 3, no Russian roulette, so the estimator is a smooth function
    of kd along fixed paths."""
    ds, camera, film, config = _cornell((16, 16), 4, 3, rr_threshold=0.0)
    kd0 = torch.tensor(ds.materials.kd)
    kd = kd0.clone().requires_grad_(True)
    g, = torch.autograd.grad(_render_mean(ds, camera, film, config, kd),
                             [kd])
    assert torch.isfinite(g).all() and g.abs().max() > 0.0
    eps = 5e-3
    with torch.no_grad():
        for p in torch.argsort(g.abs().flatten())[-3:].tolist():
            step = torch.zeros_like(kd0)
            step.view(-1)[p] = eps
            lp = _render_mean(ds, camera, film, config, kd0 + step)
            lm = _render_mean(ds, camera, film, config, kd0 - step)
            fd = (lp - lm).item() / (2 * eps)
            np.testing.assert_allclose(g.reshape(-1)[p].item(), fd,
                                       rtol=FD_RTOL, atol=FD_ATOL)


def test_scene_queries_are_detached():
    ds, *_ = _cornell((8, 8), 1, 1)
    rng = np.random.default_rng(0)
    o = torch.tensor(rng.uniform([-1.9, -1.4, 2.1], [1.9, 2.4, 5.9],
                                 (256, 3)), dtype=torch.float32,
                     requires_grad=True)
    d = torch.nn.functional.normalize(
        torch.tensor(rng.normal(size=(256, 3)), dtype=torch.float32), dim=-1)
    d.requires_grad_(True)
    raw = tint.intersect_raw(ds, o, d)
    assert not raw["t"].requires_grad
    assert not raw["p_local"].requires_grad
    hit, _ = tint.intersect_light(ds, o, d)
    assert not hit.requires_grad
    tmax = torch.full((256,), 3.0, requires_grad=True)
    assert not tint.occluded(ds, o, d, tmax).requires_grad


def test_param_table_t_and_splat_carry_gradient():
    ds, camera, film, config = _cornell((8, 6), 2, 1)
    m = ds.materials
    kd = torch.tensor(m.kd, requires_grad=True)
    rough = torch.tensor(m.roughness, requires_grad=True)
    tab = tmats.param_table_t(m, "cpu", kd=kd, roughness=rough)
    np.testing.assert_array_equal(tab.detach().numpy(),
                                  tmats.param_table(m))
    gk, gr = torch.autograd.grad((tab[:, 1:4].sum() + 2 * tab[:, 8].sum()),
                                 [kd, rough])
    assert (gk == 1.0).all() and (gr == 2.0).all()
    L = torch.ones(10, 3, requires_grad=True)
    pfilm = torch.tensor(np.random.default_rng(0).uniform(
        0, 6, (10, 2)), dtype=torch.float32)
    state = tflm.film_splat(film, tflm.film_init(film, "cpu"), pfilm, L)
    loss = tmesh.film_mse(film, state, torch.zeros(8 * 6, 3))
    g, = torch.autograd.grad(loss, [L])
    assert torch.isfinite(g).all() and g.abs().sum() > 0.0
