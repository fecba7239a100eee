"""The textured split of the bounce (kernels K5 and K6) against the JAX
package, on the CPU: the port's plain hit body against
cbounce.xla_reference_hit and its plain shade body against
cbounce.xla_reference_shade on fuzzed lanes over the Cornell tables and
a table set that reaches every light and material branch; the split
against the fused body on untextured tables; and the split shade's
backward against jax.vjp of the JAX shade body.  The CUDA kernels are
held against the plain bodies on the card in tests/test_torch_gpu.py."""

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
from arendur_tpu_torch.render import cbounce as tcb
from arendur_tpu_torch.render import fuzz

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 2048
N_VJP = 512
MIN_DEPTH, RR = 4, 0.05
# forward: share of elements within RTOL / ATOL, and of lanes whose
# flags agree (tests/test_torch_cbounce.py's gate)
ELEM_GATE = 0.999
RTOL, ATOL = 1e-4, 1e-5
FLAG_COLS = (12, 13, 16, 24)   # alive, specular, nee_prev, need_shadow
# backward: tests/test_torch_grad.py's gates, on the entries where
# JAX's cotangent is finite
VJP_RTOL, VJP_ATOL = 1e-3, 1e-5
TAB_GATE = 1e-3


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


def _split(c, seed, n, jax_hit=True):
    """fuzz_split_inputs over a case's tables as numpy (hit input, shade
    input, fused input); the shade input is packed on the JAX hit body's
    output, or with jax_hit=False on the port's plain one."""
    hit = None
    if jax_hit:
        hit = lambda xh, _: torch.tensor(np.asarray(
            c["hit"](jnp.asarray(xh.numpy()))))
    return tuple(t.numpy() for t in fuzz.fuzz_split_inputs(
        *(torch.tensor(t) for t in c["tabs"]), seed=seed, n=n, hit=hit))


@pytest.fixture(scope="module")
def cases():
    js, *_ = jsd.parse_scene(os.path.join(REPO,
                                          "examples/cornellbox/cb.json"))
    out = {}
    for name, scene in (("cornell", js),
                        ("all-branches",
                         fuzz.all_branches_scene(jsc.SceneBuilder()))):
        tabs, st = _tables(scene)
        args = (st.presence, st.dist_sets, st.lcidx, st.lpresent,
                st.emi_cols, MIN_DEPTH, RR, st.full_phi)
        ltab, _, stab = (jnp.asarray(t) for t in tabs)
        out[name] = dict(
            tabs=tabs, static=st, args=args,
            hit=jax.jit(lambda x, s=stab: jcb.xla_reference_hit(x, s)),
            shade=jax.jit(lambda x, l=ltab, a=args:
                          jcb.xla_reference_shade(x, l, *a)))
    return out


def _gate(out, ref, flag_cols=()):
    both_nan = np.isnan(out) & np.isnan(ref)
    close = np.isclose(out, ref, rtol=RTOL, atol=ATOL) | both_nan
    assert close.mean() >= ELEM_GATE, (
        close.mean(), [(j, int((~close[j]).sum()))
                       for j in range(out.shape[0])])
    for j in flag_cols:
        assert (out[j] == ref[j]).mean() >= ELEM_GATE, j


@pytest.mark.parametrize("name,seed", [("cornell", 0), ("all-branches", 0),
                                       ("all-branches", 1)])
def test_hit_body_matches_xla_reference(cases, name, seed):
    c = cases[name]
    xh, _, _ = _split(c, seed, N, jax_hit=False)
    ref = np.asarray(c["hit"](jnp.asarray(xh)))
    out = tcb.hit_shade_t(torch.tensor(xh),
                          torch.tensor(c["tabs"][2])).numpy()
    assert out.shape == (tcb.HIT_OUT_COLS, N)
    _gate(out, ref)
    # ids agree on every lane; the footprint is reached
    np.testing.assert_array_equal(out[24:26], ref[24:26])
    assert np.abs(out[20:24]).max() > 0.0
    # sphere lanes read the (phi, theta) chart
    sph = xh[8] > 0.5
    assert sph.any() and (out[18:20, sph] != 0.0).any()


@pytest.mark.parametrize("name,seed", [("cornell", 0), ("all-branches", 0),
                                       ("all-branches", 1)])
def test_shade_body_matches_xla_reference(cases, name, seed):
    c = cases[name]
    ltab = c["tabs"][0]
    _, xs, _ = _split(c, seed, N)
    ref = np.asarray(c["shade"](jnp.asarray(xs)))
    out = tcb.shade_split_t(torch.tensor(xs), torch.tensor(ltab),
                            c["static"], MIN_DEPTH, RR).numpy()
    assert out.shape == (tcb.OUT_COLS, N)
    _gate(out, ref, FLAG_COLS)


@pytest.mark.parametrize("name", ["cornell", "all-branches"])
def test_split_equals_fused_on_untextured_tables(cases, name):
    """hit body -> resolve_params -> shade body gives the fused body's
    output on every element (bit-identical)."""
    c = cases[name]
    ltab, mtab, stab = (torch.tensor(t) for t in c["tabs"])
    _, xs, x = _split(c, 2, N, jax_hit=False)
    fused = tcb.cbody_reference(torch.tensor(x), ltab, mtab, stab,
                                c["static"], MIN_DEPTH, RR).numpy()
    split = tcb.cbody_shade_reference(torch.tensor(xs), ltab, c["static"],
                                      MIN_DEPTH, RR).numpy()
    same = (split == fused) | (np.isnan(split) & np.isnan(fused))
    assert same.all(), [(j, int((~same[j]).sum())) for j in range(32)]


@pytest.fixture(scope="module")
def shade_vjps(cases):
    """Per table set: (JAX cotangents (dx, dltab), the port's)."""
    out = {}
    for name, c in cases.items():
        ltab = c["tabs"][0]
        _, xs, _ = _split(c, 3, N_VJP)
        ct = np.random.default_rng(4).normal(
            size=(tcb.OUT_COLS, N_VJP)).astype(np.float32)
        _, vjp = jax.vjp(lambda x_, l_: jcb.xla_reference_shade(
            x_, l_, *c["args"]), jnp.asarray(xs), jnp.asarray(ltab))
        ref = [np.asarray(r) for r in vjp(jnp.asarray(ct))]
        xt = torch.tensor(xs).requires_grad_(True)
        lt = torch.tensor(ltab).requires_grad_(True)
        y = tcb.shade_split_t(xt, lt, c["static"], MIN_DEPTH, RR)
        got = [g.numpy() for g in torch.autograd.grad(y, (xt, lt),
                                                      torch.tensor(ct))]
        vjp_ref = tcb.cbody_shade_vjp_reference(
            torch.tensor(xs), torch.tensor(ltab), torch.tensor(ct),
            c["static"], MIN_DEPTH, RR)
        for g, r in zip(got, vjp_ref):
            np.testing.assert_array_equal(g, r.numpy())
        out[name] = (ref, got)
    return out


@pytest.mark.parametrize("name", ["cornell", "all-branches"])
def test_shade_backward_matches_jax_vjp(shade_vjps, name):
    (dr, dlr), (dx, dl) = shade_vjps[name]
    assert dx.shape == (tcb.SHADE_IN_COLS, N_VJP) and np.isfinite(dx).all()
    fin = np.isfinite(dr)
    close = np.isclose(dx, dr, rtol=VJP_RTOL, atol=VJP_ATOL)
    assert close[fin].mean() >= ELEM_GATE, (
        close[fin].mean(), [(j, int((~close[j] & fin[j]).sum()))
                            for j in range(tcb.SHADE_IN_COLS)])
    # the texture-resolved kd columns and beta get gradient
    for j in (tcb.S_KD, tcb.S_BETA):
        assert np.abs(dx[j]).max() > 0.0, j
    assert np.isfinite(dl).all()
    fin = np.isfinite(dlr)
    rel = np.linalg.norm((dl - dlr)[fin]) / max(
        np.linalg.norm(dlr[fin]), 1e-30)
    assert rel <= TAB_GATE, rel
