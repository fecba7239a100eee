"""The bounce-shade module (kernel K3) against the JAX package: the
port's plain PyTorch body against cbounce.xla_reference (the JAX
body's plain-XLA form, jitted once per table set) on fuzzed [58, 2048]
inputs over the Cornell tables and over a second table set that
reaches every light and material branch.  The CUDA kernel is held
against the plain body on the card in tests/test_torch_gpu.py."""

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
ELEM_GATE = 0.999          # share of elements within RTOL / ATOL
RTOL, ATOL = 1e-4, 1e-5
FLAG_GATE = 0.999          # share of lanes whose flags agree
FLAG_COLS = (12, 13, 16, 24)   # alive, specular, nee_prev, need_shadow
MIN_DEPTH, RR = 4, 0.05


def _tables(jscene):
    pk, cidx, present = jsc.light_pack(jscene)
    ltab = np.asarray(pk)
    mtab = np.asarray(jm.param_table(jscene.materials))
    stab = np.asarray(jsph.shade_table(jscene.spheres))
    phimax = np.asarray(jscene.spheres.phimax)
    lt = np.asarray(jscene.lights.ltype)
    prim = np.clip(np.asarray(jscene.lights.prim), 0, len(phimax) - 1)
    full_phi = bool((phimax[prim[lt == jsc.L_AREA_SPHERE]]
                     >= 2.0 * np.pi - 1e-5).all())
    static = tsc.ShadeStatic(
        presence=jm.slot_presence(jscene.materials),
        dist_sets=jm.dist_presence(jscene.materials),
        lcidx=tuple(sorted(cidx.items())), lpresent=tuple(present),
        emi_cols=tuple(cidx["emission"]), full_phi=full_phi)
    return ltab, mtab, stab, static


def _case(jscene):
    ltab, mtab, stab, static = _tables(jscene)
    args = (static.presence, static.dist_sets, static.lcidx,
            static.lpresent, static.emi_cols, MIN_DEPTH, RR,
            static.full_phi)
    ref = jax.jit(lambda x: jcb.xla_reference(
        x, jnp.asarray(ltab), jnp.asarray(mtab), jnp.asarray(stab), *args))
    return dict(tabs=(ltab, mtab, stab), static=static, ref=ref)


@pytest.fixture(scope="module")
def cases():
    js, *_ = jsd.parse_scene(os.path.join(REPO,
                                          "examples/cornellbox/cb.json"))
    return {"cornell": _case(js),
            "all-branches": _case(fuzz.all_branches_scene(
                jsc.SceneBuilder()))}


def _gate(out, ref):
    both_nan = np.isnan(out) & np.isnan(ref)
    close = np.isclose(out, ref, rtol=RTOL, atol=ATOL) | both_nan
    assert close.mean() >= ELEM_GATE, (
        close.mean(), [(j, int((~close[j]).sum())) for j in range(32)])
    for j in FLAG_COLS:
        assert (out[j] == ref[j]).mean() >= FLAG_GATE, j


@pytest.mark.parametrize("name,seed", [("cornell", 0), ("cornell", 1),
                                       ("all-branches", 0),
                                       ("all-branches", 1)])
def test_body_matches_xla_reference(cases, name, seed):
    c = cases[name]
    x = fuzz.fuzz_bounce_inputs(*c["tabs"], seed=seed, n=N).T.copy()
    ref = np.asarray(c["ref"](jnp.asarray(x)))
    out = tcb.bounce_shade_t(torch.tensor(x),
                             *[torch.tensor(t) for t in c["tabs"]],
                             c["static"], MIN_DEPTH, RR).numpy()
    assert out.shape == (tcb.OUT_COLS, N)
    _gate(out, ref)


def test_all_branches_are_reached(cases):
    ltab, mtab, stab = cases["all-branches"]["tabs"]
    x = fuzz.fuzz_bounce_inputs(ltab, mtab, stab, seed=0, n=N)
    ltypes = set(ltab[x[:, 50].astype(int), 0].astype(int).tolist())
    assert ltypes == {0, 1, 2, 3, 4}
    mat = np.where(x[:, 8] > 0.5, stab[x[:, 9].astype(int), 20], x[:, 37])
    assert set(mtab[mat.astype(int), 0].astype(int).tolist()) == {0, 1, 2, 3}
    assert cases["all-branches"]["static"].full_phi is False


def test_backward_matches_jax_vjp(cases):
    """kd gradients through the bounce shade (the plain body on the
    CPU; the kernel's backward replays the same body) against jax.vjp
    of the JAX body, for the cotangent 1 on L and beta."""
    c = cases["cornell"]
    x = fuzz.fuzz_bounce_inputs(*c["tabs"], seed=2, n=256).T.copy()
    ltab, mtab, stab = (torch.tensor(t) for t in c["tabs"])
    mtab.requires_grad_(True)
    out = tcb.bounce_shade_t(torch.tensor(x), ltab, mtab, stab,
                             c["static"], MIN_DEPTH, RR)
    out[6:12].sum().backward()
    st = c["static"]
    args = (st.presence, st.dist_sets, st.lcidx, st.lpresent,
            st.emi_cols, MIN_DEPTH, RR, st.full_phi)
    jl, jmt, js_ = (jnp.asarray(t) for t in c["tabs"])
    _, vjp = jax.vjp(lambda m: jcb.xla_reference(jnp.asarray(x), jl, m,
                                                 js_, *args), jmt)
    ct = np.zeros((tcb.OUT_COLS, x.shape[1]), np.float32)
    ct[6:12] = 1.0
    g_ref = np.asarray(vjp(jnp.asarray(ct))[0])
    g = mtab.grad.numpy()
    # kd: columns 1:4 of the material rows
    assert np.abs(g[:, 1:4]).sum() > 0
    np.testing.assert_allclose(g[:, 1:4], g_ref[:, 1:4], rtol=1e-3,
                               atol=1e-3)
