"""Scenes past the shared memory the port's kernels once staged whole:
K1 / K2 stage a sphere table of any size in chunks of at most 512 rows
(kernels/intersect.cu SPH_CHUNK), and K3-K6 stage the material, sphere
and light tables while they fit and read the rest in place
(kernels/ops.py stage_plan).

On the CPU: the plans (scenes under every cap stage every table at the
bytes the kernels always took; the 2,500-light scene of
tools/make_cb_big_tables.py fits a block), its route (the fused bounce,
as the JAX package's mega path takes it), the kernels' per-thread code
built by g++ at table sizes past the caps (K1 / K2's loop on 2,502
spheres equal to the plain versions lane for lane, K4's lane code on a
1,200-light table within test_torch_k4_host.py's gates), and the port's
render of a 1,200-light scene against the JAX package's
(tests/torch_oracles.py ``big_lights``, written by
tools/make_torch_oracles.py) within PIXEL_ATOL, the JAX package's gate
between its fused and composed paths (measured 2.8e-3 at one pixel of
3.44, so the gate stands 7 % above it; the port's composed path lies as
far from JAX and 3.9e-5 from its fused path; the JAX side is its CPU
route, the composed XLA path).  tools/witness_big_lights.py holds the
parts this scene stresses against the JAX package on the same draws:
the light pick and the hits are equal to the bit, the light sample's
pdf differs by up to 3.9e-4 relative near a small sphere's silhouette,
which would account for the pixel."""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from arendur_tpu_torch import scene as sc
from arendur_tpu_torch.io import scenedesc
from arendur_tpu_torch.kernels import host_bwd, host_isect, ops
from arendur_tpu_torch.render import cbounce as cb
from arendur_tpu_torch.render import fuzz
from arendur_tpu_torch.render import integrator as integ
from arendur_tpu_torch.shapes import cluster_intersect as ci
from arendur_tpu_torch.shapes import sphere as sph

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "tools"))
import make_cb_big_tables as mbt  # noqa: E402
import torch_oracles as orc  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.dirname(HERE)
CORNELL = os.path.join(REPO, "examples/cornellbox")
PIXEL_ATOL = 3e-3
K4_GATE = 0.999                 # test_torch_k4_host.py's gates
K4_RTOL, K4_ATOL = 1e-3, 1e-5
TAB_GATE = 1e-3


def _tables(scene):
    ds = sc.DeviceScene.build(scene, "cpu")
    return ds, (ds.ltab.shape[0], ds.ltab.shape[1], ds.mtab.shape[0],
                ds.stab.shape[0])


def _scene(which):
    if which == "45-row box":
        return fuzz.spread_materials(
            scenedesc.parse_scene(os.path.join(CORNELL, "cb.json"))[0])
    return scenedesc.parse_scene(os.path.join(CORNELL, which))[0]


@pytest.fixture(scope="module")
def lights(tmp_path_factory):
    """The default scene of tools/make_cb_big_tables.py: 2,500 small
    sphere lights over 48 new materials."""
    path = mbt.write(str(tmp_path_factory.mktemp("big") / "lights.json"),
                     mbt.lights_desc())
    return scenedesc.parse_scene(path)[0]


@pytest.mark.parametrize("which", ["cb.json", "cb_etex.json",
                                   "cb_inst.json", "45-row box"])
def test_plans_under_the_caps_stage_everything(which):
    """Every table staged, at the bytes the kernels took before they had
    a plan: K3 / K6 odd pitches (ops.shade_smem), K4 / K5 dense rows.
    (K1 / K2 take one block size for any table: the card test
    test_torch_gpu.py::test_sphere_table_limits.)"""
    _, (nl, cl, nm, ns) = _tables(_scene(which))
    want = {"K3": (ops.STAGE_ALL, ops.shade_smem(nl, cl, nm, ns)),
            "K4": (ops.STAGE_ALL, 4 * (nl * cl + nm * 16 + ns * 24)),
            "K5": (ops.STAGE_S, 4 * ns * 24),
            "K6": (ops.STAGE_L, ops.shade_smem(nl, cl))}
    for k, (staged, smem) in want.items():
        assert ops.stage_plan(k, nl, cl, nm, ns) == ops.StagePlan(staged,
                                                                  smem), k
    # one chunk of K1 / K2's sphere pass holds the whole table
    assert ns <= 512


def test_plans_past_the_caps_fit_a_block(lights):
    ds, (nl, cl, nm, ns) = _tables(lights)
    assert (nl, cl, nm, ns) == (2502, 53, 57, 2502)
    assert ds.ktab.shape == (2502, 24)
    # each kernel's tables once took more than a block holds
    assert ops.shade_smem(nl, cl, nm, ns) > ops.SMEM_LIMIT
    assert ops.shade_smem(nl, cl) > ops.SMEM_LIMIT
    assert 4 * (nl * cl + nm * 16 + ns * 24) > ops.SMEM_LIMIT
    assert 4 * ns * 24 > ops.SMEM_LIMIT
    whole = {"K3": ops.STAGE_ALL, "K4": ops.STAGE_ALL, "K5": ops.STAGE_S,
             "K6": ops.STAGE_L}
    for k in whole:
        plan = ops.stage_plan(k, nl, cl, nm, ns)
        assert plan.staged != whole[k] and plan.smem <= ops.SMEM_LIMIT, k
    # the material table (3,876 B at odd pitches) still fits K3's block
    assert ops.stage_plan("K3", nl, cl, nm, ns) == ops.StagePlan(
        ops.STAGE_M, 4 * nm * 17)
    # K1 / K2 test the sphere table in five chunks of at most 512 rows
    assert -(-ds.ktab.shape[0] // 512) == 5


def test_route_is_the_fused_bounce(lights):
    """The big tables change no route: untextured sphere lights take the
    fused bounce (the JAX package's mega path, K7 on the TPU)."""
    ds, _ = _tables(lights)
    assert not ds.composed_only and ds.intersector == "cluster"
    assert ds.cw.shape[0] > 0


@pytest.fixture(scope="module")
def isect_lib(tmp_path_factory):
    lib = host_isect.build(str(tmp_path_factory.mktemp("isect")))
    if lib is None:
        pytest.skip("no host C++ compiler (g++) to build K1 / K2's loop")
    return lib


def test_host_isect_past_the_cap(isect_lib, lights):
    """K1 / K2's per-thread loop with S = 2,502 on 64 sphere rays (a
    live count below N) equals the plain sphere branch and the plain
    cluster test lane for lane."""
    ds, _ = _tables(lights)
    v = np.concatenate([lights.tri_v0, lights.tri_v1, lights.tri_v2])
    o, d, tm = (torch.tensor(a) for a in fuzz.sphere_rays(
        lights.spheres, v.min(0), v.max(0), 64, 16))
    na = 60
    kw = dict(sph_tab=ds.ktab, full_phi=ds.full_phi)
    args = (ds.cw, ds.cbox, o, d, tm, torch.tensor(na))
    t_p, s_p = ci.intersect_clusters_reference(*args, **kw)
    b_p = ci.occluded_clusters_reference(*args, **kw)
    t_h, s_h, _ = host_isect.run(isect_lib, False, ds.cw, ds.cbox, o, d, tm,
                                 na, **kw)
    _, b_h, _ = host_isect.run(isect_lib, True, ds.cw, ds.cbox, o, d, tm,
                               na, **kw)
    np.testing.assert_array_equal(s_h, s_p.numpy())
    np.testing.assert_array_equal(t_h, t_p.numpy())
    np.testing.assert_array_equal(b_h, b_p.numpy())
    # the sphere branch alone: the plain loop's winners on the live rays
    best, code = sph.sphere_best(ds.ktab, o[:na], d[:na], tm[:na],
                                 ds.full_phi)
    on_sph = s_h[:na] <= -2
    np.testing.assert_array_equal(s_h[:na][on_sph], code.numpy()[on_sph])
    np.testing.assert_array_equal(t_h[:na][on_sph], best.numpy()[on_sph])
    # spheres past row 512 (the kernels' first chunk) win on some lanes
    assert on_sph.sum() >= 10 and (-2 - s_h[:na][on_sph] >= 512).any()


@pytest.fixture(scope="module")
def host_k4(tmp_path_factory):
    fn = host_bwd.build(str(tmp_path_factory.mktemp("k4")))
    if fn is None:
        pytest.skip("no host C++ compiler (g++) to build K4's lane code")
    return fn


def test_host_bwd_past_the_cap(host_k4, tmp_path):
    """K4's lane code (the dense tables it reads in place past the cap)
    on a 1,200-light table, every lane taped, against autograd over the
    plain body."""
    scene = scenedesc.parse_scene(mbt.write(
        str(tmp_path / "k4.json"), mbt.lights_desc(1198, 48)))[0]
    ds, (nl, cl, nm, ns) = _tables(scene)
    assert ops.stage_plan("K4", nl, cl, nm, ns).staged != ops.STAGE_ALL
    tabs = (ds.ltab, ds.mtab, ds.stab)
    n = 512
    xt = torch.tensor(fuzz.fuzz_bounce_inputs(
        *(t.numpy() for t in tabs), seed=3, n=n).T.copy())
    ct = torch.tensor(np.random.default_rng(5).normal(
        size=(cb.OUT_COLS, n)).astype(np.float32))
    dx, dlt, dmt, dst, need, nodes, failed = host_bwd.run(
        host_k4, xt, ct, *tabs, ds.static, 4, 0.05)
    ref = [g.numpy() for g in cb.cbody_vjp_reference(
        xt, *tabs, ct, ds.static, 4, 0.05)]
    assert failed == 0 and need.all() and nodes.max() <= ops.TAPE_CAP
    close = np.isclose(dx, ref[0], rtol=K4_RTOL, atol=K4_ATOL) \
        | (np.isnan(dx) & np.isnan(ref[0]))
    assert close.mean() >= K4_GATE
    for g, r in zip((dlt, dmt, dst), ref[1:]):
        assert np.isfinite(g).all()
        assert np.linalg.norm(g - r) <= TAB_GATE * max(np.linalg.norm(r),
                                                       1e-30)


def test_render_matches_jax(tmp_path):
    """The port's render (the fused bounce's plain versions) of cb.json
    with 1,200 small sphere lights over 48 materials against the JAX
    package's, same scene and seed: 2.8e-3 at worst, 7 % under the
    gate (see the module's docstring)."""
    ts, tcam, tfilm, tcfg, _ = scenedesc.parse_scene(
        orc.big_lights_scene(str(tmp_path)), spp_override=orc.RENDER_SPP,
        resolution_override=orc.RENDER_RES)
    tcfg = dataclasses.replace(tcfg, max_depth=orc.RENDER_DEPTH)
    ds = sc.DeviceScene.build(ts, "cpu")
    nl, cl = ds.ltab.shape
    nm, ns = ds.mtab.shape[0], ds.stab.shape[0]
    assert nl == ns == orc.BIG_LIGHTS + 2 and not ds.composed_only
    for k, whole in (("K3", ops.STAGE_ALL), ("K4", ops.STAGE_ALL),
                     ("K6", ops.STAGE_L)):
        assert ops.stage_plan(k, nl, cl, nm, ns).staged != whole, k
    img = integ.render(ds, tcam, tfilm, tcfg).numpy()
    ref = orc.load("big_lights", orc.big_inputs())["img"]
    assert np.isfinite(img).all() and ref.max() > 0.05
    np.testing.assert_allclose(img, ref, rtol=0.0, atol=PIXEL_ATOL)
