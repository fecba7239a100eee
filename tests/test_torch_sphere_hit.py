"""The intersect kernels' sphere branch (K1 / K2 with a sphere table, the
port of arendur_tpu/shapes/pallas_intersect.py::_sphere_best) and the
four scene queries that now pass the sphere table into K1 / K2, against
the JAX package under ARENDUR_SPHERES=kernel.

Oracles, on the Cornell box (cb.json: phimax 6.28, so phi_full is False
and the phi clip runs), the all-branches scene (a partial sphere,
phimax 4.0) and the textured quad (quad.json: four full-phi spheres),
with both values of full_phi at the kernel level:

* the plain sphere branch against ``_sphere_best`` evaluated op by op
  (``jax.disable_jit``): codes and t equal on every lane;
* the plain K1 / K2 against the Pallas kernels in interpret mode.  XLA
  compiles the interpret-mode kernel with multiply-add contraction, so
  its sphere quadratic rounds differently from an op-by-op evaluation
  (the port's and the CUDA kernel's, which is built with -fmad=false).
  On rays whose quadratic is ill-conditioned (a root at the ray origin:
  rays started on a sphere; a near-zero discriminant: grazing rays;
  ``_ill_conditioned``) that decides hit or miss.  Those
  split lanes are budgeted: each must be such a ray, and at most
  SPLIT_BUDGET of them.  Everywhere else the codes agree on every live
  lane, triangle t within T_RTOL, sphere t within T_RTOL times the
  root's condition number (the discriminant cancels on near-tangent
  rays);
* dead lanes (>= n_alive) are misses / unblocked in the port, while
  the Pallas kernels run _sphere_best before their n_alive test and
  report sphere codes there (nothing downstream reads a dead lane);
* the scene queries (intersect_raw, intersect, occluded and the final
  pass's intersect_light) against JAX's with ARENDUR_SPHERES=kernel,
  ARENDUR_INTERSECT=pallas and ARENDUR_PALLAS_INTERPRET=1.

The CUDA kernels are held against the plain versions on the card in
tests/test_torch_gpu.py and chip_smoke.py phase 14.
"""

import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from arendur_tpu import scene as jsc
from arendur_tpu.io import scenedesc as jsd
from arendur_tpu.shapes import pallas_intersect as pli
from arendur_tpu.shapes import sphere as jsph
from arendur_tpu.shapes.mxu_intersect import ray_features
from arendur_tpu_torch import convert
from arendur_tpu_torch import scene as tsc
from arendur_tpu_torch.io import scenedesc as tsd
from arendur_tpu_torch.render import fuzz
from arendur_tpu_torch.render import integrator as integ
from arendur_tpu_torch.shapes import cluster_intersect as ci
from arendur_tpu_torch.shapes import sphere as tsph

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 512
N_ALIVE = 400
SPLIT_BUDGET = 16    # split lanes of 512, each on an ill-conditioned ray
T_RTOL = 1e-6
QUERY_TOL = 1e-5     # t, p_local, pos of the scene queries
ENV = {"ARENDUR_SPHERES": "kernel", "ARENDUR_INTERSECT": "pallas",
       "ARENDUR_PALLAS_INTERPRET": "1"}


def _box(scene):
    v = np.concatenate([scene.tri_v0, scene.tri_v1, scene.tri_v2])
    return v.min(0), v.max(0)


@pytest.fixture(scope="module")
def scenes():
    out = {}
    for name, path in (("cornell", "examples/cornellbox/cb.json"),
                       ("quad", "examples/texturedquad/quad.json")):
        js, *_ = jsd.parse_scene(os.path.join(REPO, path))
        ts, *_ = tsd.parse_scene(os.path.join(REPO, path))
        out[name] = (js, ts, convert.scene_from_numpy(js, "cpu"))
    ja = fuzz.all_branches_scene(jsc.SceneBuilder())
    ta = fuzz.all_branches_scene(tsc.SceneBuilder())
    out["all-branches"] = (ja, ta, tsc.DeviceScene.build(ta, "cpu"))
    return out


def _rays(js, seed=0):
    lo, hi = _box(js)
    return fuzz.sphere_rays(js.spheres, lo, hi, N, seed)


@pytest.mark.parametrize("name", ["cornell", "all-branches", "quad"])
def test_kernel_tables_equal(scenes, name):
    js, ts, ds = scenes[name]
    ref = np.asarray(jsph.kernel_table(js.spheres))
    np.testing.assert_array_equal(tsph.kernel_table(ts.spheres), ref)
    np.testing.assert_array_equal(ds.ktab.numpy(), ref)
    assert ds.full_phi == js.spheres.phi_full == ts.spheres.phi_full \
        == (name == "quad")


@pytest.mark.parametrize("full_phi", [False, True])
@pytest.mark.parametrize("name", ["cornell", "all-branches"])
def test_sphere_branch_matches_jax_op_by_op(scenes, name, full_phi):
    js, _, ds = scenes[name]
    o, d, tmax = _rays(js)
    tab = jsph.kernel_table(js.spheres)
    with jax.disable_jit():
        t_ref, c_ref = pli._sphere_best(
            ray_features(jnp.asarray(o), jnp.asarray(d)),
            pli._make_aux(jnp.asarray(o), jnp.asarray(tmax), None), tab,
            tab.shape[0], full_phi, N)
    t, code = tsph.sphere_best(ds.ktab, torch.tensor(o), torch.tensor(d),
                               torch.tensor(tmax), full_phi)
    np.testing.assert_array_equal(code.numpy(),
                                  np.asarray(c_ref)[:, 0].astype(np.int32))
    np.testing.assert_array_equal(t.numpy(), np.asarray(t_ref)[:, 0])
    assert (code.numpy() <= -2).sum() > N // 4


def _ill_conditioned(spheres, o, d, tol: float = 1e-5):
    """[n] bool: the rays whose quadratic against some sphere has a root
    within `tol` of the ray origin (a ray started on the surface) or a
    discriminant within `tol` of zero relative to its terms (a grazing
    ray), evaluated in float64.  There a rounding of the f32 quadratic
    (an FMA where the kernels multiply and add) decides hit or miss."""
    w2o = np.asarray(spheres.w2o, np.float64)
    rad = np.asarray(spheres.radius, np.float64)
    o, d = np.asarray(o, np.float64), np.asarray(d, np.float64)
    out = np.zeros(len(o), bool)
    for s in range(len(rad)):
        ol = o @ w2o[s, :3, :3] + w2o[s, 3, :3]
        dl = d @ w2o[s, :3, :3]
        a = (dl * dl).sum(-1)
        b = 2.0 * (dl * ol).sum(-1)
        delta = b * b - 4.0 * a * ((ol * ol).sum(-1) - rad[s] ** 2)
        sq = np.sqrt(np.maximum(delta, 0.0))
        near = np.minimum(np.abs(-b - sq), np.abs(-b + sq)) / (2.0 * a)
        out |= ((delta >= 0.0) & (near < tol)) | (
            np.abs(delta) < tol * np.maximum(b * b, 4.0 * a * rad[s] ** 2))
    return out


def _root_condition(spheres, o, d, code):
    """The relative condition number of each sphere-coded lane's root t
    = (-b -+ sqrt(b^2 - 4ac)) / 2a against a relative rounding of each
    term, (|b| + (b^2 + |4ac|) / (2 sqrt(delta))) / (2a |t|), in
    float64: the discriminant cancels on near-tangent rays."""
    w2o = np.asarray(spheres.w2o, np.float64)
    rad = np.asarray(spheres.radius, np.float64)
    s = np.maximum(-(code.astype(np.int64) + 2), 0)
    ol = np.einsum("nj,njk->nk", o.astype(np.float64), w2o[s, :3, :3]) \
        + w2o[s, 3, :3]
    dl = np.einsum("nj,njk->nk", d.astype(np.float64), w2o[s, :3, :3])
    a = (dl * dl).sum(-1)
    b = 2.0 * (dl * ol).sum(-1)
    c4 = 4.0 * a * ((ol * ol).sum(-1) - rad[s] ** 2)
    sq = np.sqrt(np.maximum(b * b - c4, 1e-30))
    t = np.where(-b - sq > 0.0, -b - sq, -b + sq) / (2.0 * a)
    return (np.abs(b) + (b * b + np.abs(c4)) / (2.0 * sq)) \
        / (2.0 * a * np.maximum(np.abs(t), 1e-30))


def _split_lanes(js, o, d, split):
    """The split lanes, checked against the budget and its cause."""
    ill = _ill_conditioned(js.spheres, o, d)
    assert not (split & ~ill).any(), np.nonzero(split & ~ill)[0]
    assert split.sum() <= SPLIT_BUDGET, split.sum()
    return ill


@pytest.mark.parametrize("full_phi", [False, True])
@pytest.mark.parametrize("name", ["cornell", "all-branches"])
def test_closest_hit_matches_pallas_interpret(scenes, name, full_phi):
    js, _, ds = scenes[name]
    o, d, tmax = _rays(js)
    t_ref, s_ref = pli.intersect_clusters(
        jnp.asarray(js.tri_cw), jnp.asarray(js.tri_cbox), jnp.asarray(o),
        jnp.asarray(d), jnp.asarray(tmax), n_alive=jnp.int32(N_ALIVE),
        sph_tab=jsph.kernel_table(js.spheres), full_phi=full_phi,
        interpret=True)
    t_ref, s_ref = np.asarray(t_ref), np.asarray(s_ref)
    t, s = ci.intersect_clusters(
        ds.cw, ds.cbox, torch.tensor(o), torch.tensor(d),
        torch.tensor(tmax), n_alive=torch.tensor(N_ALIVE),
        sph_tab=ds.ktab, full_phi=full_phi)
    t, s = t.numpy(), s.numpy()
    live = np.arange(N) < N_ALIVE
    ill = _split_lanes(js, o, d, live & (s != s_ref))
    same = live & (s == s_ref) & ~ill
    tri, sph = same & (s >= 0), same & (s <= -2)
    assert tri.sum() > 50 and sph.sum() > 30
    np.testing.assert_allclose(t[tri], t_ref[tri], rtol=T_RTOL)
    kappa = _root_condition(js.spheres, o, d, s)
    assert (np.abs(t[sph] - t_ref[sph])
            <= T_RTOL * kappa[sph] * np.abs(t_ref[sph])).all()
    # dead lanes: misses in the port; the Pallas kernel's _sphere_best
    # runs before its n_alive test and reports sphere codes there
    assert (s[~live] == -1).all() and (t[~live] == tmax[~live]).all()
    assert (s_ref[~live] <= -2).any()


@pytest.mark.parametrize("full_phi", [False, True])
@pytest.mark.parametrize("name", ["cornell", "all-branches"])
def test_any_hit_matches_pallas_interpret(scenes, name, full_phi):
    js, _, ds = scenes[name]
    o, d, tmax = _rays(js, seed=1)
    b_ref = np.asarray(pli.occluded_clusters(
        jnp.asarray(js.tri_cw), jnp.asarray(js.tri_cbox), jnp.asarray(o),
        jnp.asarray(d), jnp.asarray(tmax), n_alive=jnp.int32(N_ALIVE),
        sph_tab=jsph.kernel_table(js.spheres), full_phi=full_phi,
        interpret=True))
    b = ci.occluded_clusters(
        ds.cw, ds.cbox, torch.tensor(o), torch.tensor(d),
        torch.tensor(tmax), n_alive=torch.tensor(N_ALIVE),
        sph_tab=ds.ktab, full_phi=full_phi).numpy()
    live = np.arange(N) < N_ALIVE
    _split_lanes(js, o, d, live & (b != b_ref))
    assert 0.2 < b[live].mean() < 0.9
    # blocked by a sphere alone: the sphere branch decides these lanes
    tri_only = ci.occluded_clusters(
        ds.cw, ds.cbox, torch.tensor(o), torch.tensor(d),
        torch.tensor(tmax)).numpy()
    assert (b & ~tri_only).sum() > 30
    assert not b[~live].any() and b_ref[~live].any()


def test_sphere_table_refused_with_instancing(scenes):
    _, _, ds = scenes["cornell"]
    o = torch.zeros(256, 3)
    d = torch.ones(256, 3)
    tm = torch.full((256,), float("inf"))
    for fn in (ci.intersect_clusters, ci.occluded_clusters):
        with pytest.raises(ValueError, match="instancing"):
            fn(ds.cw, ds.cbox, o, d, tm, torch.tensor(256), period=256,
               sph_tab=ds.ktab)


@pytest.mark.parametrize("name", ["cornell", "quad"])
def test_scene_queries_match_jax_kernel_spheres(scenes, name, monkeypatch):
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)
    js, _, ds = scenes[name]
    o, d, tmax = _rays(js, seed=2)
    ok = ~_ill_conditioned(js.spheres, o, d)
    assert ok.sum() > N // 2
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    to, td = torch.tensor(o), torch.tensor(d)
    eq = lambda a, r, what: np.testing.assert_array_equal(
        np.asarray(a)[ok], np.asarray(r)[ok], what)
    close = lambda a, r, m, what: np.testing.assert_allclose(
        np.asarray(a)[m], np.asarray(r)[m], rtol=QUERY_TOL, atol=QUERY_TOL,
        err_msg=what)

    raw_j = jsc.intersect_raw(js, jo, jd)
    raw_t = integ.intersect_raw(ds, to, td)
    for k in ("hit", "is_sphere"):
        eq(raw_t[k].numpy(), raw_j[k], k)
    is_s = np.asarray(raw_j["is_sphere"]) & ok
    assert is_s.sum() > 50
    eq(np.where(is_s, raw_t["s_idx"].numpy(), 0),
       np.where(is_s, raw_j["s_idx"], 0), "s_idx")
    # sphere roots: both sides round the quadratic (XLA with
    # multiply-add contraction), so t and p_local get QUERY_TOL plus
    # T_RTOL times the root's condition number
    t_ref = np.asarray(raw_j["t"])
    kappa = _root_condition(js.spheres, o, d,
                            -2 - np.asarray(raw_j["s_idx"]))
    sph_tol = QUERY_TOL + T_RTOL * kappa * np.abs(t_ref)
    tri = ok & np.asarray(raw_j["hit"]) & ~is_s
    close(raw_t["t"].numpy(), t_ref, tri, "t")
    assert (np.abs(raw_t["t"].numpy()[is_s] - t_ref[is_s])
            <= sph_tol[is_s]).all()
    assert (np.abs(raw_t["p_local"].numpy() - np.asarray(raw_j["p_local"]))
            .max(-1)[is_s] <= sph_tol[is_s]).all()
    tri = ok & np.asarray(raw_j["hit"]) & ~is_s
    close(raw_t["trow"].numpy(), raw_j["trow"], tri, "trow")

    hit_j = jsc.intersect(js, jo, jd, tmax=jnp.asarray(tmax))
    hit_t = tsc.intersect(ds, to, td, tmax=torch.tensor(tmax))
    for k in ("hit", "prim", "mat_id", "light_id"):
        eq(getattr(hit_t, k).numpy(), getattr(hit_j, k), k)
    h = ok & np.asarray(hit_j.hit)
    hs = h & (np.asarray(hit_j.prim) >= js.n_tris)
    assert hs.sum() > 30
    kappa = _root_condition(js.spheres, o, d,
                            np.where(hs, js.n_tris - 2
                                     - np.asarray(hit_j.prim), -2))
    sph_tol = QUERY_TOL + T_RTOL * kappa * np.abs(np.asarray(hit_j.t))
    for k in ("t", "pos"):
        a, r = getattr(hit_t, k).numpy(), np.asarray(getattr(hit_j, k))
        close(a, r, h & ~hs, k)
        err = np.abs(a[hs] - r[hs]).reshape(hs.sum(), -1).max(-1)
        assert (err <= sph_tol[hs]).all(), k

    hit_l, light_l = integ.intersect_light(ds, to, td)
    hit_f = jsc.intersect(js, jo, jd)
    eq(hit_l.numpy(), hit_f.hit, "intersect_light hit")
    eq(light_l.numpy(), hit_f.light_id, "intersect_light light_id")

    b_j = jsc.occluded(js, jo, jd, jnp.asarray(tmax))
    b_t = tsc.occluded(ds, to, td, torch.tensor(tmax))
    eq(b_t.numpy(), b_j, "occluded")
    assert 0.2 < b_t.numpy()[ok].mean() < 0.95
