"""Instanced meshes in the port (arendur_tpu_torch scene.InstancedMesh,
the [I * N]-lane K1 / K2 launches, the loader's "Transformed" meshes)
against the JAX package (arendur_tpu/scene.py, tests/test_instancing.py's
quads), on the CPU, where the kernels' plain versions run.

Three scenes: the three instanced quads of tests/test_instancing.py
(pure-instanced: no world triangle), the same with a world ground quad,
and the same with a sphere light behind the quads (no world triangle:
the world K1 tests the spheres alone, C = 0).  Oracles:

* the builder's and the loader's tables equal the JAX package's (a
  "Transformed" JSON and examples/cornellbox/cb_inst.json);
* the four scene queries (intersect_raw, intersect, occluded and the
  final deferred-MIS pass's intersect_light) against JAX's under
  ARENDUR_SPHERES=kernel, ARENDUR_INTERSECT=pallas and
  ARENDUR_PALLAS_INTERPRET=1: hit, prim, light and blocked equal, t
  within rtol 1e-5, positions and uv within atol 1e-5.  With no world
  triangle the JAX package tests its spheres in XLA (scene.py:760-765),
  the port in K1 / K2's sphere branch: lanes on rays whose sphere
  quadratic is ill-conditioned (grazing, or started on the surface) are
  budgeted as in tests/test_torch_sphere_hit.py;
* an instanced quad hides the sphere light from the final pass, and the
  instanced render equals the baked one;
* 16 instances against the same quads baked: the same hits;
* a scene without triangles builds and renders through the composed
  bounce;
* a train step on the instanced quads against the same quads baked.
The render against arendur_tpu.render.integrator.render is in
tests/test_torch_instancing_render.py.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from arendur_tpu import materials as jmats
from arendur_tpu import scene as jsc
from arendur_tpu.geometry import transform as jtf
from arendur_tpu.io import scenedesc as jsd
from arendur_tpu_torch import convert
from arendur_tpu_torch import materials as tmats
from arendur_tpu_torch import scene as tsc
from arendur_tpu_torch.filming import film as tflm
from arendur_tpu_torch.io import scenedesc as tsd
from arendur_tpu_torch.parallel import mesh as tmesh
from arendur_tpu_torch.render import integrator as integ
from arendur_tpu_torch.sampling import filters as tfilt
from arendur_tpu_torch.shapes import cluster_intersect as ci

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 256
QUERY_TOL = 1e-5      # t (relative), pos, uv, trow (absolute)
SPLIT_BUDGET = 4      # lanes of 256, each on an ill-conditioned ray
ENV = {"ARENDUR_SPHERES": "kernel", "ARENDUR_INTERSECT": "pallas",
       "ARENDUR_PALLAS_INTERPRET": "1"}
VARIANTS = ("pure", "ground", "sphere")


def _translate(x, y, z):
    m = np.eye(4, dtype=np.float32)
    m[3, :3] = (x, y, z)
    return m


QUAD_V = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]],
                  np.float32)
QUAD_F = np.array([[0, 1, 2], [0, 2, 3]], np.int64)
# tests/test_instancing.py's placements, one with a rotation and a scale
# (the inverse-transpose differs from the linear part)
TRANSFORMS = [_translate(-1.6, 0.0, 0.0), _translate(1.6, 0.0, -1.0),
              _translate(0.0, 1.6, -2.0)]
TRANSFORMS[1][:3, :3] = np.array([[0.8, 0.6, 0.0], [-0.9, 1.2, 0.0],
                                  [0.0, 0.0, 1.5]], np.float32)


def _scene(builder, mats, variant, baked=False, transforms=TRANSFORMS):
    """The instanced quads (or, with `baked`, the same quads in the world
    pool) in the named variant, on the given package's builder."""
    m = builder.add_material(mtype=mats.M_MATTE, kd=(0.7, 0.4, 0.3),
                             sigma=0.0)
    if baked:
        for t in transforms:
            builder.add_mesh(QUAD_V, QUAD_F, m, transform=t)
    else:
        builder.add_instanced_mesh(
            [dict(vertices=QUAD_V, faces=QUAD_F, mat_id=m)], transforms)
    if variant == "ground":
        builder.add_mesh(QUAD_V, QUAD_F, m,
                         transform=np.diag([4.0, 4.0, 1.0, 1.0]).astype(
                             np.float32) + _translate(0, 0, -4) - np.eye(4))
    if variant == "sphere":
        builder.add_sphere(1.0, -1.0, 1.0, 6.28, m,
                           transform=_translate(0.2, 0.5, -3.5),
                           emission=(4.0, 3.0, 2.0))
    else:
        builder.add_point_light((0, 0, 5.0), (30.0, 30.0, 30.0))
    return builder.build()


@pytest.fixture(scope="module")
def scenes():
    out = {}
    for v in VARIANTS:
        js = _scene(jsc.SceneBuilder(), jmats, v)
        ts = _scene(tsc.SceneBuilder(), tmats, v)
        out[v] = (js, ts, convert.scene_from_numpy(js, "cpu"))
    return out


def _rays(seed, n=N):
    """Rays from around (0, 0, 6) into the quads, the ground and the
    sphere: o [n,3], d [n,3], tmax [n]."""
    rng = np.random.default_rng(seed)
    o = (np.array([0.0, 0.0, 6.0]) + rng.uniform(-0.5, 0.5, (n, 3))
         ).astype(np.float32)
    d = rng.normal(size=(n, 3)) * [0.35, 0.35, 1.0]
    d[:, 2] = -np.abs(d[:, 2]) - 0.3
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    # a quarter aimed at the sphere light's place, past the quads
    k = n // 4
    aim = np.array([0.2, 0.5, -3.5]) + rng.uniform(-0.9, 0.9, (k, 3)) - o[:k]
    d[:k] = aim / np.linalg.norm(aim, axis=-1, keepdims=True)
    tmax = rng.uniform(4.0, 12.0, n).astype(np.float32)
    return o, d.astype(np.float32), tmax


def _ill_conditioned(spheres, o, d, tol: float = 1e-5):
    """[n] bool: rays whose quadratic against some sphere has a root
    within `tol` of the origin or a discriminant within `tol` of zero
    relative to its terms (float64); there the f32 rounding of the
    quadratic (an FMA in XLA, none in the port) decides hit or miss."""
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


def _inst_equal(a, b):
    assert len(a.inst) == len(b.inst) >= 1
    for x, y in zip(a.inst, b.inst):
        for k in ("cw", "cbox", "remap", "attr", "o2w", "w2o", "nrm"):
            np.testing.assert_array_equal(np.asarray(getattr(x, k)),
                                          np.asarray(getattr(y, k)), k)


def _scene_equal(js, ts):
    _inst_equal(js, ts)
    assert js.n_tris == ts.n_tris
    assert (js.tri_cw is None) == (ts.tri_cw is None)
    if ts.tri_cw is not None:
        np.testing.assert_array_equal(ts.tri_cw, np.asarray(js.tri_cw))
    np.testing.assert_array_equal(ts.spheres.o2w, np.asarray(js.spheres.o2w))
    np.testing.assert_array_equal(ts.lights.ltype,
                                  np.asarray(js.lights.ltype))
    np.testing.assert_array_equal(ts.lights.emission,
                                  np.asarray(js.lights.emission))
    np.testing.assert_array_equal(ts.light_distribution.cdf,
                                  np.asarray(js.light_distribution.cdf))
    np.testing.assert_array_equal(ts.materials.kd,
                                  np.asarray(js.materials.kd))


@pytest.mark.parametrize("variant", VARIANTS)
def test_builder_tables_equal_jax(scenes, variant):
    js, ts, ds = scenes[variant]
    _scene_equal(js, ts)
    assert (ts.tri_cw is None) == (variant != "ground")
    # the device scene: an empty world pool holds no cluster
    dp = tsc.DeviceScene.build(ts, "cpu")
    assert dp.cw.shape[0] == (0 if variant != "ground" else 1)
    assert [im.prim_base for im in dp.inst] \
        == [js.n_tris + js.spheres.count]
    for a, b in zip(dp.inst, ds.inst):
        assert torch.equal(a.attr, b.attr) and torch.equal(a.nrm, b.nrm)
    assert not dp.composed_only


def test_transformed_json_parses_as_jax(tmp_path):
    """A "Transformed" over a Mesh: one instanced mesh of two placements,
    the mesh's own transform composed first."""
    obj = tmp_path / "quad.obj"
    obj.write_text("v -1 -1 0\nv 1 -1 0\nv 1 1 0\nv -1 1 0\n"
                   "f 1 2 3\nf 1 3 4\n")
    t1 = [[2, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0], [-1.6, 0, 0, 1]]
    t2 = [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0], [1.6, 0.5, 0, 1]]
    desc = {
        "lights": [{"Point": {"position": [0, 0, 5],
                              "intensity": [30, 30, 30]}}],
        "components": [
            {"name": "quad", "value": {"Mesh": {
                "filename": str(obj), "transform": t1}}},
            {"name": "quad2", "value": {"Transformed": {
                "original": "quad", "transform": t2}}},
            {"name": "ball", "value": {"Shaped": {
                "shape": {"Sphere": {"radius": 0.5, "zmin": -1.0,
                                     "zmax": 1.0, "phimax": 6.28}},
                "material": {"name": "m", "value": {"Matte": {
                    "kd": {"name": "kd", "value": {"Constant": {
                        "value": {"inner": [0.5, 0.5, 0.5]}}}},
                    "sigma": {"name": "s", "value": {"Constant": {
                        "value": 0.0}}}}}}}}},
            {"name": "ball2", "value": {"Transformed": {
                "original": "ball", "transform": t2}}},
        ],
        "camera": {
            "screen": {"pmin": {"x": -1, "y": -1},
                       "pmax": {"x": 1, "y": 1}},
            "fov": 1.2,
            "transform": np.asarray(jtf.look_at(
                [0, 0, 6.0], [0, 0, 0.0], [0, 1, 0.0])).tolist(),
            "film": {"resolution": {"x": 24, "y": 24},
                     "filter_radius": {"x": 0.5, "y": 0.5}}},
        "max_depth": 2,
        "outputfilename": "out.png",
    }
    path = tmp_path / "scene.json"
    path.write_text(json.dumps(desc))
    js, *_ = jsd.parse_scene(str(path))
    ts, *_ = tsd.parse_scene(str(path))
    _scene_equal(js, ts)
    assert ts.n_tris == 0 and ts.spheres.count == 2
    assert ts.inst[0].n_instances == 2
    np.testing.assert_array_equal(
        ts.inst[0].o2w[1], np.asarray(t1, np.float32)
        @ np.asarray(t2, np.float32))


def test_cb_inst_parses_as_jax():
    path = os.path.join(REPO, "examples/cornellbox/cb_inst.json")
    js, *_ = jsd.parse_scene(path)
    ts, *_ = tsd.parse_scene(path)
    _scene_equal(js, ts)
    im = ts.inst[0]
    assert ts.n_tris == 0 and len(ts.inst) == 1
    assert im.n_instances == 100 and im.attr.shape[0] == 1112
    assert ts.spheres.count == 200 and ts.lights.ltype.shape[0] == 200
    # the grid's transforms are affine: nothing in the projective column
    np.testing.assert_array_equal(im.o2w[:, :3, 3], 0.0)


def _close(a, r, m, what, rtol=QUERY_TOL, atol=QUERY_TOL):
    np.testing.assert_allclose(np.asarray(a)[m], np.asarray(r)[m],
                               rtol=rtol, atol=atol, err_msg=what)


@pytest.mark.parametrize("variant", VARIANTS)
def test_scene_queries_match_jax(scenes, variant, monkeypatch):
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)
    js, _, ds = scenes[variant]
    o, d, tmax = _rays(3)
    # with no world triangle JAX tests its spheres in XLA, with
    # multiply-add contraction: ill-conditioned lanes may split
    ok = ~_ill_conditioned(js.spheres, o, d)
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    to, td = torch.tensor(o), torch.tensor(d)
    splits = []

    def eq(a, r, what):
        a, r = np.asarray(a), np.asarray(r)
        split = a != r
        if split.ndim > 1:
            split = split.any(-1)
        assert not (split & ok).any(), (what, np.nonzero(split & ok)[0])
        splits.append(split)

    raw_j = jsc.intersect_raw(js, jo, jd)
    raw_t = integ.intersect_raw(ds, to, td)
    for k in ("hit", "is_sphere"):
        eq(raw_t[k].numpy(), raw_j[k], k)
    hit = ok & np.asarray(raw_j["hit"])
    is_s = hit & np.asarray(raw_j["is_sphere"])
    tri = hit & ~is_s
    assert tri.sum() > N // 4
    assert (variant != "sphere") or is_s.sum() > 10
    _close(raw_t["t"].numpy(), raw_j["t"], hit, "raw t", atol=0.0)
    _close(raw_t["trow"].numpy(), raw_j["trow"], tri, "trow", rtol=0.0)
    _close(raw_t["p_local"].numpy(), raw_j["p_local"], is_s, "p_local",
           rtol=0.0)

    hit_j = jsc.intersect(js, jo, jd, tmax=jnp.asarray(tmax))
    hit_t = tsc.intersect(ds, to, td, tmax=torch.tensor(tmax))
    for k in ("hit", "prim", "mat_id", "light_id"):
        eq(getattr(hit_t, k).numpy(), getattr(hit_j, k), k)
    h = ok & np.asarray(hit_j.hit)
    inst = h & (np.asarray(hit_j.prim) >= js.n_tris + js.spheres.count)
    assert inst.sum() > N // 8
    _close(hit_t.t.numpy(), hit_j.t, h, "t", atol=0.0)
    for k in ("pos", "uv", "ng", "ns", "dpdu", "dpdv", "pos_err"):
        _close(getattr(hit_t, k).numpy(), getattr(hit_j, k), h, k,
               rtol=0.0)

    hit_l, light_l = integ.intersect_light(ds, to, td)
    hit_f = jsc.intersect(js, jo, jd)
    eq(hit_l.numpy(), hit_f.hit, "intersect_light hit")
    eq(light_l.numpy(), hit_f.light_id, "intersect_light light_id")

    b_j = jsc.occluded(js, jo, jd, jnp.asarray(tmax))
    b_t = tsc.occluded(ds, to, td, torch.tensor(tmax))
    eq(b_t.numpy(), b_j, "occluded")
    assert 0.1 < b_t.numpy()[ok].mean() < 0.95
    assert np.any(splits, 0).sum() <= SPLIT_BUDGET


def _light_rays(n=N, seed=4):
    """Rays from the camera side aimed at points of the sphere light."""
    rng = np.random.default_rng(seed)
    o = np.tile(np.array([[0.0, 0.0, 6.0]], np.float32), (n, 1))
    target = np.array([0.2, 0.5, -3.5]) + rng.uniform(-0.7, 0.7, (n, 3))
    d = target - o
    return o, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(
        np.float32)


def test_final_pass_sees_instanced_occluders(scenes, monkeypatch):
    """An instanced quad in front of the sphere light hides it from the
    final deferred-MIS pass: intersect_light reports no light there, as
    the JAX package's full scene.intersect does, and the render of the
    instanced quads equals the render of the same quads baked."""
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)
    js, _, ds = scenes["sphere"]
    o, d = _light_rays()
    hit, light = integ.intersect_light(ds, torch.tensor(o), torch.tensor(d))
    ref = jsc.intersect(js, jnp.asarray(o), jnp.asarray(d))
    ok = ~_ill_conditioned(js.spheres, o, d)
    np.testing.assert_array_equal(light.numpy()[ok],
                                  np.asarray(ref.light_id)[ok])
    # the sphere alone: every ray reaches the light
    _, light_s = integ.intersect_light(
        dataclasses.replace(ds, inst=()), torch.tensor(o), torch.tensor(d))
    hidden = (light_s.numpy() == 0) & (light.numpy() == -1)
    assert hidden.sum() > 10 and (light.numpy() == 0).sum() > 10

    baked = tsc.DeviceScene.build(
        _scene(tsc.SceneBuilder(), tmats, "sphere", baked=True), "cpu")
    camera = convert.camera_from_numpy(_jax_camera(16))
    film = tflm.FilmConfig(resolution=(16, 16),
                           filter=tfilt.FilterSpec("box", (0.5, 0.5)))
    cfg = integ.RenderConfig(max_depth=2, spp=4, sample_dx=2, sample_dy=2,
                             wave_size=16 * 16 * 4)
    img_i = integ.render(ds, camera, film, cfg).numpy()
    img_b = integ.render(baked, camera, film, cfg).numpy()
    assert img_b.max() > 0.01
    np.testing.assert_allclose(img_i, img_b, rtol=1e-4, atol=1e-5)
    # without the final pass's instanced occluders the image differs
    no_final = integ.render(ds, camera, film, dataclasses.replace(
        cfg, defer_final_mis=False)).numpy()
    assert np.abs(no_final - img_b).max() > 1e-3


def _jax_camera(res):
    from arendur_tpu.filming import camera as jcam
    pv = np.asarray(jtf.look_at([0, 0, 6.0], [0, 0, 0.0], [0, 1, 0.0]))
    return jcam.make_perspective(
        parent_view=pv, screen_min=(-1, -1), screen_max=(1, 1), znear=0.1,
        zfar=100.0, fov=1.2, lens=None, resolution=(res, res))


def test_sixteen_instances_match_baked():
    ts = [_translate(1.3 * (i % 4) - 2.0, 1.3 * (i // 4) - 2.0, -0.2 * i)
          for i in range(16)]
    di = tsc.DeviceScene.build(
        _scene(tsc.SceneBuilder(), tmats, "pure", transforms=ts), "cpu")
    db = tsc.DeviceScene.build(
        _scene(tsc.SceneBuilder(), tmats, "pure", baked=True,
               transforms=ts), "cpu")
    o, d, tmax = (torch.tensor(a) for a in _rays(5))
    o = o + torch.tensor([0.0, 0.0, 0.5])
    hi, hb = tsc.intersect(di, o, d), tsc.intersect(db, o, d)
    assert torch.equal(hi.hit, hb.hit) and hi.hit.sum() > N // 4
    m = hi.hit
    torch.testing.assert_close(hi.t[m], hb.t[m], rtol=1e-5, atol=0.0)
    torch.testing.assert_close(hi.pos[m], hb.pos[m], rtol=0.0, atol=1e-4)
    assert torch.equal(tsc.occluded(di, o, d, tmax),
                       tsc.occluded(db, o, d, tmax))
    # the batched launch over 16 x N lanes with a live count: rays past
    # it miss in every instance
    t_i, li, _ = tsc.instance_closest(di.inst[0], o, d, tmax,
                                      n_alive=torch.tensor(200))
    assert (li[200:] == -1).all() and (li[:200] >= 0).sum() > 30


def test_triangle_less_scene_renders():
    """No triangle, world or instanced: K1 / K2 test the spheres alone
    (no cluster), and the render takes the composed bounce, as the JAX
    package's _mega_eligible decides."""
    b = tsc.SceneBuilder()
    m = b.add_material(mtype=tmats.M_MATTE, kd=(0.6, 0.6, 0.6), sigma=0.0)
    b.add_sphere(1.0, -1.0, 1.0, 2 * np.pi, m)
    b.add_sphere(0.5, -0.5, 0.5, 2 * np.pi, m,
                 transform=_translate(0.0, 1.8, 1.0), emission=(8, 8, 8))
    ds = tsc.DeviceScene.build(b.build(), "cpu")
    assert ds.n_tris == 0 and not ds.inst and ds.composed_only
    assert ds.cw.shape[0] == 0

    def refuse(*args, **kwargs):
        raise AssertionError("the fused bounce ran on a triangle-less scene")
    ops = dataclasses.replace(integ.KERNEL_OPS, bounce_shade=refuse)
    film = tflm.FilmConfig(resolution=(16, 16),
                           filter=tfilt.FilterSpec("box", (0.5, 0.5)))
    cfg = integ.RenderConfig(max_depth=3, spp=4, sample_dx=2, sample_dy=2,
                             wave_size=16 * 16 * 4)
    img = integ.render(ds, convert.camera_from_numpy(_jax_camera(16)), film,
                       cfg, ops=ops).numpy()
    assert np.isfinite(img).all() and img.max() > 0.05
    # the plain any hit with no cluster: the spheres alone
    o, d, tmax = (torch.tensor(a) for a in _rays(6, 64))
    assert torch.equal(
        ci.occluded_clusters(ds.cw, ds.cbox, o, d, tmax, sph_tab=ds.ktab),
        ci.intersect_clusters(ds.cw, ds.cbox, o, d, tmax,
                              sph_tab=ds.ktab)[1] != -1)


def test_train_step_matches_baked():
    """One kd step on the instanced quads (with the ground: the fused
    bounce, K4's backward on the CPU's plain version) against the same
    quads baked: the loss and the step, finite."""
    res, spp = 12, 4
    n = res * res * spp
    camera = convert.camera_from_numpy(_jax_camera(res))
    film = tflm.FilmConfig(resolution=(res, res),
                           filter=tfilt.FilterSpec("box", (0.5, 0.5)))
    cfg = integ.RenderConfig(max_depth=3, spp=spp, sample_dx=2, sample_dy=2,
                             wave_size=n)
    target = torch.tensor(np.random.default_rng(0).uniform(
        0.0, 0.5, (res * res, 3)), dtype=torch.float32)
    out = {}
    for name, baked in (("instanced", False), ("baked", True)):
        ds = tsc.DeviceScene.build(
            _scene(tsc.SceneBuilder(), tmats, "ground", baked=baked), "cpu")
        step = tmesh.train_step_fn(ds, camera, film, cfg, lr=1e3)
        kd = torch.tensor(ds.materials.kd)
        new, loss = step(kd, target, torch.arange(n))
        out[name] = ((kd - new) / 1e3, loss)
    g_i, l_i = out["instanced"]
    g_b, l_b = out["baked"]
    assert torch.isfinite(g_i).all() and torch.isfinite(l_i)
    assert g_i.abs().max() > 0.0
    torch.testing.assert_close(l_i, l_b, rtol=1e-5, atol=0.0)
    torch.testing.assert_close(g_i, g_b, rtol=1e-3, atol=1e-7)
