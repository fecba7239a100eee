"""The composed render path against the JAX package, on the CPU: the
emission-textured Cornell box (examples/cornellbox/cb_etex.json) as
both loaders read it, the full closest hit (scene.intersect), the
emission lookups, NEE with a textured emissive quad, the composed
render against arendur_tpu.render.integrator.render (which composes its
bounce on the CPU), the forced-composed Cornell box against the port's
fused path, and the CLI on cb_etex.json.  The slot sweeps K8 / K9 have
their own file (tests/test_torch_slots.py)."""

import dataclasses
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from arendur_tpu import materials as jm
from arendur_tpu import scene as jsc
from arendur_tpu.io import scenedesc as jsd
from arendur_tpu.lighting import nee as jnee
from arendur_tpu.render import integrator as jint
from arendur_tpu_torch import convert
from arendur_tpu_torch import materials as tm
from arendur_tpu_torch import scene as tsc
from arendur_tpu_torch.io import scenedesc as tsd
from arendur_tpu_torch.lighting import nee as tnee
from arendur_tpu_torch.render import integrator as tint

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CB = os.path.join(REPO, "examples/cornellbox/cb.json")
CB_ETEX = os.path.join(REPO, "examples/cornellbox/cb_etex.json")
PIXEL_ATOL = 3e-3      # per pixel, the JAX package's split-vs-composed gate
FUSED_ATOL = 2e-3      # tests/test_pallas_shade.py, fused vs composed
HIT_TOL = 1e-5


@pytest.fixture(scope="module")
def etex():
    return (jsd.parse_scene(CB_ETEX, spp_override=4,
                            resolution_override=(32, 24)),
            tsd.parse_scene(CB_ETEX, spp_override=4,
                            resolution_override=(32, 24)))


def test_cb_etex_arrays_match_jax(etex):
    (js, *_, jcfg, _), (ts, *_, tcfg, _) = etex
    jl, tl = js.lights, ts.lights
    assert (np.asarray(jl.emission_tex) >= 0).all()
    np.testing.assert_array_equal(tl.emission_tex,
                                  np.asarray(jl.emission_tex))
    np.testing.assert_array_equal(tl.emission, np.asarray(jl.emission))
    for k in ("func", "cdf"):
        np.testing.assert_allclose(
            getattr(ts.light_distribution, k),
            np.asarray(getattr(js.light_distribution, k)), rtol=1e-6)
    np.testing.assert_array_equal(tcfg.textures.texels.numpy(),
                                  np.asarray(jcfg.textures.texels))
    # the JAX scene's arrays carried through convert
    cs = convert.scene_data_from_numpy(js)
    np.testing.assert_array_equal(cs.lights.emission_tex, tl.emission_tex)
    ds = tsc.DeviceScene.build(cs, "cpu")
    assert ds.emission_textured
    assert not tsc.DeviceScene.build(
        tsd.parse_scene(CB)[0], "cpu").emission_textured


def _hit_rays(n=1024, seed=0):
    """Rays from inside the box: toward the sphere lights, the walls and
    out of the open front (misses)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform([-1.5, -1.0, 2.5], [1.5, 2.0, 5.5], (n, 3))
    targets = np.array([[-3.0, 0.0, -4.5], [2.0, 2.0, -2.5]])
    d = rng.normal(size=(n, 3))
    d[: n // 4] = targets[0] - o[: n // 4]
    d[n // 4: n // 2] = targets[1] - o[n // 4: n // 2]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def test_intersect_matches_jax(etex):
    (js, *_), (ts, *_) = etex
    ds = tsc.DeviceScene.build(ts, "cpu")
    o, d = _hit_rays()
    ref = jsc.intersect(js, jnp.asarray(o), jnp.asarray(d))
    hit = tsc.intersect(ds, torch.tensor(o), torch.tensor(d))
    h = np.asarray(ref.hit)
    assert 0.1 < h.mean() < 0.99
    np.testing.assert_array_equal(hit.hit.numpy(), h)
    for k in ("prim", "mat_id", "light_id"):
        np.testing.assert_array_equal(getattr(hit, k).numpy(),
                                      np.asarray(getattr(ref, k)), k)
    sph_lanes = h & (np.asarray(ref.prim) >= js.n_tris)
    assert sph_lanes.sum() > 50
    for k in ("t", "pos", "pos_err", "ng", "ns", "dpdu", "dpdv", "uv"):
        a, r = getattr(hit, k).numpy(), np.asarray(getattr(ref, k))
        np.testing.assert_allclose(a, r, rtol=HIT_TOL, atol=HIT_TOL,
                                   err_msg=k)


def _quad_scene(builder):
    """tests/test_emission_tex.py's emissive quad (left half of its
    profile white, right half black) over a diffuse floor."""
    m = builder.add_material(mtype=0, kd=(0.8, 0.8, 0.8))
    img = np.zeros((8, 8, 3), np.float32)
    img[:, :4, :] = 1.0
    tex = builder.atlas.add_image(img)
    quad_v = np.asarray([[0, 0, 2], [1, 0, 2], [1, 1, 2], [0, 1, 2]],
                        np.float32)
    builder.add_mesh(quad_v, np.asarray([[0, 2, 1], [0, 3, 2]]), m,
                     uvs=np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]],
                                    np.float32),
                     emission=(4.0, 4.0, 4.0), emission_tex=tex,
                     emission_tex_mean=float(img.mean()))
    floor_v = np.asarray([[-4, -4, 0], [5, -4, 0], [5, 5, 0], [-4, 5, 0]],
                         np.float32)
    builder.add_mesh(floor_v, np.asarray([[0, 1, 2], [0, 2, 3]]), m)
    return builder.build(), builder.build_textures()


def test_light_emission_with_texture():
    js, jtex = _quad_scene(jsc.SceneBuilder())
    ts, ttex = _quad_scene(tsc.SceneBuilder())
    ds = tsc.DeviceScene.build(ts, "cpu")
    rng = np.random.default_rng(0)
    uv = rng.uniform(size=(512, 2)).astype(np.float32)
    lidx = rng.integers(-1, 2, 512).astype(np.int32)
    ref = np.asarray(jsc.light_emission(js.lights, jnp.asarray(lidx),
                                        jnp.asarray(uv), jtex))
    le = tsc.light_emission(ds, torch.tensor(lidx), torch.tensor(uv),
                            ttex).numpy()
    np.testing.assert_allclose(le, ref, rtol=1e-6, atol=1e-6)
    # the bright and the dark half of the profile
    two = tsc.light_emission(ds, torch.zeros(2, dtype=torch.int32),
                             torch.tensor([[0.25, 0.5], [0.75, 0.5]]),
                             ttex).numpy()
    assert two[0, 0] > 3.5 and two[1, 0] < 0.5
    np.testing.assert_array_equal(
        tsc.light_emission(ds, torch.tensor(lidx), torch.tensor(uv)).numpy(),
        np.asarray(js.lights.emission)[np.maximum(lidx, 0)])


def test_uniform_sample_one_light_sees_profile():
    """NEE from a floor point below the textured quad (the JAX
    package's test_nee_sees_profile) against nee.uniform_sample_one_light
    of the JAX package, with and without the texture."""
    js, jtex = _quad_scene(jsc.SceneBuilder())
    ts, ttex = _quad_scene(tsc.SceneBuilder())
    ds = tsc.DeviceScene.build(ts, "cpu")
    n = 256
    tile = lambda v, dt=np.float32: np.tile(np.asarray([v], dt), (n, 1))
    f = dict(hit=np.ones(n, bool), t=np.ones(n, np.float32),
             prim=np.full(n, 2, np.int32), pos=tile([0.5, 0.5, 0.0]),
             pos_err=tile([0.0, 0.0, 0.0]), ng=tile([0.0, 0.0, 1.0]),
             ns=tile([0.0, 0.0, 1.0]), dpdu=tile([1.0, 0.0, 0.0]),
             dpdv=tile([0.0, 1.0, 0.0]), uv=tile([0.0, 0.0]),
             mat_id=np.zeros(n, np.int32), light_id=np.full(n, -1, np.int32))
    jhit = jsc.Hit(**{k: jnp.asarray(v) for k, v in f.items()})
    thit = tsc.Hit(**{k: torch.tensor(v) for k, v in f.items()})
    jb = jm.compute_scattering(js.materials, jhit.mat_id, jhit.ns, jhit.ng,
                               jhit.dpdu)
    tb = tm.compute_scattering(ts.materials, ds.mtab, thit.mat_id, thit.ns,
                               thit.ng, thit.dpdu)
    rng = np.random.default_rng(0)
    u_sel = rng.uniform(size=n).astype(np.float32)
    u_l = rng.uniform(size=(n, 2)).astype(np.float32)
    means = {}
    for name, jt, tt in (("tex", jtex, ttex), ("const", None, None)):
        ref, ref_l, _ = jnee.uniform_sample_one_light(
            js, jhit, jb, jnp.asarray(tile([0.0, 0.0, 1.0])),
            jnp.asarray(u_sel), jnp.asarray(u_l), textures=jt)
        out, lidx, _ = tnee.uniform_sample_one_light(
            ds, thit, tb, torch.tensor(tile([0.0, 0.0, 1.0])),
            torch.tensor(u_sel), torch.tensor(u_l), textures=tt)
        np.testing.assert_array_equal(lidx.numpy(), np.asarray(ref_l))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                   rtol=1e-4, atol=1e-6)
        means[name] = float(out.mean())
    # the profile blacks out half the quad
    assert 0.3 * means["const"] < means["tex"] < 0.75 * means["const"]


def _port_cfg(jcfg, textures):
    return tint.RenderConfig(
        max_depth=jcfg.max_depth, rr_threshold=jcfg.rr_threshold,
        spp=jcfg.spp, sample_dx=jcfg.sample_dx, sample_dy=jcfg.sample_dy,
        seed=jcfg.seed, wave_size=jcfg.wave_size, textures=textures,
        tex_filter=jcfg.tex_filter)


def test_composed_cb_etex_matches_jax(etex):
    (js, jcam, jfilm, jcfg, _), (ts, tcam, tfilm, tcfg, _) = etex
    jcfg = dataclasses.replace(jcfg, max_depth=3)
    ref = np.asarray(jint.render(js, jcam, jfilm, jcfg))
    tcfg = dataclasses.replace(tcfg, max_depth=3)
    img = tint.render(tsc.DeviceScene.build(ts, "cpu"), tcam, tfilm,
                      tcfg).numpy()
    assert np.isfinite(img).all() and ref.max() > 0.01
    print(f"cb_etex composed: max |port - jax| {np.abs(img - ref).max():.3e}"
          f", mean |ref| {np.abs(ref).mean():.3e}")
    np.testing.assert_allclose(img, ref, rtol=0.0, atol=PIXEL_ATOL)


@pytest.mark.parametrize("textured", [False, True])
def test_forced_composed_matches_fused(textured):
    """cb.json through the composed bounce against the fused path; with
    the checkerboard kd texture, against the textured split (the
    composed bounce's material lookups and cone carry)."""
    ts, tcam, tfilm, tcfg, _ = tsd.parse_scene(
        CB, spp_override=4, resolution_override=(32, 24))
    tcfg = dataclasses.replace(tcfg, max_depth=3)
    if textured:
        from arendur_tpu_torch.render import fuzz
        ts, atlas = fuzz.checker_textured(ts)
        tcfg = dataclasses.replace(tcfg, textures=atlas)
    ds = tsc.DeviceScene.build(ts, "cpu")
    fused = tint.render(ds, tcam, tfilm, tcfg).numpy()
    comp = tint.render(ds, tcam, tfilm, tcfg, composed=True).numpy()
    assert fused.max() > 0.05
    print(f"cb composed vs fused (textured {textured}): max |diff| "
          f"{np.abs(comp - fused).max():.3e}")
    np.testing.assert_allclose(comp, fused, rtol=0.0, atol=FUSED_ATOL)


def test_cli_renders_cb_etex(tmp_path):
    from arendur_tpu_torch import cli
    out = str(tmp_path / "etex.png")
    assert cli.main([CB_ETEX, "--device", "cpu", "--res", "32x24", "--spp",
                     "4", "--depth", "3", "-o", out]) == 0
    from PIL import Image
    assert Image.open(out).size == (32, 24)
