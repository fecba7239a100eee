"""The textured render path as a whole, on the CPU: the port's render
(plain versions of K1, K2, K5 and K6, texel lookups in PyTorch) against
arendur_tpu.render.integrator.render on its default CPU path, same
scene, same seed, for a textured quad with a sphere and for the Cornell
box with a checkerboard kd texture on every matte material (the
textured leg of bench.py, cut to a small size).  Plus the ray cone's
curvature option, on and off against JAX, and its inertness on
untextured scenes."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from arendur_tpu import scene as jsc
from arendur_tpu.filming import camera as jcam
from arendur_tpu.filming import film as jflm
from arendur_tpu.geometry import transform as jtf
from arendur_tpu.io import scenedesc as jsd
from arendur_tpu.render import integrator as jint
from arendur_tpu.sampling import filters as jfilt
from arendur_tpu.texturing import texture as jtx
from arendur_tpu_torch import convert
from arendur_tpu_torch import scene as tsc
from arendur_tpu_torch.io import scenedesc as tsd
from arendur_tpu_torch.render import fuzz
from arendur_tpu_torch.render import integrator as tint

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CB = os.path.join(REPO, "examples/cornellbox/cb.json")
# per pixel: the JAX package's own gate between its split and composed
# textured paths (tests/test_cbounce.py TestTexturedSplitPath)
PIXEL_ATOL = 3e-3


def _quad_scene(builder, glass_ball=False):
    """Camera staring at a kd-textured quad, a point light and a matte
    sphere (tests/test_cbounce.py _textured_quad_scene); glass_ball puts
    a glass sphere between camera and quad instead."""
    rng = np.random.RandomState(0)
    img = rng.uniform(0.2, 0.9, (8, 8, 3)).astype(np.float32)
    tex_id = builder.atlas.add_image(img, wrap=2, gamma=False)
    m = builder.add_material(mtype=0, kd=(1.0, 1.0, 1.0), sigma=0.0,
                             kd_tex=tex_id)
    if glass_ball:
        ms = builder.add_material(mtype=2, ks=(1.0, 1.0, 1.0), eta=1.5)
        place = (0.0, 0.0, 1.2)
    else:
        ms = builder.add_material(mtype=0, kd=(0.6, 0.5, 0.4), sigma=0.0)
        place = (0.8, 0.0, 0.7)
    v = np.array([[-2, -2, 0], [2, -2, 0], [2, 2, 0], [-2, 2, 0]],
                 np.float32)
    f = np.array([[0, 1, 2], [0, 2, 3]], np.int64)
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    builder.add_mesh(v, f, m, uvs=uv)
    builder.add_sphere(radius=0.5, zmin=-0.5, zmax=0.5,
                       phimax=2.0 * np.pi, mat_id=ms,
                       transform=np.array([[1, 0, 0, 0], [0, 1, 0, 0],
                                           [0, 0, 1, 0], place + (1,)],
                                          np.float32))
    builder.add_point_light((0, 0, 3.0), (20.0, 20.0, 20.0))
    return builder.build(), builder.build_textures()


def _quad_view(spp=4, depth=2):
    pv = np.asarray(jtf.look_at([0, 0, 2.5], [0, 0, 0.0], [0, 1, 0.0]))
    camera = jcam.make_perspective(
        parent_view=pv, screen_min=(-1, -1), screen_max=(1, 1),
        znear=0.1, zfar=100.0, fov=1.2, lens=None, resolution=(16, 16))
    film_cfg = jflm.FilmConfig(
        resolution=(16, 16), filter=jfilt.FilterSpec("box", (0.5, 0.5)))
    config = jint.RenderConfig(max_depth=depth, spp=spp, sample_dx=2,
                               sample_dy=spp // 2, wave_size=16 * 16 * spp,
                               rr_threshold=0.0)
    return camera, film_cfg, config


def _port_config(jcfg, textures, **changes):
    return tint.RenderConfig(
        max_depth=jcfg.max_depth, rr_threshold=jcfg.rr_threshold,
        spp=jcfg.spp, sample_dx=jcfg.sample_dx, sample_dy=jcfg.sample_dy,
        seed=jcfg.seed, wave_size=jcfg.wave_size, textures=textures,
        tex_filter=jcfg.tex_filter, **changes)


def test_textured_quad_matches_jax():
    js, jtex = _quad_scene(jsc.SceneBuilder())
    camera, film_cfg, config = _quad_view()
    ref = np.asarray(jint.render(js, camera, film_cfg,
                                 dataclasses.replace(config,
                                                     textures=jtex)))
    ts, ttex = _quad_scene(tsc.SceneBuilder())
    img = tint.render(tsc.DeviceScene.build(ts, "cpu"),
                      convert.camera_from_numpy(camera),
                      convert.film_from_numpy(film_cfg),
                      _port_config(config, ttex)).numpy()
    assert np.isfinite(img).all() and ref.max() > 0.01
    print(f"textured quad: max |port - jax| {np.abs(img - ref).max():.3e}")
    np.testing.assert_allclose(img, ref, rtol=0.0, atol=PIXEL_ATOL)


def test_checker_cornell_matches_jax():
    js, jcam_, jfilm, jcfg, _ = jsd.parse_scene(
        CB, spp_override=4, resolution_override=(32, 24))
    ab = jtx.AtlasBuilder()
    tid = ab.add_image(fuzz.checker_image())
    jatlas = ab.build()
    mt = js.materials
    kd_tex = np.where(np.asarray(mt.mtype) == 0, tid,
                      np.asarray(mt.kd_tex)).astype(np.int32)
    js = js.replace(materials=mt.replace(kd_tex=kd_tex))
    jcfg = dataclasses.replace(jcfg, max_depth=3, textures=jatlas)
    ref = np.asarray(jint.render(js, jcam_, jfilm, jcfg))

    ts, tcam, tfilm, tcfg, _ = tsd.parse_scene(
        CB, spp_override=4, resolution_override=(32, 24))
    ts, tatlas = fuzz.checker_textured(ts)
    tcfg = dataclasses.replace(tcfg, max_depth=3, textures=tatlas)
    img = tint.render(tsc.DeviceScene.build(ts, "cpu"), tcam, tfilm,
                      tcfg).numpy()
    assert np.isfinite(img).all() and ref.max() > 0.05
    print(f"checker Cornell: max |port - jax| {np.abs(img - ref).max():.3e}")
    np.testing.assert_allclose(img, ref, rtol=0.0, atol=PIXEL_ATOL)


def test_cone_curvature_plumbs_through_and_untextured_is_inert():
    """The curvature option reaches the render of a textured quad seen
    through a glass ball, on and off each within PIXEL_ATOL of the JAX
    render with the same setting, and the cone fields change nothing on
    an untextured render (the port's form of tests/test_conelod.py's
    test_cone_spread_growth_rule)."""
    ts, ttex = _quad_scene(tsc.SceneBuilder(), glass_ball=True)
    js, jtex = _quad_scene(jsc.SceneBuilder(), glass_ball=True)
    camera, film_cfg, config = _quad_view(spp=2, depth=3)
    ds = tsc.DeviceScene.build(ts, "cpu")
    tc, tf = (convert.camera_from_numpy(camera),
              convert.film_from_numpy(film_cfg))
    imgs = {on: tint.render(ds, tc, tf, _port_config(
        config, ttex, cone_curvature=on)).numpy() for on in (True, False)}
    assert all(np.isfinite(v).all() for v in imgs.values())
    assert np.abs(imgs[True] - imgs[False]).max() > 0.0
    for on, img in imgs.items():
        ref = np.asarray(jint.render(js, camera, film_cfg, dataclasses.replace(
            config, textures=jtex, cone_curvature=on)))
        print(f"glass ball, cone_curvature={on}: max |port - jax| "
              f"{np.abs(img - ref).max():.3e}")
        np.testing.assert_allclose(img, ref, rtol=0.0, atol=PIXEL_ATOL)
    plain = [tint.render(ds, tc, tf, _port_config(
        config, None, cone_curvature=on)).numpy() for on in (True, False)]
    np.testing.assert_array_equal(plain[0], plain[1])
    assert plain[0].max() > 0.01


def test_curvature_rule():
    """gamma' = gamma + 2 w / r after a specular bounce off a sphere of
    radius r; unchanged elsewhere and with the option off."""
    ts, _ = _quad_scene(tsc.SceneBuilder(), glass_ball=True)
    ds = tsc.DeviceScene.build(ts, "cpu")
    g = torch.tensor([0.01, 0.01, 0.01, 0.01])
    w = torch.tensor([0.2, 0.2, 0.2, 0.2])
    is_sph = torch.tensor([True, True, False, True])
    spec = torch.tensor([True, False, True, True])
    s_idx = torch.zeros(4, dtype=torch.int64)
    cfg = tint.RenderConfig()
    out = tint.curv_spread(ds, cfg, g, is_sph, s_idx, w, spec & is_sph)
    r = float(ts.spheres.radius[0])
    expect = torch.tensor([0.01 + 2 * 0.2 / r, 0.01, 0.01,
                           0.01 + 2 * 0.2 / r])
    torch.testing.assert_close(out, expect)
    off = tint.curv_spread(ds, dataclasses.replace(cfg,
                                                   cone_curvature=False),
                           g, is_sph, s_idx, w, spec)
    assert torch.equal(off, g)


def test_cli_renders_textured_scene(tmp_path):
    from arendur_tpu_torch import cli
    out = str(tmp_path / "quad.png")
    rc = cli.main([os.path.join(REPO, "examples/texturedquad/quad.json"),
                   "--device", "cpu", "--res", "16x12", "--spp", "1",
                   "--depth", "2", "-o", out])
    assert rc == 0
    from PIL import Image
    assert Image.open(out).size == (16, 12)
