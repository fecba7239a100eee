"""The modules the port's BPT renderer runs on, against the JAX package
on the CPU, and the renderer's energy gates.

* lighting/emission.py generate_path, pdf_dir_at and pdf_origin for all
  five light types (the all-branches scene of render/fuzz.py: a
  triangle, a partial sphere, point, spot and distant lights), and
  generate_path with emission textures (cb_etex.json's sphere lights, a
  textured triangle light): within EMI_TOL (measured: 1.1e-5 on
  cb_etex's textured radiance, 7.9e-6 on the spot's radiance of 8,
  4.8e-7 on positions);
* lighting/nee.py light_sample's light normal nl (need_nl);
* filming/importance.py on cb.json's pinhole camera and on a thin-lens
  camera: We, pdf, lens point, raster position (the view -> raster
  inverse is taken once per camera; measured: praster within 3.8e-6 px
  of JAX's per-call float32 inverse), within IMP_TOL;
* filming/film.py's splat plane (film_add_splat, film_finalize with
  splat_scale) against JAX's, crop window and mask included;
* the energy gates of tests/test_bpt.py (port only, plain PyTorch): BPT
  against PT energy on three scenes each dominated by another strategy
  class, with the class shares calibrated there (s = 0: > 0.99; s = 1 /
  t = 1: 0.53 / 0.47, measured here 0.526 / 0.466; s >= 2: > 0.4),
  the BPT image against the PT image on the diffuse scene, and a point
  light scene;
* BPT and Whitted on the emission-textured and the instanced Cornell
  box (finite images with light in them);
* the CLI: --renderer bpt and whitted on the CPU (the refusals that
  stay: tests/test_torch_render.py).
"""

import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from arendur_tpu import scene as jsc
from arendur_tpu.filming import film as jflm
from arendur_tpu.filming import importance as jimp
from arendur_tpu.io import scenedesc as jsd
from arendur_tpu.lighting import emission as jemi
from arendur_tpu.lighting import nee as jnee
from arendur_tpu_torch import convert
from arendur_tpu_torch import scene as tsc
from arendur_tpu_torch.filming import camera as tcam
from arendur_tpu_torch.filming import film as tflm
from arendur_tpu_torch.filming import importance as timp
from arendur_tpu_torch.geometry import transform as ttf
from arendur_tpu_torch.io import scenedesc as tsd
from arendur_tpu_torch.lighting import emission as temi
from arendur_tpu_torch.lighting import nee as tnee
from arendur_tpu_torch.render import bpt as tbpt
from arendur_tpu_torch.render import fuzz
from arendur_tpu_torch.render import integrator as tint
from arendur_tpu_torch.sampling import filters as tfilt
from arendur_tpu_torch.sampling import sampler as tsmp

import torch_bpt_common as common

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CB_ETEX = os.path.join(REPO, "examples/cornellbox/cb_etex.json")
EMI_TOL = 1e-5
IMP_TOL = 1e-5
N = 2048


def _quad_light(builder):
    """A textured triangle light (tests/test_emission_tex.py's quad:
    the left half of its profile white, the right half black) over a
    floor."""
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


def _emission_scene(name):
    """(JAX scene, JAX atlas, port DeviceScene, port atlas)."""
    if name == "all-branches":
        return (fuzz.all_branches_scene(jsc.SceneBuilder()), None,
                tsc.DeviceScene.build(
                    fuzz.all_branches_scene(tsc.SceneBuilder()), "cpu"),
                None)
    if name == "textured quad":
        js, jtex = _quad_light(jsc.SceneBuilder())
        ts, ttex = _quad_light(tsc.SceneBuilder())
        return js, jtex, tsc.DeviceScene.build(ts, "cpu"), ttex
    js, *_, jcfg, _ = jsd.parse_scene(CB_ETEX)
    ts, *_, tcfg, _ = tsd.parse_scene(CB_ETEX)
    return js, jcfg.textures, tsc.DeviceScene.build(ts, "cpu"), \
        tcfg.textures


def _draws(n_lights, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.uniform(size=s).astype(np.float32)  # noqa: E731
    return rng.integers(0, n_lights, N).astype(np.int32), f(N, 2), f(N, 2)


@pytest.mark.parametrize("name", ["all-branches", "textured quad",
                                  "cb_etex"])
def test_generate_path_matches_jax(name):
    js, jtex, ds, ttex = _emission_scene(name)
    lidx, up, ud = _draws(js.lights.count)
    ref = jemi.generate_path(js, jnp.asarray(lidx), jnp.asarray(up),
                             jnp.asarray(ud), textures=jtex)
    got = temi.generate_path(ds, torch.tensor(lidx), torch.tensor(up),
                             torch.tensor(ud), textures=ttex)
    lt = np.asarray(js.lights.ltype)[lidx]
    if name == "all-branches":
        assert set(lt.tolist()) == {0, 1, 2, 3, 4}
    for k in ("pos", "dir", "n", "le", "pdf_pos", "pdf_dir"):
        a, b = got[k].numpy(), np.asarray(ref[k])
        print(f"{name} {k}: max |d| {np.abs(a - b).max():.3e}")
        np.testing.assert_allclose(a, b, rtol=EMI_TOL, atol=EMI_TOL,
                                   err_msg=k)
    if ttex is not None:
        # the profile modulates the emission
        plain = temi.generate_path(ds, torch.tensor(lidx), torch.tensor(up),
                                   torch.tensor(ud))["le"].numpy()
        assert np.abs(got["le"].numpy() - plain).max() > 0.1


def test_pdf_dir_at_and_origin_match_jax():
    js, _, ds, _ = _emission_scene("all-branches")
    lidx, _, _ = _draws(js.lights.count, seed=1)
    rng = np.random.default_rng(2)
    unit = lambda v: (v / np.linalg.norm(v, axis=-1, keepdims=True)  # noqa
                      ).astype(np.float32)
    w, nl = unit(rng.normal(size=(N, 3))), unit(rng.normal(size=(N, 3)))
    # aim a third of the directions along the spot's axis (inside its
    # cone)
    spot = np.asarray(js.lights.ltype)[lidx] == jsc.L_SPOT
    axis = unit(np.asarray(js.lights.aux)[lidx])
    w = np.where((spot & (np.arange(N) % 3 == 0))[:, None], axis, w)
    ref = jemi.pdf_dir_at(js, jnp.asarray(lidx), jnp.asarray(nl),
                          jnp.asarray(w))
    got = temi.pdf_dir_at(ds, torch.tensor(lidx), torch.tensor(nl),
                          torch.tensor(w))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (got.numpy()[spot] > 0).any()
    np.testing.assert_array_equal(
        temi.pdf_origin(ds, torch.tensor(lidx)).numpy(),
        np.asarray(jemi.pdf_origin(js, jnp.asarray(lidx))))


def test_light_sample_normal_matches_jax():
    js, _, ds, _ = _emission_scene("all-branches")
    lidx, u2, _ = _draws(js.lights.count, seed=3)
    pos = np.random.default_rng(4).uniform(-2, 2, (N, 3)).astype(np.float32)
    ref = jnee.light_sample(js, jnp.asarray(lidx), jnp.asarray(pos),
                            jnp.asarray(u2))
    got = tnee.light_sample(ds, torch.tensor(lidx), torch.tensor(pos),
                            torch.tensor(u2), need_nl=True)
    for k in ("nl", "pfrom", "wi"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=EMI_TOL, atol=EMI_TOL, err_msg=k)
    assert "nl" not in tnee.light_sample(ds, torch.tensor(lidx),
                                         torch.tensor(pos),
                                         torch.tensor(u2))


def _cameras():
    """cb.json's pinhole camera and a thin-lens one, JAX's and the
    port's, at 32x24."""
    res = (32, 24)
    _, jc, *_ = jsd.parse_scene(common.CB, resolution_override=res)
    from arendur_tpu.filming import camera as jcam
    from arendur_tpu.geometry import transform as jtf
    pv = np.asarray(jtf.look_at([0.0, 1.0, -1.0], [0.0, 0.5, 4.0],
                                [0.0, 1.0, 0.0]))
    kw = dict(parent_view=pv, screen_min=(-1, -0.75), screen_max=(1, 0.75),
              znear=0.1, zfar=100.0, fov=0.9, lens=(0.2, 5.0),
              resolution=res)
    return res, [(jc, convert.camera_from_numpy(jc)),
                 (jcam.make_perspective(**kw),
                  tcam.make_perspective(**dict(
                      kw, parent_view=ttf.look_at([0.0, 1.0, -1.0],
                                                  [0.0, 0.5, 4.0],
                                                  [0.0, 1.0, 0.0]))))]


@pytest.mark.parametrize("which", [0, 1], ids=["pinhole", "thin lens"])
def test_importance_matches_jax(which):
    res, cams = _cameras()
    jc, tc = cams[which]
    rng = np.random.default_rng(5)
    p = rng.uniform([-1.5, -1.0, 2.5], [1.5, 2.0, 5.5], (N, 3)) \
        .astype(np.float32)
    u2 = rng.uniform(size=(N, 2)).astype(np.float32)
    ref = jimp.importance_sample(jc, jnp.asarray(p), jnp.asarray(u2), res)
    got = timp.importance_sample(tc, torch.tensor(p), torch.tensor(u2), res)
    valid = np.asarray(ref["valid"])
    assert 0.3 < valid.mean() and (got["valid"].numpy() == valid).all()
    for k in ("we", "pdf", "pcam", "wi", "praster"):
        a, b = got[k].numpy(), np.asarray(ref[k])
        if k == "praster":
            a, b = a[valid], b[valid]
            print(f"max |praster - JAX| {np.abs(a - b).max():.3e} px")
        np.testing.assert_allclose(a, b, rtol=IMP_TOL, atol=IMP_TOL,
                                   err_msg=k)
    w = -got["wi"]
    pp, pd = timp.importance_pdf(tc, got["pcam"], w, res)
    jpp, jpd = jimp.importance_pdf(jc, ref["pcam"], -ref["wi"], res)
    np.testing.assert_allclose(pp.numpy(), np.asarray(jpp), rtol=IMP_TOL)
    np.testing.assert_allclose(pd.numpy(), np.asarray(jpd), rtol=IMP_TOL,
                               atol=IMP_TOL)
    we, pr, ok = timp.importance_eval(tc, got["pcam"], w, res)
    jwe, jpr, jok = jimp.importance_eval(jc, ref["pcam"], -ref["wi"], res)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(we.numpy(), np.asarray(jwe), rtol=IMP_TOL)


def test_film_splat_plane_matches_jax():
    res = (16, 12)
    rng = np.random.default_rng(6)
    pr = rng.uniform([-2, -2], [18, 14], (N, 2)).astype(np.float32)
    rad = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    pfilm = rng.uniform([0, 0], [16, 12], (N, 2)).astype(np.float32)
    mask = rng.uniform(size=N) < 0.8
    from arendur_tpu.sampling import filters as jfilt
    for crop in (((0, 0), (-1, -1)), ((2, 1), (13, 10))):
        jf = jflm.FilmConfig(resolution=res,
                             filter=jfilt.FilterSpec("box", (0.5, 0.5)),
                             crop_min=crop[0], crop_max=crop[1])
        tf_ = convert.film_from_numpy(jf)
        js = jflm.film_init(jf, with_splat=True)
        js = jflm.film_splat(jf, js, jnp.asarray(pfilm), jnp.asarray(rad))
        js = jflm.film_add_splat(jf, js, jnp.asarray(pr), jnp.asarray(rad),
                                 mask=jnp.asarray(mask))
        st = tflm.film_init(tf_, "cpu", with_splat=True)
        tflm.film_splat(tf_, st, torch.tensor(pfilm), torch.tensor(rad))
        tflm.film_add_splat(tf_, st, torch.tensor(pr), torch.tensor(rad),
                            mask=torch.tensor(mask))
        np.testing.assert_allclose(st.splat.numpy(), np.asarray(js.splat),
                                   rtol=1e-5, atol=1e-6)
        for scale in (0.0, 0.25):
            np.testing.assert_allclose(
                tflm.film_finalize(st, tf_, splat_scale=scale).numpy(),
                np.asarray(jflm.film_finalize(js, jf, splat_scale=scale)),
                rtol=1e-5, atol=1e-6)
    # a film without the plane gains one at its first splat
    st = tflm.film_init(tf_, "cpu")
    assert st.splat is None
    tflm.film_add_splat(tf_, st, torch.tensor(pr), torch.tensor(rad))
    assert st.splat.shape == (res[0] * res[1], 3)


# ---- the energy gates (tests/test_bpt.py, port only) ----------------------

def _emitter_in_view():
    b = tsc.SceneBuilder()
    lm = b.add_material(mtype=0, kd=(0, 0, 0), sigma=0.0)
    v = np.array([[-3, 1, -1], [3, 1, -1], [3, 1, 4], [-3, 1, 4]],
                 np.float32)
    b.add_mesh(v, np.array([[0, 1, 2], [0, 2, 3]]), lm,
               emission=(4.0, 4.0, 4.0))
    return b.build()


def _hidden_light():
    b = tsc.SceneBuilder()
    m = b.add_material(mtype=0, kd=(0.75, 0.75, 0.75), sigma=0.0)
    f2 = np.array([[0, 1, 2], [0, 2, 3]])
    b.add_mesh(np.array([[-4, -4, 0], [4, -4, 0], [4, 4, 0], [-4, 4, 0]],
                        np.float32), f2, m)
    b.add_mesh(np.array([[-4, 3, 0], [4, 3, 0], [4, 3, 6], [-4, 3, 6]],
                        np.float32), f2, m)
    lm = b.add_material(mtype=0, kd=(0, 0, 0), sigma=0.0)
    b.add_mesh(np.array([[-0.6, 2.5, 5.0], [0.6, 2.5, 5.0],
                         [0.0, 2.5, 5.8]], np.float32),
               np.array([[0, 2, 1]]), lm, emission=(40.0, 40.0, 40.0))
    return b.build()


def _simple(res):
    return tcam.make_perspective(
        parent_view=ttf.look_at([0, -6, 2.0], [0, 0, 0.5], [0, 0, 1.0]),
        screen_min=(-1, -0.75), screen_max=(1, 0.75), znear=0.1, zfar=100.0,
        fov=0.9, lens=None, resolution=res)


def _box_film(res):
    return tflm.FilmConfig(resolution=res,
                           filter=tfilt.FilterSpec("box", (0.5, 0.5)))


def _wave_energies(scene, res=(16, 12), spp=32, max_depth=3):
    """One BPT wave with its per-strategy collection and the matched PT
    wave (tests/test_bpt.py _wave_energies): (e_pt, e_bpt, class
    energies s0 / s1 / s2+ / t1)."""
    ds = tsc.DeviceScene.build(scene, "cpu")
    config = tint.RenderConfig(max_depth=max_depth, spp=spp, sample_dx=8,
                               sample_dy=4, wave_size=res[0] * res[1] * spp)
    n = res[0] * res[1] * spp
    ray_idx = torch.arange(n)
    pid, sid = ray_idx // spp, ray_idx % spp
    pxy = torch.stack([(pid % res[0]).float(), (pid // res[0]).float()], -1)
    key = tsmp.make_base_key(0)
    collect = {}
    camera = _simple(res)
    _, L, _, sL, sv = tbpt.trace_wave_bpt(ds, camera, config, _box_film(res),
                                          pxy, pid, sid, key,
                                          collect=collect)
    cls = {"s0": 0.0, "s1": 0.0, "s2+": 0.0, "t1": 0.0}
    for k, v in collect.items():
        if isinstance(k, tuple):
            s, t = k
            key_ = ("s0" if s == 0 else "s1" if s == 1
                    else "t1" if t == 1 else "s2+")
            cls[key_] += float(v[0].sum(-1).mean())
    e_splat = float((sL.sum(-1) * sv).sum() / n)
    _, L_pt = tint.trace_wave(ds, camera, config, pxy, pid, sid, key)
    return float(L_pt.sum(-1).mean()), float(L.sum(-1).mean()) + e_splat, \
        cls


def test_energy_s0_dominated():
    e_pt, e_bpt, cls = _wave_energies(_emitter_in_view())
    assert abs(e_bpt - e_pt) / max(e_pt, 1e-9) < 0.02, (e_pt, e_bpt)
    assert cls["s0"] / max(e_bpt, 1e-9) > 0.99, cls


def test_energy_s1_and_t1_balanced():
    e_pt, e_bpt, cls = _wave_energies(common.box_scene(tsc))
    print(f"box: e_pt {e_pt:.5f} e_bpt {e_bpt:.5f} shares "
          + ", ".join(f"{k} {v / e_bpt:.3f}" for k, v in cls.items()))
    assert abs(e_bpt - e_pt) / max(e_pt, 1e-9) < 0.08, (e_pt, e_bpt)
    s1, t1 = cls["s1"] / e_bpt, cls["t1"] / e_bpt
    assert 0.35 < s1 < 0.70 and 0.30 < t1 < 0.65, cls
    assert abs((e_bpt - cls["s1"]) - e_pt) / e_pt > 0.25
    assert abs((e_bpt - cls["t1"]) - e_pt) / e_pt > 0.20


def test_energy_s2_dominated():
    e_pt, e_bpt, cls = _wave_energies(_hidden_light())
    assert abs(e_bpt - e_pt) / max(e_pt, 1e-9) < 0.15, (e_pt, e_bpt)
    assert cls["s2+"] / max(e_bpt, 1e-9) > 0.4, cls
    assert abs((e_bpt - cls["s2+"]) - e_pt) / e_pt > 0.3


def test_bpt_image_matches_pt_on_diffuse_scene():
    res, spp = (16, 12), 64
    ds = tsc.DeviceScene.build(common.box_scene(tsc), "cpu")
    config = tint.RenderConfig(max_depth=3, spp=spp, sample_dx=8,
                               sample_dy=8, wave_size=res[0] * res[1] * spp)
    img_pt = tint.render(ds, _simple(res), _box_film(res), config).numpy()
    img = tbpt.render_bpt(ds, _simple(res), _box_film(res), config).numpy()
    assert np.isfinite(img).all() and img.max() > 0.0
    assert abs(img.mean() - img_pt.mean()) < 0.25 * max(img_pt.mean(), 1e-6)
    bright = img_pt.mean(-1) > np.percentile(img_pt.mean(-1), 50)
    rel = (np.abs(img - img_pt).mean(-1)[bright]
           / np.maximum(img_pt.mean(-1)[bright], 1e-3))
    assert np.median(rel) < 0.5, float(np.median(rel))


def test_point_light_bpt_finite():
    res = (8, 8)
    b = tsc.SceneBuilder()
    m = b.add_material(mtype=0, kd=(0.6, 0.6, 0.6), sigma=0.0)
    b.add_mesh(np.array([[-4, -4, 0], [4, -4, 0], [4, 4, 0], [-4, 4, 0]],
                        np.float32), np.array([[0, 1, 2], [0, 2, 3]]), m)
    b.add_point_light((0, 0, 3.0), (20.0, 20.0, 20.0))
    ds = tsc.DeviceScene.build(b.build(), "cpu")
    config = tint.RenderConfig(max_depth=2, spp=16, sample_dx=4, sample_dy=4,
                               wave_size=res[0] * res[1] * 16)
    img = tbpt.render_bpt(ds, _simple(res), _box_film(res), config).numpy()
    assert np.isfinite(img).all() and img.max() > 0.0


@pytest.mark.parametrize("name", ["cb_etex.json", "cb_inst.json"])
def test_bpt_and_whitted_on_other_scene_kinds(name):
    """The port's renderers on the emission-textured Cornell box (the
    light subpaths and the camera hits read the emission texture; BPT
    at 8x6, 4 spp, depth 2, and Whitted) and on the instanced one (100
    boxes, 200 sphere lights, no world triangle: every query adds the
    [I * N] launches; BPT at 2x2, 1 spp, depth 1: the plain sphere test
    loops over the 200 spheres, and Whitted, which loops over every
    light, takes ~40 s here): finite images with light in them."""
    import dataclasses
    from arendur_tpu_torch.render import whitted
    etex = name == "cb_etex.json"
    res, spp, depth = ((8, 6), 4, 2) if etex else ((2, 2), 1, 1)
    ts, tc, tf_, tcfg, _ = tsd.parse_scene(
        os.path.join(REPO, "examples/cornellbox", name), spp_override=spp,
        resolution_override=res)
    tcfg = dataclasses.replace(tcfg, max_depth=depth, sample_dx=spp // 2 or 1,
                               sample_dy=2 if spp > 1 else 1)
    ds = tsc.DeviceScene.build(ts, "cpu")
    assert ds.emission_textured if etex else len(ds.inst) == 1
    for render in (tbpt.render_bpt,) + ((whitted.render_whitted,)
                                        if etex else ()):
        img = render(ds, tc, tf_, tcfg).numpy()
        assert img.shape == (res[1], res[0], 3)
        assert np.isfinite(img).all() and img.max() > 0.0, render


# ---- the CLI --------------------------------------------------------------

@pytest.mark.parametrize("renderer", ["bpt", "whitted"])
def test_cli_renders(tmp_path, capsys, renderer):
    from arendur_tpu_torch import cli
    out = str(tmp_path / f"{renderer}.png")
    assert cli.main([common.CB, "--device", "cpu", "--renderer", renderer,
                     "--res", "8x6", "--spp", "4", "--depth", "2", "-o",
                     out]) == 0
    from PIL import Image
    assert Image.open(out).size == (8, 6)
    assert "not yet ported" not in capsys.readouterr().err
