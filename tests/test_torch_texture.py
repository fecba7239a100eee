"""The port's texturing against the JAX package, on the CPU: the atlas
build (host NumPy, equal arrays), the texture lookups (plain PyTorch,
as the JAX package runs them in XLA outside its kernels), bump mapping
and the texture-resolved material parameters, the ray-cone uv
footprint and the camera's ray differentials.  Inputs are made from a
seed with numpy and handed to both packages."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from arendur_tpu import materials as jmats
from arendur_tpu.filming import camera as jcam
from arendur_tpu.geometry import dxy as jdxy
from arendur_tpu.geometry import transform as jtf
from arendur_tpu.texturing import texture as jtx
from arendur_tpu_torch import convert
from arendur_tpu_torch import materials as tmats
from arendur_tpu_torch.filming import camera as tcam
from arendur_tpu_torch.geometry import dxy as tdxy
from arendur_tpu_torch.texturing import texture as ttx

torch.set_num_threads(2)

N = 4096
LOOKUP_ATOL = 1e-6     # texture lookups
PARAM_ATOL = 1e-5      # resolve_params / apply_bump / eval_gray
GEOM_ATOL = 1e-6       # cone footprint, ray differentials
ATLAS_FIELDS = ("texels", "offset", "width", "height", "n_levels", "wrap",
                "scale", "uv_scale", "uv_shift")


def _fill(builder, seed=0):
    """The same textures in either package's AtlasBuilder: odd and
    square sizes, gamma on and off, every wrap mode, a uv mapping, a
    product (texture x texture, texture x constant) and two mixes."""
    rng = np.random.default_rng(seed)
    img = lambda h, w: rng.uniform(0.0, 1.0, (h, w, 3)).astype(np.float32)
    a = builder.add_image(img(37, 21), wrap=jtx.WRAP_REPEAT, gamma=True)
    b = builder.add_image(img(16, 16), wrap=jtx.WRAP_BLACK, scale=0.7,
                          uv_scale=(2.0, 3.0), uv_shift=(0.25, -0.5))
    c = builder.add_image(img(5, 9), wrap=jtx.WRAP_CLAMP)
    gray = rng.integers(0, 256, (12, 7), dtype=np.uint8)
    d = builder.add_image(gray, wrap=jtx.WRAP_REPEAT)
    builder.add_product(a, tb=c)
    builder.add_product(b, const=(0.5, 0.9, 0.2))
    builder.add_mix(a, b, l=0.3)
    builder.add_mix(c, a, l_tex=d)
    return builder


@pytest.fixture(scope="module")
def atlases():
    ja = _fill(jtx.AtlasBuilder()).build()
    ta = _fill(ttx.AtlasBuilder()).build()
    return ja, ta


def test_atlas_build_equals_jax(atlases):
    ja, ta = atlases
    assert ta.count == ja.count == 8
    for k in ATLAS_FIELDS:
        a, b = np.asarray(getattr(ja, k)), getattr(ta, k).numpy()
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(b, a, err_msg=k)
    conv = convert.atlas_from_numpy(ja)
    for k in ATLAS_FIELDS + ("meta6", "tmeta"):
        assert torch.equal(getattr(conv, k), getattr(ta, k)), k


def _lanes(count, seed):
    rng = np.random.default_rng(seed)
    tex_id = rng.integers(0, count, N).astype(np.int32)
    # uv well outside [0, 1] on both sides: every wrap mode wraps
    uv = rng.uniform(-1.7, 2.3, (N, 2)).astype(np.float32)
    lod = rng.uniform(-0.5, 7.0, N).astype(np.float32)
    scale = np.exp(rng.uniform(-9.0, 0.0, (N, 1))).astype(np.float32)
    duvdx = (rng.normal(size=(N, 2)) * scale).astype(np.float32)
    duvdy = (rng.normal(size=(N, 2)) * scale
             * rng.uniform(0.05, 1.0, (N, 1))).astype(np.float32)
    return tex_id, uv, lod, duvdx, duvdy


@pytest.mark.parametrize("mode", ["level0", "lod", "duv", "ewa"])
def test_sample_texture_matches_jax(atlases, mode):
    ja, ta = atlases
    tex_id, uv, lod, duvdx, duvdy = _lanes(ta.count, 1)
    kw = {"level0": {}, "lod": dict(lod=lod),
          "duv": dict(duvdx=duvdx, duvdy=duvdy),
          "ewa": dict(duvdx=duvdx, duvdy=duvdy, filter="ewa")}[mode]
    ref = np.asarray(jtx.sample_texture(
        ja, jnp.asarray(tex_id), jnp.asarray(uv),
        **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}))
    out = ttx.sample_texture(
        ta, torch.tensor(tex_id), torch.tensor(uv),
        **{k: (torch.tensor(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}).numpy()
    assert out.shape == (N, 3) and np.isfinite(out).all()
    # the black wrap mode reaches texels outside the image
    assert (out == 0.0).all(-1).any() and (out > 0.0).any()
    if mode in ("level0", "lod"):
        # the same float32 operations in the same order as XLA's
        np.testing.assert_array_equal(out, ref)
    # with uv derivatives the lod goes through log2, whose XLA and
    # PyTorch versions differ by an ulp on some inputs
    np.testing.assert_allclose(out, ref, rtol=0.0, atol=LOOKUP_ATOL)


def test_eval_gray_and_rgb_fallback_match_jax(atlases):
    ja, ta = atlases
    tex_id, uv, _, duvdx, duvdy = _lanes(ta.count, 2)
    tex_id = np.where(np.arange(N) % 5 == 0, -1, tex_id).astype(np.int32)
    fb = np.random.default_rng(3).uniform(size=(N, 3)).astype(np.float32)
    ref_g = np.asarray(jtx.eval_gray(ja, jnp.asarray(tex_id),
                                     jnp.asarray(uv), jnp.asarray(fb[:, 0]),
                                     duvdx=jnp.asarray(duvdx),
                                     duvdy=jnp.asarray(duvdy)))
    out_g = ttx.eval_gray(ta, torch.tensor(tex_id), torch.tensor(uv),
                          torch.tensor(fb[:, 0]), duvdx=torch.tensor(duvdx),
                          duvdy=torch.tensor(duvdy)).numpy()
    np.testing.assert_allclose(out_g, ref_g, rtol=0.0, atol=PARAM_ATOL)
    ref_c = np.asarray(jtx.eval_rgb(ja, jnp.asarray(tex_id),
                                    jnp.asarray(uv), jnp.asarray(fb)))
    out_c = ttx.eval_rgb(ta, torch.tensor(tex_id), torch.tensor(uv),
                         torch.tensor(fb)).numpy()
    np.testing.assert_array_equal(out_c[tex_id < 0], fb[tex_id < 0])
    np.testing.assert_allclose(out_c, ref_c, rtol=0.0, atol=PARAM_ATOL)


def _frames(seed):
    """Random shading frames: ns, ng, dpdu, dpdv [N,3]."""
    rng = np.random.default_rng(seed)
    unit = lambda: (lambda v: v / np.linalg.norm(v, axis=-1,
                                                 keepdims=True))(
        rng.normal(size=(N, 3))).astype(np.float32)
    ng = unit()
    ns = unit()
    ns = np.where((ns * ng).sum(-1, keepdims=True) < 0, -ns, ns)
    dpdu = (unit() * rng.uniform(0.2, 3.0, (N, 1))).astype(np.float32)
    dpdv = (unit() * rng.uniform(0.2, 3.0, (N, 1))).astype(np.float32)
    return ns.astype(np.float32), ng, dpdu, dpdv


def _material_rows(count):
    """Materials over every texture channel: kd / ks / sigma / bump
    textured alone and together, and constant rows."""
    rows = [dict(mtype=0, kd=(0.6, 0.5, 0.4), sigma=10.0),
            dict(mtype=0, kd=(1.0, 1.0, 1.0), kd_tex=0),
            dict(mtype=1, kd=(1.0, 1.0, 1.0), ks=(0.3, 0.3, 0.3),
                 kd_tex=1, ks_tex=2, roughness=0.4),
            dict(mtype=0, kd=(0.5, 0.5, 0.5), sigma=5.0, sigma_tex=3),
            dict(mtype=0, kd=(0.7, 0.2, 0.2), bump_tex=3),
            dict(mtype=2, kd=(1.0, 1.0, 1.0), ks=(1.0, 1.0, 1.0),
                 kd_tex=count - 1, ks_tex=4, bump_tex=5, eta=1.4),
            dict(mtype=3, kd=(0.3, 0.6, 0.3), ks=(0.2, 0.2, 0.2),
                 dissolve=0.5, bump_tex=0)]
    return rows


@pytest.mark.parametrize("filt", ["trilinear", "ewa"])
def test_resolve_params_matches_jax(atlases, filt):
    ja, ta = atlases
    rows = _material_rows(ta.count)
    jtab = jmats.make_material_table(rows)
    ttab = tmats.make_material_table(rows)
    assert tmats.tex_channel_presence(ttab) == \
        jmats.tex_channel_presence(jtab) == (True,) * 4
    _, uv, _, duvdx, duvdy = _lanes(ta.count, 4)
    ns, ng, dpdu, dpdv = _frames(5)
    mat_id = np.random.default_rng(6).integers(0, len(rows), N)
    ref = jmats.resolve_params(
        jtab, jnp.asarray(mat_id, jnp.int32), jnp.asarray(ns),
        jnp.asarray(ng), jnp.asarray(dpdu), uv=jnp.asarray(uv),
        textures=ja, dpdv=jnp.asarray(dpdv), duvdx=jnp.asarray(duvdx),
        duvdy=jnp.asarray(duvdy), tex_filter=filt)
    out = tmats.resolve_params(
        torch.tensor(tmats.param_table(ttab)), torch.tensor(mat_id),
        torch.tensor(ns), torch.tensor(ng), torch.tensor(dpdu),
        uv=torch.tensor(uv), textures=ta, dpdv=torch.tensor(dpdv),
        duvdx=torch.tensor(duvdx), duvdy=torch.tensor(duvdy),
        tex_filter=filt, tex_present=tmats.tex_channel_presence(ttab))
    names = ("mtype", "kd", "ks", "sigma", "rough", "eta", "dissolve",
             "ns", "dpdu")
    for name, o, r in zip(names, out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0.0,
                                   atol=PARAM_ATOL, err_msg=name)
    # the bump map moved the shading frame on its lanes
    bumped = np.isin(mat_id, (4, 5, 6))
    assert np.abs(out[7].numpy() - ns)[bumped].max() > 1e-3


def test_apply_bump_matches_jax(atlases):
    ja, ta = atlases
    _, uv, _, duvdx, duvdy = _lanes(ta.count, 7)
    ns, ng, dpdu, dpdv = _frames(8)
    bump = np.random.default_rng(9).integers(-1, ta.count, N)
    for duv in (None, (duvdx, duvdy)):
        jd = {} if duv is None else dict(duvdx=jnp.asarray(duv[0]),
                                         duvdy=jnp.asarray(duv[1]))
        td = {} if duv is None else dict(duvdx=torch.tensor(duv[0]),
                                         duvdy=torch.tensor(duv[1]))
        ref = jmats.apply_bump(ja, jnp.asarray(bump, jnp.int32),
                               jnp.asarray(uv), jnp.asarray(ns),
                               jnp.asarray(ng), jnp.asarray(dpdu),
                               jnp.asarray(dpdv), **jd)
        out = tmats.apply_bump(ta, torch.tensor(bump), torch.tensor(uv),
                               torch.tensor(ns), torch.tensor(ng),
                               torch.tensor(dpdu), torch.tensor(dpdv), **td)
        for o, r in zip(out, ref):
            np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0.0,
                                       atol=PARAM_ATOL)


def test_cone_duv_matches_jax():
    rng = np.random.default_rng(10)
    ns, ng, dpdu, dpdv = _frames(11)
    d = rng.normal(size=(N, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    d[:64] = -ng[:64]             # head-on: the projected axis vanishes
    r = rng.uniform(0.0, 0.05, N).astype(np.float32)
    ref = jdxy.cone_duv(jnp.asarray(r), jnp.asarray(d), jnp.asarray(ng),
                        jnp.asarray(dpdu), jnp.asarray(dpdv))
    out = tdxy.cone_duv(torch.tensor(r), torch.tensor(d), torch.tensor(ng),
                        torch.tensor(dpdu), torch.tensor(dpdv))
    for o, a in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=GEOM_ATOL)


@pytest.mark.parametrize("lens", [None, (0.05, 3.0)])
def test_ray_differentials_match_jax(lens):
    pv = np.asarray(jtf.look_at([0.3, 1.0, 4.0], [0.0, 0.5, 0.0],
                                [0.0, 1.0, 0.0]))
    kw = dict(parent_view=pv, screen_min=(-1, -0.75), screen_max=(1, 0.75),
              znear=0.1, zfar=100.0, fov=0.9, resolution=(64, 48))
    jc = jcam.make_perspective(
        lens=lens,
        **kw)
    tc = convert.camera_from_numpy(jc)
    rng = np.random.default_rng(12)
    pfilm = rng.uniform([0, 0], [64, 48], (N, 2)).astype(np.float32)
    plens = rng.uniform(size=(N, 2)).astype(np.float32)
    ref = jcam.generate_ray_differentials(jc, jnp.asarray(pfilm),
                                          jnp.asarray(plens))
    out = tcam.generate_ray_differentials(tc, torch.tensor(pfilm),
                                          torch.tensor(plens))
    for o, a in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(a), rtol=0.0,
                                   atol=GEOM_ATOL)


def test_scene_file_textures_match_jax():
    """Image textures from a scene file: the obj's map_Kd / map_bump and
    the JSON's Image, Product and Mix descs give the JAX package's
    material table and atlas."""
    import os
    from arendur_tpu.io import scenedesc as jsd
    from arendur_tpu_torch.io import scenedesc as tsd
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples/texturedquad/quad.json")
    js, _, _, jcfg, _ = jsd.parse_scene(path)
    ts, _, _, tcfg, _ = tsd.parse_scene(path)
    for k in ("mtype", "kd", "ks", "sigma", "roughness", "kd_tex",
              "ks_tex", "sigma_tex", "bump_tex"):
        np.testing.assert_array_equal(getattr(ts.materials, k),
                                      np.asarray(getattr(js.materials, k)),
                                      err_msg=k)
    assert (ts.materials.kd_tex >= 0).sum() == 4
    assert (ts.materials.bump_tex >= 0).sum() == 1
    assert tcfg.tex_filter == jcfg.tex_filter == "trilinear"
    for k in ATLAS_FIELDS:
        np.testing.assert_array_equal(getattr(tcfg.textures, k).numpy(),
                                      np.asarray(getattr(jcfg.textures, k)),
                                      err_msg=k)


def test_unreadable_image_maps_to_no_texture(tmp_path):
    """As in the JAX package, an image that cannot be read gives texture
    id -1 (the constant is used) and is not added to the atlas."""
    from arendur_tpu.io import objloader as jobj
    from arendur_tpu_torch.io import objloader as tobj
    (tmp_path / "bad.png").write_bytes(b"not an image")
    for mod, builder in ((jobj, jtx.AtlasBuilder()),
                         (tobj, ttx.AtlasBuilder())):
        for name in ("missing.png", "bad.png"):
            assert mod.texture_id_for(builder, {}, str(tmp_path), name,
                                      gamma=True) == -1
        assert builder.build() is None
