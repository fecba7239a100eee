"""Scene loading of the port against arendur_tpu: the same cb.json
gives the same tables and host-static sets, scene_from_numpy carries
the JAX scene over unchanged, and the package never imports JAX."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from arendur_tpu import materials as jm
from arendur_tpu import scene as jsc
from arendur_tpu.accel import bvh as jbvh
from arendur_tpu.io import scenedesc as jsd
from arendur_tpu.shapes import sphere as jsph
from arendur_tpu_torch import convert
from arendur_tpu_torch import materials as tm
from arendur_tpu_torch import scene as tsc
from arendur_tpu_torch.accel import bvh as tbvh
from arendur_tpu_torch.io import scenedesc as tsd
from arendur_tpu_torch.render import fuzz
from arendur_tpu_torch.shapes import sphere as tsph

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CB = os.path.join(REPO, "examples/cornellbox/cb.json")


@pytest.fixture(scope="module")
def cornell():
    js, jcam, jfilm, jcfg, jout = jsd.parse_scene(CB)
    ts, tcam, tfilm, tcfg, tout = tsd.parse_scene(CB)
    return dict(js=js, ts=ts, jcam=jcam, tcam=tcam, jfilm=jfilm,
                tfilm=tfilm, jcfg=jcfg, tcfg=tcfg, jout=jout, tout=tout)


TABLES = ["tri_v0", "tri_v1", "tri_v2", "tri_n0", "tri_n1", "tri_n2",
          "tri_uv0", "tri_uv1", "tri_uv2", "tri_mat", "tri_light",
          "tri_cw", "tri_cbox", "tri_remap"]


@pytest.mark.parametrize("name", TABLES)
def test_triangle_tables_equal(cornell, name):
    np.testing.assert_array_equal(getattr(cornell["ts"], name),
                                  np.asarray(getattr(cornell["js"], name)))


def test_cornell_sizes(cornell):
    ts = cornell["ts"]
    assert ts.n_tris == 1112
    assert ts.tri_cw.shape == (6, 16, 1024)
    pk, _, _ = tsc.light_pack(ts)
    assert pk.shape == (2, 53)
    assert tm.param_table(ts.materials).shape == (9, 16)
    assert tsph.shade_table(ts.spheres).shape == (2, 24)


def _shade_tables(jscene, tscene):
    jpk, jcidx, jpres = jsc.light_pack(jscene)
    tpk, tcidx, tpres = tsc.light_pack(tscene)
    return [(np.asarray(jpk), tpk),
            (np.asarray(jm.param_table(jscene.materials)),
             tm.param_table(tscene.materials)),
            (np.asarray(jsph.shade_table(jscene.spheres)),
             tsph.shade_table(tscene.spheres))], (jcidx, tcidx, jpres, tpres)


@pytest.mark.parametrize("which", ["cornell", "all-branches"])
def test_shade_tables_and_static_sets_equal(cornell, which):
    if which == "cornell":
        js, ts = cornell["js"], cornell["ts"]
    else:
        js = fuzz.all_branches_scene(jsc.SceneBuilder())
        ts = fuzz.all_branches_scene(tsc.SceneBuilder())
    pairs, (jcidx, tcidx, jpres, tpres) = _shade_tables(js, ts)
    for a, b in pairs:
        np.testing.assert_array_equal(b, a)
    assert tcidx == jcidx
    assert tuple(tpres) == tuple(jpres)
    assert tm.slot_presence(ts.materials) == \
        jm.slot_presence(js.materials)
    assert tm.dist_presence(ts.materials) == \
        jm.dist_presence(js.materials)
    assert tsc.light_types_present(ts.lights) == \
        jsc.light_types_present(js.lights)
    np.testing.assert_array_equal(ts.light_distribution.cdf,
                                  np.asarray(js.light_distribution.cdf))


def test_cornell_static_config(cornell):
    st = tsc.shade_static(cornell["ts"])
    assert st.lpresent == (tsc.L_AREA_SPHERE,)
    # phimax 6.28 < 2 pi: the sphere lights keep their phi clip
    assert st.full_phi is False
    assert dict(st.lcidx)["emission"] == st.emi_cols == (1, 4)


def test_camera_film_config_equal(cornell):
    for f in ("view_parent", "raster_view", "dx", "dy", "lens"):
        np.testing.assert_array_equal(getattr(cornell["tcam"], f),
                                      np.asarray(getattr(cornell["jcam"], f)))
    assert cornell["tfilm"] == convert.film_from_numpy(cornell["jfilm"])
    for f in ("max_depth", "spp", "sample_dx", "sample_dy"):
        assert getattr(cornell["tcfg"], f) == getattr(cornell["jcfg"], f)
    assert cornell["tout"] == cornell["jout"]


def test_scene_from_numpy_roundtrip(cornell):
    ds_conv = convert.scene_from_numpy(cornell["js"], "cpu")
    ds_own = tsc.DeviceScene.build(cornell["ts"], "cpu")
    for f in ("cw", "cbox", "remap", "tpack", "ltab", "mtab", "stab",
              "light_cdf", "light_func"):
        assert torch.equal(getattr(ds_conv, f), getattr(ds_own, f)), f
    assert ds_conv.static == ds_own.static
    assert ds_conv.light_func_int == ds_own.light_func_int
    cam = convert.camera_from_numpy(cornell["jcam"])
    np.testing.assert_array_equal(cam.raster_view, cornell["tcam"].raster_view)


def test_numpy_bvh_matches_reference():
    rng = np.random.default_rng(0)
    v0 = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    v1 = v0 + rng.normal(size=(300, 3)).astype(np.float32) * 0.1
    v2 = v0 + rng.normal(size=(300, 3)).astype(np.float32) * 0.1
    a = jbvh.build_bvh(v0, v1, v2)
    b = tbvh.build_bvh(v0, v1, v2)
    for f in ("bmin", "bmax", "second", "start", "count", "axis", "order"):
        np.testing.assert_array_equal(getattr(b, f), np.asarray(getattr(a, f)))


def test_unported_descs_raise(tmp_path):
    """Descs the port once refused now load as the JAX package's loader
    reads them: an Image desc on a sphere light (an emission texture,
    since the composed path is ported) and a Transformed of a mesh (an
    instanced mesh of two placements, since instancing is ported)."""
    import json
    with open(CB) as f:
        desc = json.load(f)
    desc["components"][1]["value"]["Shaped"]["light"]["value"] = {
        "Image": {"path": os.path.join(REPO,
                                       "examples/texturedquad/checker.png")}}
    text = json.dumps(desc).replace(
        "./examples/cornellbox/", os.path.join(REPO, "examples/cornellbox/")
        + "/")
    p = tmp_path / "scene.json"
    p.write_text(text)
    ts = tsd.parse_scene(str(p))[0]
    js = jsd.parse_scene(str(p))[0]
    assert ts.lights.emission_tex.tolist() == [0, -1]
    np.testing.assert_array_equal(ts.lights.emission_tex,
                                  np.asarray(js.lights.emission_tex))
    np.testing.assert_allclose(ts.light_distribution.func,
                               np.asarray(js.light_distribution.func),
                               rtol=1e-6)
    desc["components"].append({"name": "box_copy", "value": {"Transformed": {
        "original": "cornellbox", "transform": np.eye(4).tolist()}}})
    p.write_text(json.dumps(desc).replace(
        "./examples/cornellbox/", os.path.join(REPO, "examples/cornellbox/")
        + "/"))
    ts = tsd.parse_scene(str(p))[0]
    js = jsd.parse_scene(str(p))[0]
    assert ts.n_tris == 0 and len(ts.inst) == 1
    assert ts.inst[0].n_instances == 2
    for k in ("cw", "cbox", "remap", "attr", "o2w", "w2o", "nrm"):
        np.testing.assert_array_equal(getattr(ts.inst[0], k),
                                      np.asarray(getattr(js.inst[0], k)))


@pytest.mark.parametrize("key", ["map_Kd", "map_Ks", "map_bump"])
def test_mtl_image_maps_load_as_jax(tmp_path, key):
    """Image maps of an mtl load into the builder's atlas; the material
    row matches the JAX package's loader."""
    from PIL import Image
    Image.fromarray(np.full((4, 6, 3), 128, np.uint8)).save(
        str(tmp_path / "t.png"))
    (tmp_path / "m.mtl").write_text(f"newmtl a\nKd 0.5 0.5 0.5\n{key} t.png\n")
    (tmp_path / "m.obj").write_text(
        "mtllib m.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\nusemtl a\nf 1 2 3\n")
    from arendur_tpu.io import objloader as jobj
    from arendur_tpu_torch.io import objloader
    tb, jb = tsc.SceneBuilder(), jsc.SceneBuilder()
    objloader.load_obj_into(tb, str(tmp_path / "m.obj"))
    jobj.load_obj_into(jb, str(tmp_path / "m.obj"))
    assert tb.material_rows == jb.material_rows
    chan = {"map_Kd": "kd_tex", "map_Ks": "ks_tex",
            "map_bump": "bump_tex"}[key]
    assert tb.material_rows[0][chan] == 0 and len(tb.atlas.images) == 1


# the test's name from when image maps raised NotImplementedError, kept
# so that the history of its results stays one series
test_mtl_image_maps_raise = test_mtl_image_maps_load_as_jax


def test_import_pulls_in_no_jax():
    code = ("import sys; import arendur_tpu_torch, arendur_tpu_torch.cli, "
            "arendur_tpu_torch.render.integrator, "
            "arendur_tpu_torch.io.scenedesc, arendur_tpu_torch.convert, "
            "arendur_tpu_torch.kernels.ops, arendur_tpu_torch.bxdf.slots, "
            "arendur_tpu_torch.bxdf.slot_shade, "
            "arendur_tpu_torch.lighting.nee; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'arendur_tpu')]; "
            "print(bad); assert not bad")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
