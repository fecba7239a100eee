"""Shared scenes, oracles and checks of the BPT parity tests, one file
per scene so that each JAX oracle runs in a worker of its own:
tests/test_torch_bpt.py (tests/test_bpt.py's box_scene, a triangle
light), tests/test_torch_bpt_cornell.py (examples/cornellbox/cb.json,
two sphere lights), tests/test_torch_bpt_scenes.py (render/fuzz.py's
all-branches scene: every light type, glass, translucent) and
tests/test_torch_bpt_textured.py (cb.json with bench.py's checker kd
texture).  Each runs one depth-2 wave at 8x6, 4 spp through the JAX
package's render/bpt.trace_wave_bpt (eager, its default CPU path: mxu
triangle test, XLA sphere test, two-sweep BSDF evaluation) and through
the port's (the plain versions of K1, K2, K8 and K9), strategy by
strategy.

Gates, each with its measured residual (8x6, 4 spp, depth 2):

* every (s, t) strategy's contribution and MIS weight per lane within
  C_RTOL / C_ATOL (measured at most: contribution 4.0e-6 on cb.json's
  and the textured box's (0, 4) of 0.84 / 1.07, 3.9e-7 on the
  all-branches scene's; MIS weight 2.7e-6);
* split lanes, where the two walks part, may occur only on lanes whose
  light subpath starts on a sphere light (cb.json: its first ray starts
  1e-4 off the sphere, where the sphere test is ill-conditioned and XLA
  contracts multiply-adds), at most SPHERE_START_BUDGET of the 192
  lanes (measured: 0 on every scene); a scene without sphere lights
  allows none;
* the splat positions within 1e-4 px (measured: 9.5e-7);
* the light walk's first closest hit on 4,096 such rays
  (SPHERE_HIT_BUDGET, measured: 0 split on cb.json and on the
  all-branches scene);
* K9's fused evaluate + pdf, which serves BPT's f and pdf in the port,
  against JAX's two sweeps (slots.bsdf_evaluate / bsdf_pdf) on a wave's
  own vertex BSDFs and (wo, wi) pairs: f within F_RTOL / F_ATOL, pdf
  within PDF_RTOL / PDF_ATOL (measured: f 0 on box_scene, 1.9e-7
  relative on cb.json, 1.7e-7 on the all-branches scene's glass and
  translucent vertices, no element past 1e-5 on any; pdf 1.5e-8).
"""

import dataclasses
import os

import numpy as np
import torch
import jax.numpy as jnp

from arendur_tpu import materials as jm
from arendur_tpu import scene as jsc
from arendur_tpu.bxdf import slots as jsl
from arendur_tpu.filming import camera as jcam
from arendur_tpu.filming import film as jflm
from arendur_tpu.geometry import transform as jtf
from arendur_tpu.io import scenedesc as jsd
from arendur_tpu.render import bpt as jbpt
from arendur_tpu.render import integrator as jint
from arendur_tpu.sampling import filters as jfilt
from arendur_tpu.sampling import sampler as jsmp
from arendur_tpu_torch import convert
from arendur_tpu_torch import materials as tm
from arendur_tpu_torch import scene as tsc
from arendur_tpu_torch.bxdf import slots as tsl
from arendur_tpu_torch.io import scenedesc as tsd
from arendur_tpu_torch.render import bpt as tbpt
from arendur_tpu_torch.render import fuzz
from arendur_tpu_torch.render import integrator as tint
from arendur_tpu_torch.sampling import sampler as tsmp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CB = os.path.join(REPO, "examples/cornellbox/cb.json")
RES, SPP, DEPTH = (8, 6), 4, 2
N = RES[0] * RES[1] * SPP
STRATEGIES = [(0, 2), (0, 3), (0, 4), (1, 2), (1, 3), (2, 2), (2, 1),
              (3, 1)]
C_RTOL, C_ATOL = 1e-4, 1e-5
SPHERE_START_BUDGET = 4      # split lanes of 192, sphere-started only
SPHERE_HIT_BUDGET = 41       # 1 % of 4,096 sphere-started first rays
F_RTOL, F_ATOL = 1e-2, 1e-6  # K9's f against slots.bsdf_evaluate
PDF_RTOL, PDF_ATOL = 1e-4, 1e-6


def box_scene(sc_mod, emission=(8.0, 8.0, 8.0)):
    """tests/test_bpt.py's box_scene for either package's builder."""
    b = sc_mod.SceneBuilder()
    m = b.add_material(mtype=0, kd=(0.7, 0.6, 0.5), sigma=0.0)
    v = np.array([[-4, -4, 0], [4, -4, 0], [4, 4, 0], [-4, 4, 0]],
                 np.float32)
    b.add_mesh(v, np.array([[0, 1, 2], [0, 2, 3]], np.int64), m)
    lm = b.add_material(mtype=0, kd=(0.0, 0.0, 0.0), sigma=0.0)
    lv = np.array([[-0.7, -0.7, 3.0], [0.7, -0.7, 3.0], [0.0, 0.7, 3.0]],
                  np.float32)
    b.add_mesh(lv, np.array([[0, 2, 1]], np.int64), lm, emission=emission)
    return b.build()


def simple_camera(res, eye=(0, -6, 2.0), to=(0, 0, 0.5), up=(0, 0, 1.0)):
    """tests/test_bpt.py's simple_camera (the JAX package's)."""
    pv = np.asarray(jtf.look_at(list(eye), list(to), list(up)))
    return jcam.make_perspective(
        parent_view=pv, screen_min=(-1, -0.75), screen_max=(1, 0.75),
        znear=0.1, zfar=100.0, fov=0.9, lens=None, resolution=res)


def box_film(res=RES):
    return jflm.FilmConfig(resolution=res,
                           filter=jfilt.FilterSpec("box", (0.5, 0.5)))


def setup(name):
    """(JAX scene, camera, film, config; port DeviceScene, camera, film,
    config) at 8x6, 4 spp, depth 2, each scene built by its own
    package."""
    if name in ("cornell", "checker"):
        js, jc, jf, jcfg, _ = jsd.parse_scene(CB, spp_override=SPP,
                                              resolution_override=RES)
        jcfg = dataclasses.replace(jcfg, max_depth=DEPTH)
        ts, tc, tf_, tcfg, _ = tsd.parse_scene(CB, spp_override=SPP,
                                               resolution_override=RES)
        tcfg = dataclasses.replace(tcfg, max_depth=DEPTH)
        if name == "checker":
            # bench.py's checkerboard kd texture on every matte material
            from arendur_tpu.texturing import texture as jtx
            ab = jtx.AtlasBuilder()
            tid = ab.add_image(fuzz.checker_image())
            mt = js.materials
            js = js.replace(materials=mt.replace(kd_tex=np.where(
                np.asarray(mt.mtype) == 0, tid,
                np.asarray(mt.kd_tex)).astype(np.int32)))
            jcfg = dataclasses.replace(jcfg, textures=ab.build())
            ts, atlas = fuzz.checker_textured(ts)
            tcfg = dataclasses.replace(tcfg, textures=atlas)
        return (js, jc, jf, jcfg), (tsc.DeviceScene.build(ts, "cpu"), tc,
                                    tf_, tcfg)
    if name == "box":
        js, ts = box_scene(jsc), box_scene(tsc)
        jc = simple_camera(RES)
    else:   # the all-branches scene of render/fuzz.py
        js = fuzz.all_branches_scene(jsc.SceneBuilder())
        ts = fuzz.all_branches_scene(tsc.SceneBuilder())
        jc = simple_camera(RES, eye=(0.5, 1.8, 6.0), to=(0.0, 1.0, 0.0),
                           up=(0.0, 1.0, 0.0))
    jf = box_film()
    jcfg = jint.RenderConfig(max_depth=DEPTH, spp=SPP, sample_dx=2,
                             sample_dy=2, wave_size=N)
    tcfg = tint.RenderConfig(max_depth=DEPTH, spp=SPP, sample_dx=2,
                             sample_dy=2, wave_size=N)
    return (js, jc, jf, jcfg), (tsc.DeviceScene.build(ts, "cpu"),
                                convert.camera_from_numpy(jc),
                                convert.film_from_numpy(jf), tcfg)


def ids():
    ri = np.arange(N, dtype=np.int32)
    pid, sid = ri // SPP, ri % SPP
    pxy = np.stack([pid % RES[0], pid // RES[0]], -1).astype(np.float32)
    return pxy, pid, sid


def port_wave(ds, tc, tf_, tcfg):
    """The port's wave: (outputs as NumPy arrays, its collect dict)."""
    pxy, pid, sid = ids()
    col = {}
    got = tbpt.trace_wave_bpt(ds, tc, tcfg, tf_, torch.tensor(pxy),
                              torch.tensor(pid).long(),
                              torch.tensor(sid).long(),
                              tsmp.make_base_key(0), collect=col)
    return [a.numpy() for a in got], col


def waves(name):
    """Both packages' wave on scene `name`."""
    pxy, pid, sid = ids()
    (js, jc, jf, jcfg), port = setup(name)
    jcol = {}
    ref = jbpt.trace_wave_bpt(js, jc, jcfg, jf, jnp.asarray(pxy),
                              jnp.asarray(pid), jnp.asarray(sid),
                              jsmp.make_base_key(0), collect=jcol)
    got, tcol = port_wave(*port)
    return dict(js=js, ds=port[0], ref=[np.asarray(a) for a in ref],
                got=got, jcol=jcol, tcol=tcol)


def sphere_started(w):
    """Lanes whose light subpath starts on an area-sphere light."""
    lid = w["tcol"]["light_vs"][0]["light_id"].long().numpy()
    return np.asarray(w["js"].lights.ltype)[lid] == jsc.L_AREA_SPHERE


def bad_lanes(a, b, rtol=C_RTOL, atol=C_ATOL):
    ok = np.isclose(a, b, rtol=rtol, atol=atol)
    return ~ok.reshape(ok.shape[0], -1).all(-1)


def check_strategy(w, name, st):
    """Strategy st's contribution and MIS weight, per lane."""
    assert set(k for k in w["tcol"] if isinstance(k, tuple)) \
        == set(w["jcol"]) == set(STRATEGIES)
    (cj, wj), (ct, wt) = w["jcol"][st], w["tcol"][st]
    cj, wj, ct, wt = (np.asarray(cj), np.asarray(wj), ct.numpy(),
                      wt.numpy())
    bad = bad_lanes(ct, cj) | bad_lanes(wt, wj)
    print(f"{name} {st}: max |dc| {np.abs(ct - cj).max():.3e} (max |c| "
          f"{np.abs(cj).max():.3e}), max |dw| {np.abs(wt - wj).max():.3e}, "
          f"split lanes {np.flatnonzero(bad).tolist()}")
    started = sphere_started(w)
    assert bad.sum() <= (SPHERE_START_BUDGET if started.any() else 0)
    assert started[bad].all()
    ok = ~bad
    np.testing.assert_allclose(ct[ok], cj[ok], rtol=C_RTOL, atol=C_ATOL)
    np.testing.assert_allclose(wt[ok], wj[ok], rtol=C_RTOL, atol=C_ATOL)
    assert np.isfinite(ct).all() and ((wt >= 0.0) & (wt <= 1.0)).all()


def check_wave_outputs(w):
    """pfilm, L and the splat arrays of the wave."""
    (pf_j, l_j, sp_j, sl_j, sv_j), (pf_t, l_t, sp_t, sl_t, sv_t) = \
        w["ref"], w["got"]
    np.testing.assert_array_equal(pf_t, pf_j)
    assert sp_t.shape == sp_j.shape == (2 * N, 2)
    bad = bad_lanes(l_t, l_j)
    assert bad.sum() <= (SPHERE_START_BUDGET if sphere_started(w).any()
                         else 0)
    np.testing.assert_allclose(l_t[~bad], l_j[~bad], rtol=C_RTOL,
                               atol=C_ATOL)
    keep = ~np.tile(bad, 2)
    np.testing.assert_array_equal(sv_t[keep], sv_j[keep])
    # a raster position moves by float32 roundoff only (the view ->
    # raster inverse is taken once per camera)
    both = keep & sv_j
    print(f"max |praster - JAX| {np.abs(sp_t[both] - sp_j[both]).max():.3e}"
          f" px on {both.sum()} splats")
    np.testing.assert_allclose(sp_t[both], sp_j[both], rtol=0.0, atol=1e-4)
    np.testing.assert_allclose(sl_t[keep], sl_j[keep], rtol=C_RTOL,
                               atol=C_ATOL)
    assert l_j.max() > 0.0 and sl_j.max() > 0.0 and sv_j.any()


def check_sphere_started_hits(name):
    """The light walk's first closest hit on 4,096 rays started 1e-4 off
    a scene's lights (render/fuzz.py bpt_light_rays): the port's
    scene.intersect (the plain K1 with the sphere table) against JAX's."""
    if name == "cornell":
        js, *_ = jsd.parse_scene(CB)
        ts, *_ = tsd.parse_scene(CB)
    else:
        js = fuzz.all_branches_scene(jsc.SceneBuilder())
        ts = fuzz.all_branches_scene(tsc.SceneBuilder())
    ds = tsc.DeviceScene.build(ts, "cpu")
    o, d, _ = fuzz.bpt_light_rays(ds, 4096, seed=1)
    got = tsc.intersect(ds, o, d)
    ref = jsc.intersect(js, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()))
    hit_r, prim_r = np.asarray(ref.hit), np.asarray(ref.prim)
    split = (got.hit.numpy() != hit_r) | (got.prim.numpy() != prim_r)
    print(f"{name}: light-walk first rays: {int(split.sum())} of 4096 split,"
          f" hit share {hit_r.mean():.3f}")
    assert hit_r.sum() > 100
    assert split.sum() <= SPHERE_HIT_BUDGET
    both = ~split & hit_r
    np.testing.assert_allclose(got.pos.numpy()[both],
                               np.asarray(ref.pos)[both], rtol=1e-5,
                               atol=1e-5)


def vertex_pairs(col):
    """A wave's vertex BSDF inputs and (wo, wi) pairs (from the port's
    collect): each walk vertex toward its neighbours both ways, and each
    surface connection's two vertices both ways, as BPT evaluates them.
    Returns (fields of the vertices, wo [M,3], wi [M,3])."""
    cam_vs, light_vs = col["cam_vs"], col["light_vs"]
    recs = []

    def add(v, prev, nxt):
        recs.append((v, tbpt._safe_dir(v["pos"], prev)[0],
                     tbpt._safe_dir(v["pos"], nxt)[0]))

    for vs in (cam_vs, light_vs):
        for i in range(1, len(vs) - 1):
            add(vs[i], vs[i - 1]["pos"], vs[i + 1]["pos"])
            add(vs[i], vs[i + 1]["pos"], vs[i - 1]["pos"])
    for t in range(2, len(cam_vs)):
        for s in range(2, len(light_vs)):
            pt, qs = cam_vs[t - 1], light_vs[s - 1]
            add(pt, cam_vs[t - 2]["pos"], qs["pos"])
            add(pt, qs["pos"], cam_vs[t - 2]["pos"])
            add(qs, light_vs[s - 2]["pos"], pt["pos"])
            add(qs, pt["pos"], light_vs[s - 2]["pos"])
    fields = {k: torch.cat([r[0][k] for r in recs])
              for k in ("mat_id", "ns", "ng", "dpdu", "dpdv", "uv",
                        "valid")}
    return fields, torch.cat([r[1] for r in recs]), \
        torch.cat([r[2] for r in recs])


def check_k9_two_sweeps(js, ds, col, name):
    """The port's fused evaluate + pdf (K9's plain version; K9 equals it
    to the bit on the card) against JAX's slots.bsdf_evaluate and
    slots.bsdf_pdf on a wave's own vertex sets."""
    fields, wo, wi = vertex_pairs(col)
    keep = fields.pop("valid").numpy()
    b = tm.compute_scattering(ds.materials, ds.mtab, fields["mat_id"],
                              fields["ns"], fields["ng"], fields["dpdu"],
                              uv=fields["uv"], dpdv=fields["dpdv"])
    f_t, pdf_t = tsl.bsdf_eval_pdf(b, wo, wi)
    j = {k: jnp.asarray(v.numpy()) for k, v in fields.items()}
    jb = jm.compute_scattering(js.materials, j["mat_id"], j["ns"], j["ng"],
                               j["dpdu"], uv=j["uv"], dpdv=j["dpdv"])
    jwo, jwi = jnp.asarray(wo.numpy()), jnp.asarray(wi.numpy())
    f_j = np.asarray(jsl.bsdf_evaluate(jb, jwo, jwi)[0])[keep]
    pdf_j = np.asarray(jsl.bsdf_pdf(jb, jwo, jwi))[keep]
    f_t, pdf_t = f_t.numpy()[keep], pdf_t.numpy()[keep]
    df = np.abs(f_t - f_j) / np.maximum(np.abs(f_j), 1e-12)
    sig = np.abs(f_j) > 1e-6
    print(f"{name}: {keep.sum()} (vertex, wo, wi) elements; f max rel "
          f"{df[sig].max(initial=0.0):.3e}, f elements beyond 1e-5 rel "
          f"{(df[sig] > 1e-5).mean():.4f}; pdf max |d| "
          f"{np.abs(pdf_t - pdf_j).max():.3e} (max pdf {pdf_j.max():.3e})")
    assert keep.sum() > 100
    np.testing.assert_allclose(f_t, f_j, rtol=F_RTOL, atol=F_ATOL)
    np.testing.assert_allclose(pdf_t, pdf_j, rtol=PDF_RTOL, atol=PDF_ATOL)
