"""Area-uniform sphere-light sampling (ARENDUR_SPHERE_THETA=area) in the
port against the JAX package, on the CPU.

The mode is read once at import in both packages
(arendur_tpu_torch/shapes/sphere.py THETA_UNIFORM_COMPAT); the port's
readers go through that module attribute, so these tests set it with
monkeypatch.  The JAX side is never switched in-process (its jitted
renders would reuse a compat trace): the module-level comparisons pass
its functions' own theta_uniform=False, and the renders are stored
oracles made in a process of their own with the variable set
(tests/torch_oracles.py ``area_*``, tools/make_torch_oracles.py).

* (a) the row sampler (nee._sample_sphere_local_row, acos_poly), the
  emission sampler (sphere.sample_sphere_local, arccos), light_sample on
  cb.json and on the 1,200-light scene, and BPT's generate_path;
* (b) the renders: cb.json (the fused bounce's plain version, K3's),
  cb_etex.json (the composed bounce), BPT, Whitted, one train step
  (K4's plain VJP), and K4's lane code built by g++ in area mode
  against the plain VJP;
* (c) the switch: ``area`` selects area sampling, anything else compat;
* (d) a check against physics, no JAX: the NEE irradiance under a full
  sphere light of radiance L, radius r at distance d is pi L (r/d)^2 in
  area mode within 4 sigma, and not in compat mode.

Tolerances, each beside the residual measured on the CPU (see each
constant)."""

import dataclasses
import functools
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from arendur_tpu.io import scenedesc as jsd
from arendur_tpu.lighting import emission as jem
from arendur_tpu.lighting import nee as jnee
from arendur_tpu.shapes import sphere as jsph
from arendur_tpu_torch import scene as tsc
from arendur_tpu_torch.io import scenedesc as tsd
from arendur_tpu_torch.kernels import host_bwd
from arendur_tpu_torch.lighting import emission as tem
from arendur_tpu_torch.lighting import nee as tnee
from arendur_tpu_torch.parallel import mesh as tmesh
from arendur_tpu_torch.render import bpt as tbpt
from arendur_tpu_torch.render import cbounce as cb
from arendur_tpu_torch.render import fuzz
from arendur_tpu_torch.render import integrator as tint
from arendur_tpu_torch.render import whitted as twhitted
from arendur_tpu_torch.shapes import sphere as tsph

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_oracles as orc  # noqa: E402

torch.set_num_threads(2)

# the samplers' normal (measured: 2.4e-7, arccos / acos_poly and sin /
# cos one ulp apart), their point twice that (radius up to 2; measured
# 4.8e-7), their 1 / area (measured: equal to the bit)
SAMPLER_ATOL = 1e-6
PDF_RTOL = 1e-6
# light_sample's point and direction, generate_path's outputs (measured:
# 4.8e-7 / 1.3e-7; generate_path's direction 1.1e-6 absolute)
LS_RTOL, LS_ATOL = 1e-5, 1e-6
# light_sample's solid-angle pdf (measured: 5.9e-5 relative on cb.json,
# 1.4e-4 on the 1,200-light scene, near small spheres' silhouettes)
LS_PDF_RTOL = 5e-4
# the renders, per pixel: the JAX package's gate between its fused and
# composed paths (measured: cb.json 6.3e-7, cb_etex.json 4.9e-8, BPT
# 2.5e-6, Whitted 6.6e-7; the compat renders lie 1.66 / 0.059 / 0.21 /
# 0.58 from these oracles)
PIXEL_ATOL = 3e-3
# the train step, tests/test_torch_train.py's gates (measured: the loss
# equal to 7 digits, gradients 3.0e-8 absolute of 9.8e-2)
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-9
# K4's lane code, tests/test_torch_k4_host.py's gates (measured: dx
# close 0.999512 / 0.999402, tables 3.9e-5 relative at most)
K4_GATE = 0.999
K4_RTOL, K4_ATOL = 1e-3, 1e-5
TAB_GATE = 1e-3
SIGMAS = 4.0             # the physics check (measured: 1.5 and 0.3)


@pytest.fixture
def area(monkeypatch):
    monkeypatch.setattr(tsph, "THETA_UNIFORM_COMPAT", False)


def _rel(a, b):
    return np.abs(a - b) / np.maximum(np.abs(b), 1e-30)


def _spheres(n, seed):
    """Random sphere parameters, half of them partial in z and phi:
    (radius, zmin, zmax, thetamin, thetamax, phimax) as float32 arrays."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(0.02, 2.0, n).astype(np.float32)
    a, b = np.sort(rng.uniform(-1.0, 1.0, (2, n)), 0)
    full = np.arange(n) % 2 == 0
    zmin = np.where(full, -r, a * r).astype(np.float32)
    zmax = np.where(full, r, b * r).astype(np.float32)
    tmin = np.arccos(np.clip(zmin / r, -1, 1)).astype(np.float32)
    tmax = np.arccos(np.clip(zmax / r, -1, 1)).astype(np.float32)
    phimax = np.where(full, 2 * np.pi, rng.uniform(0.5, 6.2, n)).astype(
        np.float32)
    u2 = rng.random((n, 2), dtype=np.float32)
    return (r, zmin, zmax, tmin, tmax, phimax), u2


@pytest.mark.parametrize("theta_uniform", [False, True],
                         ids=["area", "compat"])
def test_row_sampler_matches_jax(theta_uniform):
    """nee._sample_sphere_local_row (acos_poly) and its twin."""
    cols, u2 = _spheres(4096, 0)
    jp, jn, jpdf = (np.asarray(x) for x in jnee._sample_sphere_local_row(
        *(jnp.asarray(c) for c in cols), jnp.asarray(u2),
        theta_uniform=theta_uniform))
    tp, tn, tpdf = cb._sample_sphere_local_row(
        *(torch.tensor(c) for c in cols),
        (torch.tensor(u2[:, 0]), torch.tensor(u2[:, 1])),
        theta_uniform=theta_uniform)
    tp, tn = torch.stack(tp, -1).numpy(), torch.stack(tn, -1).numpy()
    print(f"row sampler: max |dp| {np.abs(tp - jp).max():.2e}, |dn| "
          f"{np.abs(tn - jn).max():.2e}, pdf rel "
          f"{_rel(tpdf.numpy(), jpdf).max():.2e}")
    np.testing.assert_allclose(tp, jp, rtol=0, atol=SAMPLER_ATOL * 2.0)
    np.testing.assert_allclose(tn, jn, rtol=0, atol=SAMPLER_ATOL)
    np.testing.assert_allclose(tpdf.numpy(), jpdf, rtol=PDF_RTOL)


@pytest.mark.parametrize("theta_uniform", [False, True],
                         ids=["area", "compat"])
def test_emission_sampler_matches_jax(theta_uniform):
    """sphere.sample_sphere_local (arccos) and emission's twin."""
    (r, zmin, zmax, tmin, tmax, phimax), u2 = _spheres(4096, 1)
    n = r.shape[0]
    eye = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    soa = jsph.SphereSoA(o2w=eye, w2o=eye, radius=r, zmin=zmin, zmax=zmax,
                         thetamin=tmin, thetamax=tmax, phimax=phimax,
                         mat_id=np.zeros(n, np.int32),
                         light_id=np.zeros(n, np.int32))
    jp, jn, jpdf = (np.asarray(x) for x in jsph.sample_sphere_local(
        soa, jnp.arange(n), jnp.asarray(u2), theta_uniform=theta_uniform))
    tp, tn, tpdf = tem.sample_sphere_local(
        *(torch.tensor(c) for c in (r, zmin, zmax, tmin, tmax, phimax)),
        (torch.tensor(u2[:, 0]), torch.tensor(u2[:, 1])),
        theta_uniform=theta_uniform)
    tp, tn = torch.stack(tp, -1).numpy(), torch.stack(tn, -1).numpy()
    print(f"emission sampler: max |dp| {np.abs(tp - jp).max():.2e}, |dn| "
          f"{np.abs(tn - jn).max():.2e}, pdf rel "
          f"{_rel(tpdf.numpy(), jpdf).max():.2e}")
    np.testing.assert_allclose(tp, jp, rtol=0, atol=SAMPLER_ATOL * 2.0)
    np.testing.assert_allclose(tn, jn, rtol=0, atol=SAMPLER_ATOL)
    np.testing.assert_allclose(tpdf.numpy(), jpdf, rtol=PDF_RTOL)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """(JAX scene, port DeviceScene) of cb.json and of the 1,200-light
    scene (tests/torch_oracles.py big_lights)."""
    big = orc.big_lights_scene(str(tmp_path_factory.mktemp("area")))
    return {name: (jsd.parse_scene(p)[0],
                   tsc.DeviceScene.build(tsd.parse_scene(p)[0], "cpu"))
            for name, p in (("cb", orc.CB), ("big_lights", big))}


@pytest.mark.parametrize("name", ["cb", "big_lights"])
def test_light_sample_matches_jax(area, scenes, monkeypatch, name):
    js, ds = scenes[name]
    monkeypatch.setattr(jnee, "_sample_sphere_local_row", functools.partial(
        jnee._sample_sphere_local_row, theta_uniform=False))
    n = 8192
    rng = np.random.default_rng(2)
    lidx = tnee.sample_one_light(ds, torch.tensor(
        rng.random(n, dtype=np.float32)))[0]
    pos = rng.uniform([-0.9, 0.1, -0.9], [0.9, 1.9, 0.9],
                      (n, 3)).astype(np.float32)
    u2 = rng.random((n, 2), dtype=np.float32)
    jl = jnee.light_sample(js, jnp.asarray(lidx.numpy()), jnp.asarray(pos),
                           jnp.asarray(u2))
    tl = tnee.light_sample(ds, lidx, torch.tensor(pos), torch.tensor(u2))
    got = {k: tl[k].numpy() for k in ("radiance", "pdf", "pfrom", "wi")}
    ref = {k: np.asarray(jl[k]) for k in got}
    print(f"{name} light_sample: " + ", ".join(
        f"{k} max |d| {np.abs(got[k] - ref[k]).max():.2e} rel "
        f"{_rel(got[k], ref[k]).max():.2e}" for k in got))
    np.testing.assert_array_equal(got["radiance"], ref["radiance"])
    for k in ("pfrom", "wi"):
        np.testing.assert_allclose(got[k], ref[k], rtol=LS_RTOL,
                                   atol=LS_ATOL)
    np.testing.assert_allclose(got["pdf"], ref["pdf"], rtol=LS_PDF_RTOL)


def test_generate_path_matches_jax(area, scenes, monkeypatch):
    """BPT's light subpaths start on cb.json's spheres."""
    js, ds = scenes["cb"]
    monkeypatch.setattr(jem.sph, "sample_sphere_local", functools.partial(
        jsph.sample_sphere_local, theta_uniform=False))
    n = 8192
    rng = np.random.default_rng(3)
    lidx = np.arange(n, dtype=np.int32) % ds.ltab.shape[0]
    u_pos, u_dir = rng.random((2, n, 2), dtype=np.float32)
    jg = jem.generate_path(js, jnp.asarray(lidx), jnp.asarray(u_pos),
                           jnp.asarray(u_dir))
    tg = tem.generate_path(ds, torch.tensor(lidx).long(),
                           torch.tensor(u_pos), torch.tensor(u_dir))
    for k in ("pos", "dir", "n", "le", "pdf_pos", "pdf_dir"):
        a, b = tg[k].numpy(), np.asarray(jg[k])
        print(f"generate_path {k}: max |d| {np.abs(a - b).max():.2e}")
        np.testing.assert_allclose(a, b, rtol=LS_RTOL, atol=LS_ATOL)


def _parse(path, res=orc.RENDER_RES, spp=orc.RENDER_SPP, depth=None):
    ts, cam, film, cfg, _ = tsd.parse_scene(path, spp_override=spp,
                                            resolution_override=res)
    if depth is not None:
        cfg = dataclasses.replace(cfg, max_depth=depth)
    return tsc.DeviceScene.build(ts, "cpu"), cam, film, cfg


def _oracle(name):
    return orc.load(name, orc.area_inputs(name))


@pytest.mark.parametrize("name", sorted(orc.AREA_RENDERS))
def test_render_matches_jax(area, name):
    """cb.json through the fused bounce's plain path (K3's), cb_etex.json
    through the composed bounce."""
    ds, cam, film, cfg = _parse(orc.AREA_RENDERS[name],
                                depth=orc.RENDER_DEPTH)
    img = tint.render(ds, cam, film, cfg).numpy()
    ref = _oracle(name)["img"]
    print(f"{name}: max |port - JAX| {np.abs(img - ref).max():.2e} of "
          f"{ref.max():.2f}")
    assert np.isfinite(img).all() and ref.max() > 0.05
    np.testing.assert_allclose(img, ref, rtol=0.0, atol=PIXEL_ATOL)


def test_bpt_and_whitted_match_jax(area):
    p = orc.AREA_BPT
    img = tbpt.render_bpt(*_parse(orc.CB, p["res"], p["spp"],
                                  p["depth"])).numpy()
    ref = _oracle("area_bpt")["img"]
    print(f"BPT: max |port - JAX| {np.abs(img - ref).max():.2e}")
    assert np.isfinite(img).all() and ref.max() > 0.05
    np.testing.assert_allclose(img, ref, rtol=0.0, atol=PIXEL_ATOL)
    img = twhitted.render_whitted(*_parse(orc.CB)).numpy()
    ref = _oracle("area_whitted")["img"]
    print(f"Whitted: max |port - JAX| {np.abs(img - ref).max():.2e}")
    assert np.isfinite(img).all() and ref.max() > 0.05
    np.testing.assert_allclose(img, ref, rtol=0.0, atol=PIXEL_ATOL)


def test_train_step_matches_jax(area):
    w, h = orc.TRAIN_RES
    n = w * h * orc.TRAIN_SPP
    ds, cam, film, cfg = _parse(orc.CB, orc.TRAIN_RES, orc.TRAIN_SPP)
    cfg = dataclasses.replace(cfg, max_depth=orc.TRAIN_DEPTH, wave_size=n)
    params = {k: torch.tensor(getattr(ds.materials, k))
              for k in orc.PARAM_KEYS}
    step = tmesh.train_step_fn(ds, cam, film, cfg, lr=orc.TRAIN_LR)
    new, loss = step(dict(params), torch.tensor(orc.train_target()),
                     torch.arange(n))
    ref = _oracle("area_train")
    print(f"train step: loss {float(loss):.6e} vs {float(ref['loss']):.6e}")
    np.testing.assert_allclose(float(loss), float(ref["loss"]),
                               rtol=LOSS_RTOL)
    for k in orc.PARAM_KEYS:
        g = ((params[k] - new[k]) / orc.TRAIN_LR).numpy()
        ok = np.isfinite(ref[k])
        assert np.isfinite(g).all()
        print(f"  {k}: max |d| {np.abs(g - ref[k])[ok].max():.2e} of "
              f"{np.abs(ref[k][ok]).max():.2e}")
        np.testing.assert_allclose(g[ok], ref[k][ok], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)


@pytest.fixture(scope="module")
def host_k4(tmp_path_factory):
    fn = host_bwd.build(str(tmp_path_factory.mktemp("k4_area")))
    if fn is None:
        pytest.skip("no host C++ compiler (g++) to build K4's lane code")
    return fn


@pytest.mark.parametrize("which", ["cornell", "all-branches"])
def test_k4_lane_code_matches_plain(area, host_k4, which):
    """K4's lane code (cbounce_ad.cuh's area branch: acos_poly on the
    detached sample) built by g++, with theta_compat = 0 in its config,
    against autograd over the plain body in area mode, under
    tests/test_torch_k4_host.py's gates."""
    if which == "cornell":
        scene = tsd.parse_scene(orc.CB)[0]
    else:
        scene = fuzz.all_branches_scene(tsc.SceneBuilder())
    ds = tsc.DeviceScene.build(scene, "cpu")
    tabs = (ds.ltab, ds.mtab, ds.stab)
    n = 2048
    xt = torch.tensor(fuzz.fuzz_bounce_inputs(
        *(t.numpy() for t in tabs), seed=5, n=n).T.copy())
    ct = torch.tensor(np.random.default_rng(8).normal(
        size=(cb.OUT_COLS, n)).astype(np.float32))
    dx, dlt, dmt, dst, need, nodes, failed = host_bwd.run(
        host_k4, xt, ct, *tabs, ds.static, 4, 0.05)
    ref = [g.numpy() for g in cb.cbody_vjp_reference(
        xt, *tabs, ct, ds.static, 4, 0.05)]
    assert failed == 0 and need.all()
    close = np.isclose(dx, ref[0], rtol=K4_RTOL, atol=K4_ATOL) \
        | (np.isnan(dx) & np.isnan(ref[0]))
    rels = [np.linalg.norm(g - r) / max(np.linalg.norm(r), 1e-30)
            for g, r in zip((dlt, dmt, dst), ref[1:])]
    print(f"K4 {which}: dx close {close.mean():.6f}, tables rel {rels}")
    assert close.mean() >= K4_GATE and max(rels) <= TAB_GATE
    assert all(np.isfinite(g).all() for g in (dlt, dmt, dst))


SWITCH = {"area": False, None: True, "compat": True, "AREA": True, "": True}


@pytest.fixture(scope="module")
def switch_reads():
    """THETA_UNIFORM_COMPAT as the port reads it at import under each
    value of ARENDUR_SPHERE_THETA (None: unset), from one subprocess that
    imports the module afresh for each."""
    code = (
        "import importlib, os, sys\n"
        "os.environ.pop('ARENDUR_SPHERE_THETA', None)\n"
        "from arendur_tpu_torch.shapes import sphere\n"
        "for v in sys.argv[1:]:\n"
        "    if v == 'None':\n"
        "        os.environ.pop('ARENDUR_SPHERE_THETA', None)\n"
        "    else:\n"
        "        os.environ['ARENDUR_SPHERE_THETA'] = v\n"
        "    print(repr(v), importlib.reload(sphere).THETA_UNIFORM_COMPAT)\n")
    out = subprocess.run(
        [sys.executable, "-c", code] + [str(v) for v in SWITCH],
        cwd=os.path.dirname(HERE), capture_output=True, text=True,
        timeout=120, check=True)
    return out.stdout.splitlines()


@pytest.mark.parametrize("value", list(SWITCH), ids=repr)
def test_switch(switch_reads, value):
    assert f"{str(value)!r} {SWITCH[value]}" in switch_reads


def _irradiance(pole, n=200_000):
    """The NEE estimate of the irradiance at a point at distance d from
    the center of a full sphere light (radiance L, radius r) whose local
    z axis runs through the point (`pole` "z") or across the line to it
    ("x"), the receiver's normal toward the center: (estimate, sigma,
    pi L (r/d)^2)."""
    big_l, r, d = 3.0, 0.5, 2.0
    b = tsc.SceneBuilder()
    m = b.add_material(mtype=0, kd=(0.5, 0.5, 0.5))
    rot = np.eye(4, dtype=np.float32)
    if pole == "x":
        rot[:3, :3] = [[0, 0, 1], [0, 1, 0], [-1, 0, 0]]
    rot[3, :3] = (0.0, 0.0, d)
    b.add_sphere(radius=r, zmin=-r, zmax=r, phimax=2 * np.pi, mat_id=m,
                 transform=rot, emission=(big_l,) * 3)
    ds = tsc.DeviceScene.build(b.build(), "cpu")
    u2 = torch.tensor(np.random.default_rng(11).random((n, 2),
                                                      dtype=np.float32))
    ls = tnee.light_sample(ds, torch.zeros(n, dtype=torch.long),
                           torch.zeros(n, 3), u2)
    cos = ls["wi"][:, 2].clamp(min=0.0).double()
    pdf = ls["pdf"].double()
    f = torch.where(pdf > 0, ls["radiance"][:, 0].double() * cos
                    / pdf.clamp(min=1e-30), torch.zeros_like(pdf))
    return (f.mean().item(), f.std().item() / math.sqrt(n),
            math.pi * big_l * (r / d) ** 2)


@pytest.mark.parametrize("pole", ["z", "x"])
def test_irradiance_under_a_sphere_light(monkeypatch, pole):
    """Area mode: the exact irradiance within SIGMAS (measured: 1.5
    sigma through the pole, 0.3 across); compat (the reference's
    theta-uniform points with pdf 1/area) is biased: measured ratio to
    the exact 1.6039 through the pole, 0.7281 across, at r/d = 1/4."""
    monkeypatch.setattr(tsph, "THETA_UNIFORM_COMPAT", False)
    est, sig, exact = _irradiance(pole)
    print(f"pole {pole}: area {est:.6f} +- {sig:.1e}, exact {exact:.6f}")
    assert abs(est - exact) <= SIGMAS * sig
    monkeypatch.setattr(tsph, "THETA_UNIFORM_COMPAT", True)
    est_c, sig_c, _ = _irradiance(pole)
    print(f"pole {pole}: compat {est_c:.6f} +- {sig_c:.1e}, ratio "
          f"{est_c / exact:.4f}")
    assert abs(est_c - exact) > SIGMAS * sig_c
