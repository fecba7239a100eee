"""The composed bounce's cone curvature on instanced hits, as the JAX
package takes it.

The ray cone of a textured wave widens at a specular bounce by
2 kappa w, kappa = 1 / r on spheres and 0 on flat triangles.  The JAX
package's composed bounce takes every hit with ``prim >= n_tris`` for a
sphere (arendur_tpu/render/integrator.py:539-540), so a specular bounce
off an instanced triangle (ids past the spheres') widens the cone by
2 w / r of the last sphere (the clamped gather).  The port follows it
(render/integrator.py composed_bounce); ROADMAP lists it among the
places where the reference is knowingly off.  On tests/torch_oracles.py's
inst_etex_scene (a textured floor and wall, an emission-textured sphere
light, a glass sphere, a glass box placed three times by one instanced
mesh; 16x12, 4 spp, depth 4):

* at every bounce of a wave, the cone's spread grows by exactly 2 w / r
  of the sphere hit on sphere specular lanes, by 2 w / r of the last
  sphere on instanced specular lanes (there are such lanes, and the
  growth is large there: at least MIN_REL_GROWTH times the spread on
  one), and not at all on the other lanes; on the specular lanes whose
  hit is the JAX package's, the spread equals JAX's own after each bounce
  (its op-by-op trace, ``inst_etex_lanes``) within CONE_RTOL, and at most
  HIT_SPLITS specular lanes hit another primitive than JAX's (a ray that
  meets a glass box where it stands on the floor: the port hits the
  box's side 4e-5 before the floor, JAX the floor);
* the port's image and the JAX render (tests/torch_oracles.py
  ``inst_etex``, the jitted trace) lie within PIXEL_ATOL of each other on
  every pixel but one: 0.0274 there.  That pixel is not the curvature's:
  the JAX package's jitted trace of one of its lanes leaves its own
  op-by-op trace (``inst_etex_lanes``: 0.057 against 0.00023), and the
  port's lanes equal the op-by-op trace's within PIXEL_ATOL on every
  lane."""

import os
import sys

import numpy as np
import pytest
import torch

from arendur_tpu_torch import convert
from arendur_tpu_torch import scene as tsc
from arendur_tpu_torch.render import integrator as tint
from arendur_tpu_torch.sampling import sampler as smp

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_oracles as orc  # noqa: E402

torch.set_num_threads(2)

PIXEL_ATOL = 3e-3                           # per pixel, and per lane
DEPARTURE_MIN, DEPARTURE_MAX = 0.02, 0.04   # per pixel (measured 0.0274)
DEPARTURE_PIXELS = 1                        # pixels past PIXEL_ATOL
MIN_REL_GROWTH = 10.0                       # measured 80.3
# the spread against JAX's: measured 2.6e-6 at bounces 0-2 and 2.9e-5
# at the last (the hit's t after three refractions, 3.4e-5 apart); the
# rule that bounds the sphere test to [T, T + S) departs by a factor
# past MIN_REL_GROWTH
CONE_RTOL = 1e-4
HIT_SPLITS = 1                              # measured 1


def _port_setup():
    scene, camera, film_cfg, config = orc.inst_etex_scene()
    ds = convert.scene_from_numpy(scene, "cpu")
    cfg = tint.RenderConfig(max_depth=config.max_depth, spp=config.spp,
                            sample_dx=config.sample_dx,
                            sample_dy=config.sample_dy,
                            wave_size=config.wave_size,
                            textures=convert.atlas_from_numpy(
                                config.textures))
    return ds, convert.camera_from_numpy(camera), \
        convert.film_from_numpy(film_cfg), cfg


@pytest.fixture(scope="module")
def traced():
    """One render of the port with every bounce's hits and cone updates
    recorded: (image, records, scene), a record per bounce of
    (prim, spread in, spread out, w at the hit, specular bounce, the
    lanes' original indices)."""
    ds, camera, film_cfg, cfg = _port_setup()
    assert ds.composed_only and ds.inst
    records, last, origs = [], {}, []
    intersect, curv = tsc.intersect, tint.curv_spread
    bounce = tint.composed_bounce

    def rec_intersect(*a, **k):
        hit = intersect(*a, **k)
        last["prim"] = hit.prim
        return hit

    def rec_curv(scene, config, cone_g, is_sph, s_idx, w, spec):
        out = curv(scene, config, cone_g, is_sph, s_idx, w, spec)
        records.append((last["prim"], cone_g, out, w, spec))
        return out

    def rec_bounce(*a, **k):
        out = bounce(*a, **k)
        origs.append(out["orig"])
        return out
    mp = pytest.MonkeyPatch()
    mp.setattr(tsc, "intersect", rec_intersect)
    mp.setattr(tint, "curv_spread", rec_curv)
    mp.setattr(tint, "composed_bounce", rec_bounce)
    try:
        img = tint.render(ds, camera, film_cfg, cfg).numpy()
    finally:
        mp.undo()
    assert len(origs) == len(records)
    return img, [r + (o,) for r, o in zip(records, origs)], ds


def test_port_grows_the_cone_on_spheres_only(traced):
    _, records, ds = traced
    t, s = ds.n_tris, ds.ktab.shape[0]
    radius = ds.ktab[:, 16]
    jax_lanes = orc.load("inst_etex_lanes", orc.inst_inputs())
    jax_g, jax_prim = (torch.as_tensor(jax_lanes[k])
                       for k in ("cone_g", "prim"))
    assert jax_g.shape[0] == len(records)
    n_inst = n_sph = n_inst_jax = splits = 0
    rel = []
    for b, (prim, g_in, g_out, w, spec, orig) in enumerate(records):
        inst = spec & (prim >= t + s)
        sph = spec & (prim >= t) & (prim < t + s)
        assert torch.equal(g_out[~spec], g_in[~spec])
        s_idx = torch.clamp(prim - t, 0, s - 1)
        kappa = 1.0 / torch.clamp(radius[s_idx], min=1e-6)
        want = g_in + 2.0 * kappa * w
        assert torch.equal(g_out[sph], want[sph])
        # an instanced lane takes the last sphere's curvature
        assert bool((s_idx[inst] == s - 1).all())
        assert torch.equal(g_out[inst], want[inst])
        n_inst += int(inst.sum())
        n_sph += int(sph.sum())
        rel.append(((g_out - g_in) / g_in.clamp(min=1e-12))[inst])
        same = spec & (prim == jax_prim[b][orig])
        splits += int((spec & ~same).sum())
        n_inst_jax += int((same & inst).sum())
        torch.testing.assert_close(g_out[same], jax_g[b][orig[same]],
                                   rtol=CONE_RTOL, atol=0.0)
    assert n_inst > 0 and n_sph > 0 and n_inst_jax > 0
    assert splits <= HIT_SPLITS, splits
    assert torch.cat(rel).max().item() >= MIN_REL_GROWTH


def test_departure_from_jax_image(traced):
    """The port's lanes equal the JAX package's wave traced op by op; the
    port's image leaves the stored JAX render (the jitted trace) only at
    the pixels whose lanes the jitted trace itself computes otherwise
    than the op-by-op one."""
    img, _, ds = traced
    ref = orc.load("inst_etex", orc.inst_inputs())["img"]
    jax_lanes = orc.load("inst_etex_lanes", orc.inst_inputs())
    assert np.isfinite(img).all() and ref.max() > 0.01
    _, camera, _, cfg = _port_setup()
    pxy, pid, sid = (torch.as_tensor(a) for a in orc.inst_wave())
    _, lanes = tint.trace_wave(ds, camera, cfg, pxy, pid.long(), sid.long(),
                               smp.make_base_key(0))
    np.testing.assert_allclose(lanes.numpy(), jax_lanes["eager"], rtol=0.0,
                               atol=PIXEL_ATOL)
    jit_off = np.abs(jax_lanes["jit"] - jax_lanes["eager"]).max(-1) \
        > PIXEL_ATOL
    diff = np.abs(img - ref)
    off = np.flatnonzero(diff.max(-1).ravel() > PIXEL_ATOL)
    assert set(off) <= set(np.flatnonzero(jit_off) // orc.INST_SPP), off
    assert DEPARTURE_MIN <= diff.max() <= DEPARTURE_MAX, diff.max()
    assert len(off) <= DEPARTURE_PIXELS
