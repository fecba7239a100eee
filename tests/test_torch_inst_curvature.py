"""The composed bounce's cone curvature on instanced hits: a measured
departure from the JAX package, whose side is wrong.

The ray cone of a textured wave widens at a specular bounce by
2 kappa w, kappa = 1 / r on spheres and 0 on flat triangles.  The JAX
package's composed bounce takes every hit with ``prim >= n_tris`` for a
sphere (arendur_tpu/render/integrator.py:539-540), so a specular bounce
off an instanced triangle (ids past the spheres') widens the cone by
2 w / r of the last sphere; the port bounds the test to the spheres'
ids [T, T + S) (render/integrator.py composed_bounce).  On
tests/torch_oracles.py's inst_etex_scene (a textured floor and wall, an
emission-textured sphere light, a glass sphere, a glass box placed
three times by one instanced mesh; 16x12, 4 spp, depth 4):

* the port's side, asserted at every bounce of a wave: the cone's
  spread is unchanged on instanced specular lanes and grows by exactly
  2 w / r on sphere specular lanes;
* the size of the departure, recorded (ROADMAP's departure note quotes
  it): on the wave's 102 instanced specular lanes JAX widens the spread
  by 34x its value at the median and 80x at most (MIN_REL_GROWTH); the
  port's image differs from the JAX render (tests/torch_oracles.py
  ``inst_etex``) by 0.0274 at most in one pixel of 192 (between
  DEPARTURE_MIN and DEPARTURE_MAX), 1.0e-4 on the mean, and every other
  pixel is within PIXEL_ATOL."""

import os
import sys

import numpy as np
import pytest
import torch

from arendur_tpu_torch import convert
from arendur_tpu_torch import scene as tsc
from arendur_tpu_torch.render import integrator as tint

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_oracles as orc  # noqa: E402

torch.set_num_threads(2)

PIXEL_ATOL = 3e-3
DEPARTURE_MIN, DEPARTURE_MAX = 0.02, 0.04   # per pixel (measured 0.0274)
DEPARTURE_PIXELS = 1                        # pixels past PIXEL_ATOL
MIN_REL_GROWTH = 10.0                       # measured 80.3


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
    (prim, spread in, spread out, w at the hit, specular bounce)."""
    ds, camera, film_cfg, cfg = _port_setup()
    assert ds.composed_only and ds.inst
    records, last = [], {}
    intersect, curv = tsc.intersect, tint.curv_spread

    def rec_intersect(*a, **k):
        hit = intersect(*a, **k)
        last["prim"] = hit.prim
        return hit

    def rec_curv(scene, config, cone_g, is_sph, s_idx, w, spec):
        out = curv(scene, config, cone_g, is_sph, s_idx, w, spec)
        records.append((last["prim"], cone_g, out, w, spec))
        return out
    mp = pytest.MonkeyPatch()
    mp.setattr(tsc, "intersect", rec_intersect)
    mp.setattr(tint, "curv_spread", rec_curv)
    try:
        img = tint.render(ds, camera, film_cfg, cfg).numpy()
    finally:
        mp.undo()
    return img, records, ds


def test_port_grows_the_cone_on_spheres_only(traced):
    _, records, ds = traced
    t, s = ds.n_tris, ds.ktab.shape[0]
    radius = ds.ktab[:, 16]
    n_inst = n_sph = 0
    rel = []
    for prim, g_in, g_out, w, spec in records:
        inst = spec & (prim >= t + s)
        sph = spec & (prim >= t) & (prim < t + s)
        assert torch.equal(g_out[inst], g_in[inst])
        assert torch.equal(g_out[~spec], g_in[~spec])
        s_idx = torch.clamp(prim - t, 0, s - 1)
        kappa = 1.0 / torch.clamp(radius[s_idx], min=1e-6)
        want = g_in + 2.0 * kappa * w
        assert torch.equal(g_out[sph], want[sph])
        n_inst += int(inst.sum())
        n_sph += int(sph.sum())
        # what the JAX package adds on the instanced lanes: the last
        # sphere's curvature
        jax_add = 2.0 * w / radius[-1]
        rel.append((jax_add / g_in.clamp(min=1e-12))[inst])
    assert n_inst > 0 and n_sph > 0
    assert torch.cat(rel).max().item() >= MIN_REL_GROWTH


def test_departure_from_jax_image(traced):
    img = traced[0]
    ref = orc.load("inst_etex", orc.inst_inputs())["img"]
    assert np.isfinite(img).all() and ref.max() > 0.01
    diff = np.abs(img - ref)
    assert DEPARTURE_MIN <= diff.max() <= DEPARTURE_MAX, diff.max()
    assert (diff.max(-1) > PIXEL_ATOL).sum() <= DEPARTURE_PIXELS
