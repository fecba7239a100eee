"""Gradients of the port on its composed and textured paths against the
JAX package (tests/torch_oracles.py):

* the train step (arendur_tpu_torch.parallel.mesh.train_step_fn) on
  scenes the composed bounce serves: cb_etex.json (emission-textured
  sphere lights) and cb.json with the BVH intersector, against
  sharded_train_step_fn on a one-device CPU mesh (16x12, 2 spp, depth
  2, kd / ks / roughness): the loss and the gradients, read back from
  the new parameters.  The backward of K8 / K9 is autograd over
  bxdf/slots.py.  JAX's gradient is NaN where a zero cotangent meets an
  infinite partial (the vjp of slots.bsdf_eval_pdf; ROADMAP's PR 2 / PR
  4 note), so entries are held where JAX's is finite, and the port's
  must be finite everywhere;
* the gradient of the mean squared film with respect to the texture
  atlas's texels through trace_wave on tests/test_cbounce.py's textured
  quad: the port's textured split (the hit kernel, the texel lookups,
  the split shade, whose backward is autograd over the plain body)
  against JAX's jax.grad of the XLA composition, the reference of
  test_split_texel_grads_match_xla.

Tolerances: LOSS_RTOL, GRAD_RTOL and GRAD_ATOL of
tests/test_torch_train.py for the train step (measured: loss 1.1e-7
relative, gradients 2.0e-5 relative at most, roughness finite in JAX on
8 of 9 materials); TEXEL_RTOL / TEXEL_ATOL for the texels, tightened
from the JAX test's rtol 2e-2 / atol 2e-4 between its two paths
(measured: 8.3e-5 relative at most on entries past 1e-8, 5.8e-9
absolute, against a largest entry of 4.0e-3)."""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from arendur_tpu_torch import convert
from arendur_tpu_torch import scene as tsc
from arendur_tpu_torch.filming import film as tflm
from arendur_tpu_torch.io import scenedesc as tsd
from arendur_tpu_torch.parallel import mesh as tmesh
from arendur_tpu_torch.render import integrator as tint
from arendur_tpu_torch.sampling import sampler as tsmp

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_oracles as orc  # noqa: E402

torch.set_num_threads(2)

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-9
TEXEL_RTOL, TEXEL_ATOL = 1e-4, 1e-8


@pytest.fixture(scope="module", params=sorted(orc.TRAIN_SCENES))
def steps(request):
    name = request.param
    scene_path, isec = orc.TRAIN_SCENES[name]
    w, h = orc.TRAIN_RES
    n = w * h * orc.TRAIN_SPP
    ts, tcam, tfilm, tcfg, _ = tsd.parse_scene(
        scene_path, spp_override=orc.TRAIN_SPP,
        resolution_override=orc.TRAIN_RES, intersector=isec)
    tcfg = dataclasses.replace(tcfg, max_depth=orc.TRAIN_DEPTH, wave_size=n)
    ds = tsc.DeviceScene.build(ts, "cpu")
    assert ds.composed_only
    params = {k: torch.tensor(np.asarray(getattr(ts.materials, k)))
              for k in orc.PARAM_KEYS}
    step = tmesh.train_step_fn(ds, tcam, tfilm, tcfg, lr=orc.TRAIN_LR)
    new, loss = step(params, torch.tensor(orc.train_target()),
                     torch.arange(n))
    grads = {k: ((params[k] - new[k]) / orc.TRAIN_LR).numpy()
             for k in orc.PARAM_KEYS}
    return orc.load("train_" + name, orc.train_inputs(name)), loss.item(), \
        grads


def test_composed_loss_matches_jax(steps):
    ref, loss, _ = steps
    assert np.isfinite(loss) and loss > 0.0
    np.testing.assert_allclose(loss, ref["loss"], rtol=LOSS_RTOL)


@pytest.mark.parametrize("key", orc.PARAM_KEYS)
def test_composed_grads_match_jax(steps, key):
    ref, _, grads = steps
    g, gj = grads[key], ref[key]
    assert np.isfinite(g).all()
    fin = np.isfinite(gj)
    assert fin.mean() >= 0.8 and np.abs(g).max() > 0.0
    np.testing.assert_allclose(g[fin], gj[fin], rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)


def _texel_loss_grad():
    js, jcam, jfilm, jcfg, jtex = orc.textured_quad_scene()
    ds = convert.scene_from_numpy(js, "cpu")
    camera = convert.camera_from_numpy(jcam)
    film_cfg = convert.film_from_numpy(jfilm)
    atlas = convert.atlas_from_numpy(jtex)
    cfg = tint.RenderConfig(max_depth=jcfg.max_depth, spp=jcfg.spp,
                            sample_dx=jcfg.sample_dx,
                            sample_dy=jcfg.sample_dy,
                            wave_size=jcfg.wave_size,
                            rr_threshold=jcfg.rr_threshold)
    assert not ds.composed_only     # the textured split, K5 / K6's path
    w, h = film_cfg.resolution
    total = w * h * cfg.spp
    leaf = atlas.texels.clone().requires_grad_(True)
    cfg = dataclasses.replace(
        cfg, textures=dataclasses.replace(atlas, texels=leaf))
    assert cfg.textures.to("cpu").texels is leaf
    ray_idx = torch.arange(total)
    pixel_id, sample_id = ray_idx // cfg.spp, ray_idx % cfg.spp
    pxy = torch.stack([(pixel_id % w).float(), (pixel_id // w).float()], -1)
    pfilm, L = tint.trace_wave(ds, camera, cfg, pxy, pixel_id, sample_id,
                               tsmp.make_base_key(cfg.seed))
    state = tflm.film_splat(film_cfg, tflm.film_init(film_cfg, "cpu"),
                            pfilm, L, mask=ray_idx < total)
    loss = (tflm.film_finalize(state, film_cfg) ** 2).mean()
    g, = torch.autograd.grad(loss, [leaf])
    return loss.item(), g.numpy()


def test_texel_grads_match_jax():
    ref = orc.load("texel_grad", orc.texel_inputs())
    loss, g = _texel_loss_grad()
    np.testing.assert_allclose(loss, ref["loss"], rtol=LOSS_RTOL)
    assert np.isfinite(g).all() and np.abs(ref["grad"]).max() > 0.0
    assert (g != 0.0).sum() > 0
    np.testing.assert_allclose(g, ref["grad"], rtol=TEXEL_RTOL,
                               atol=TEXEL_ATOL)
