"""The port's train step (arendur_tpu_torch.parallel.mesh.train_step_fn)
against the JAX package's sharded_train_step_fn on a one-device CPU
mesh, at the dry-run size of __graft_entry__ (Cornell 16x12, 2 spp,
depth 2), with kd, ks and roughness: the loss and the new parameters.

JAX's roughness gradient is NaN for the glass material (the square root
of Lambda's projected roughness at w = (0, 0, +-1) has an infinite
derivative; render/cmath.py _sqrt_nz in the port), so roughness is held
where JAX's is finite and must be finite everywhere in the port."""

import dataclasses
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from arendur_tpu.io import scenedesc as jsd
from arendur_tpu.parallel import mesh as jmesh
from arendur_tpu_torch import scene as tsc
from arendur_tpu_torch.io import scenedesc as tsd
from arendur_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CB = os.path.join(REPO, "examples/cornellbox/cb.json")
RES, SPP, DEPTH = (16, 12), 2, 2
# a step large enough that (p - p_new) / lr keeps the gradient to f32
# precision (at the default 0.05 it rounds to ulp(p) / 0.05 ~ 1e-6)
LR = 1e3
LOSS_RTOL = 1e-5           # same paths, f32 sums in another order
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-9   # (p - p_new) / lr, per entry


@pytest.fixture(scope="module")
def steps():
    w, h = RES
    n = w * h * SPP
    js, jcam, jfilm, jcfg, _ = jsd.parse_scene(
        CB, spp_override=SPP, resolution_override=RES)
    jcfg = dataclasses.replace(jcfg, max_depth=DEPTH, wave_size=n)
    mesh = Mesh(np.array(jax.devices()[:1]), (jmesh.AXIS,))
    m = js.materials
    params = {"kd": np.asarray(m.kd), "ks": np.asarray(m.ks),
              "roughness": np.asarray(m.roughness)}
    target = np.random.default_rng(0).uniform(
        0.0, 0.5, (w * h, 3)).astype(np.float32)
    jstep = jmesh.sharded_train_step_fn(js, jcam, jfilm, jcfg, mesh, lr=LR)
    jnew, jloss = jstep({k: jnp.asarray(v) for k, v in params.items()},
                        jnp.asarray(target),
                        jnp.arange(n, dtype=jnp.int32))
    ts, tcam, tfilm, tcfg, _ = tsd.parse_scene(
        CB, spp_override=SPP, resolution_override=RES)
    tcfg = dataclasses.replace(tcfg, max_depth=DEPTH, wave_size=n)
    tstep = tmesh.train_step_fn(tsc.DeviceScene.build(ts, "cpu"), tcam,
                                tfilm, tcfg, lr=LR)
    tnew, tloss = tstep({k: torch.tensor(v) for k, v in params.items()},
                        torch.tensor(target), torch.arange(n))
    grad = lambda new: {k: (params[k] - np.asarray(new[k])) / LR
                        for k in params}
    return (float(jloss), grad(jnew)), (tloss.item(),
                                        grad({k: v.numpy()
                                              for k, v in tnew.items()}))


def test_loss_matches_jax(steps):
    (jloss, _), (tloss, _) = steps
    assert np.isfinite(tloss) and tloss > 0.0
    np.testing.assert_allclose(tloss, jloss, rtol=LOSS_RTOL)


@pytest.mark.parametrize("key", ["kd", "ks", "roughness"])
def test_new_params_match_jax(steps, key):
    (_, jg), (_, tg) = steps
    g, gj = tg[key], jg[key]
    assert np.isfinite(g).all()
    fin = np.isfinite(gj)
    assert fin.mean() >= 0.8 and np.abs(g).max() > 0.0
    np.testing.assert_allclose(g[fin], gj[fin], rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
