"""The cluster intersection module (kernels K1/K2) against the JAX
package: the plain PyTorch versions against the Pallas kernels in
interpret mode and against the XLA determinant products, on the
Cornell clusters.  The CUDA kernels themselves are held against the
plain versions on the card in tests/test_torch_gpu.py."""

import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from arendur_tpu.io import scenedesc as jsd
from arendur_tpu.shapes import mxu_intersect as jmxi
from arendur_tpu.shapes import pallas_intersect as pli
from arendur_tpu_torch import convert
from arendur_tpu_torch.shapes import cluster_intersect as ci

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 512
SLOT_GATE = 0.999    # share of lanes whose slots agree
T_RTOL = 1e-5        # t where the slots agree (f32 dot-product order)


@pytest.fixture(scope="module")
def setup():
    js, jcam, *_ = jsd.parse_scene(
        os.path.join(REPO, "examples/cornellbox/cb.json"),
        resolution_override=(32, 16))
    ds = convert.scene_from_numpy(js, "cpu")
    rng = np.random.default_rng(0)
    # half camera rays through the film, half secondary rays inside
    # the box with random directions
    from arendur_tpu_torch.filming import camera as tcam
    cam = convert.camera_from_numpy(jcam)
    pfilm = torch.tensor(rng.uniform(0, 1, (N // 2, 2)) * [32, 16],
                         dtype=torch.float32)
    oc, dc = tcam.generate_rays(cam, pfilm, torch.zeros(N // 2, 2))
    os_ = rng.uniform([-1.9, -1.4, 2.1], [1.9, 2.4, 5.9], (N // 2, 3))
    ds_ = rng.normal(size=(N // 2, 3))
    ds_ /= np.linalg.norm(ds_, axis=-1, keepdims=True)
    o = np.concatenate([oc.numpy(), os_]).astype(np.float32)
    d = np.concatenate([dc.numpy(), ds_]).astype(np.float32)
    tmax = rng.uniform(0.2, 6.0, N).astype(np.float32)
    return dict(js=js, ds=ds, o=o, d=d, tmax=tmax)


def _closest_gate(t_ref, s_ref, t, s):
    t_ref, s_ref = np.asarray(t_ref), np.asarray(s_ref)
    agree = s_ref == s
    assert agree.mean() >= SLOT_GATE, agree.mean()
    hit = agree & (s >= 0)
    np.testing.assert_allclose(t[hit], t_ref[hit], rtol=T_RTOL)
    return hit.mean()


@pytest.mark.parametrize("n_alive", [None, 300])
def test_closest_matches_pallas_interpret(setup, n_alive):
    js, ds = setup["js"], setup["ds"]
    o, d = setup["o"], setup["d"]
    inf = np.full(N, np.inf, np.float32)
    na = None if n_alive is None else jnp.int32(n_alive)
    t_ref, s_ref = pli.intersect_clusters(
        jnp.asarray(js.tri_cw), jnp.asarray(js.tri_cbox), jnp.asarray(o),
        jnp.asarray(d), jnp.asarray(inf), n_alive=na, interpret=True)
    t, s = ci.intersect_clusters(
        ds.cw, ds.cbox, torch.tensor(o), torch.tensor(d), torch.tensor(inf),
        n_alive=None if n_alive is None else torch.tensor(n_alive))
    hit_share = _closest_gate(t_ref, s_ref, t.numpy(), s.numpy())
    assert hit_share > 0.3
    if n_alive is not None:
        assert (s.numpy()[n_alive:] == -1).all()


def test_closest_matches_mxu(setup):
    js, ds = setup["js"], setup["ds"]
    o, d, tmax = setup["o"], setup["d"], setup["tmax"]
    k = js.tri_cw.shape[-1] // 4
    t_ref, s_ref, _, _ = jmxi.intersect_mxu(
        jnp.asarray(js.tri_cw), jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(tmax), js.tri_cw.shape[0] * k, chunk=k)
    t, s = ci.intersect_clusters_reference(
        ds.cw, ds.cbox, torch.tensor(o), torch.tensor(d), torch.tensor(tmax))
    _closest_gate(t_ref, s_ref, t.numpy(), s.numpy())


@pytest.mark.parametrize("n_alive", [None, 300])
def test_anyhit_matches_pallas_interpret_and_mxu(setup, n_alive):
    js, ds = setup["js"], setup["ds"]
    o, d, tmax = setup["o"], setup["d"], setup["tmax"]
    na = None if n_alive is None else jnp.int32(n_alive)
    b_ref = np.asarray(pli.occluded_clusters(
        jnp.asarray(js.tri_cw), jnp.asarray(js.tri_cbox), jnp.asarray(o),
        jnp.asarray(d), jnp.asarray(tmax), n_alive=na, interpret=True))
    b = ci.occluded_clusters(
        ds.cw, ds.cbox, torch.tensor(o), torch.tensor(d),
        torch.tensor(tmax),
        n_alive=None if n_alive is None else torch.tensor(n_alive)).numpy()
    assert (b == b_ref).mean() >= SLOT_GATE
    assert 0.05 < b.mean() < 0.95
    if n_alive is None:
        k = js.tri_cw.shape[-1] // 4
        b_mxu = np.asarray(jmxi.occluded_mxu(
            jnp.asarray(js.tri_cw), jnp.asarray(o), jnp.asarray(d),
            jnp.asarray(tmax), js.tri_cw.shape[0] * k, chunk=k))
        assert (b == b_mxu).mean() >= SLOT_GATE
    else:
        assert not b[n_alive:].any()


def test_results_are_detached(setup):
    ds = setup["ds"]
    o = torch.tensor(setup["o"], requires_grad=True)
    t, _ = ci.intersect_clusters(ds.cw, ds.cbox, o, torch.tensor(setup["d"]),
                                 torch.full((N,), float("inf")))
    assert not t.requires_grad
