"""The port's sharded render and train step over torch.distributed
(arendur_tpu_torch/parallel/mesh.py, parallel/distributed.py) against
the JAX package's on a 2-device mesh (tests/torch_oracles.py par_*:
JAX's 2-device compiles take minutes).

Two gloo processes on the CPU (tests/torch_parallel_worker.py, joined by
a file:// rendezvous under tmp_path) render and take one train step on
tests/test_parallel.py's tiny scene (render 8x8, 8 spp, depth 2; step
4 spp, depth 1, a bare kd, lr 1, target 0) and on cb.json (32x24, 4 spp,
depth 3; step kd / ks / roughness, lr 1e3):

* render_sharded against JAX's render_sharded on 2 devices, and
  render_multihost against JAX's single-process render (the check of
  tests/test_distributed.py): per pixel atol 1e-5 / rtol 1e-4, the gate
  of tests/test_parallel.py; both ranks' outputs equal within 1e-7;
* the step against JAX's on 2 devices: loss rtol 1e-5, (p - p_new) / lr
  rtol 1e-3 (roughness where JAX's is finite), and against the one-rank
  train_step_fn on the whole wave, with no factor of the world size;
* with no process group, render_sharded equals integrator.render and
  sharded_train_step_fn equals train_step_fn;
* on the tiny scene, waves whose shards are not whole pixels (the
  scatter splat) against JAX's render_sharded, and a render that
  checkpoints each rank's share, one resumed from it and
  sharded_render_fn's one wave against render_sharded, to the bit; a
  rank does not resume from another rank's checkpoint.

Measured (my CPU run): the tiny renders within 1.5e-7 of JAX's, cb.json's
within 1.9e-5 (JAX's own sharded and single-process renders differ by
1.4e-5 there); the tiny step equal to JAX's to the bit (kd gradient
[0.6603657, 0.5503048, 0.44024378], loss 0.42373466), cb.json's loss
within 1.1e-7 and its gradients within 5.4e-4 relative on entries past
1e-6 (5.4e-8 absolute)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from arendur_tpu_torch.parallel import distributed as tdist
from arendur_tpu_torch.parallel import mesh as tmesh
from arendur_tpu_torch.render import integrator as tint

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_oracles as orc  # noqa: E402
import torch_parallel_worker as wk  # noqa: E402

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
IMG_RTOL, IMG_ATOL = 1e-4, 1e-5     # tests/test_parallel.py
RANK_ATOL = 1e-7                    # tests/test_distributed.py
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-9   # (p - p_new) / lr, per entry
SIZE = orc.PAR_DEVICES


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' outputs (torch_parallel_worker.py), rank order."""
    tmp = tmp_path_factory.mktemp("gloo")
    init = "file://" + str(tmp / "rendezvous")
    outs = [str(tmp / f"rank{r}.npz") for r in range(SIZE)]
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_parallel_worker.py"),
         "--init-method", init, "--rank", str(r), "--size", str(SIZE),
         "--out", outs[r]], env=env) for r in range(SIZE)]
    try:
        rcs = [p.wait(timeout=180) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert rcs == [0] * SIZE, rcs
    return [dict(np.load(o)) for o in outs]


def test_ranks_form_the_group(ranks):
    assert [int(r["rank"]) for r in ranks] == list(range(SIZE))
    assert all(int(r["size"]) == SIZE for r in ranks)


@pytest.mark.parametrize("key", ["tiny_sharded", "tiny_multihost",
                                 "tiny_scatter", "cb_sharded",
                                 "cb_multihost", "tiny_loss",
                                 "tiny_kd", "cb_loss", "cb_kd", "cb_ks",
                                 "cb_roughness"])
def test_ranks_agree(ranks, key):
    """The film and the gradients are summed over the ranks: every rank
    returns the same image, loss and parameters."""
    for r in ranks[1:]:
        np.testing.assert_allclose(r[key], ranks[0][key], rtol=0.0,
                                   atol=RANK_ATOL)


@pytest.mark.parametrize("name", list(orc.PAR_RENDER))
def test_render_sharded_matches_jax(ranks, name):
    ref = orc.load("par_render_" + name, orc.par_render_inputs(name))
    img = ranks[0][name + "_sharded"]
    assert img.shape == ref["sharded"].shape and img.max() > 0.05
    np.testing.assert_allclose(img, ref["sharded"], rtol=IMG_RTOL,
                               atol=IMG_ATOL)


@pytest.mark.parametrize("name", list(orc.PAR_RENDER))
def test_render_multihost_matches_jax_render(ranks, name):
    ref = orc.load("par_render_" + name, orc.par_render_inputs(name))
    np.testing.assert_allclose(ranks[0][name + "_multihost"], ref["single"],
                               rtol=IMG_RTOL, atol=IMG_ATOL)


def test_render_scatter_waves_match_jax(ranks):
    """Waves of 200 rays: each rank's shard of 100 rays is not whole
    pixels (8 spp), so the ranks splat by scatter."""
    ref = orc.load("par_render_tiny", orc.par_render_inputs("tiny"))
    np.testing.assert_allclose(ranks[0]["tiny_scatter"], ref["sharded"],
                               rtol=IMG_RTOL, atol=IMG_ATOL)


@pytest.mark.parametrize("key", ["tiny_ckpt", "tiny_resumed", "tiny_fn"])
def test_sharded_variants_equal_render_sharded(ranks, key):
    """A render that checkpoints each rank's share of the film, one
    resumed from those files, and sharded_render_fn's one wave
    finalized all equal render_sharded to the bit."""
    for r in ranks:
        np.testing.assert_array_equal(r[key], r["tiny_sharded"])


def test_checkpoint_of_another_rank_is_not_resumed(tmp_path):
    """A checkpoint holds one rank's share of the film: a rank of
    another index does not resume from it."""
    ds, camera, film_cfg, config, _ = wk.setup("tiny", "render")
    ck = str(tmp_path / "ck.npz")
    share = [tmesh.RayMesh(None, r, 2, torch.device("cpu")) for r in (0, 1)]
    tint.render(ds, camera, film_cfg, config, mesh=share[0],
                checkpoint_path=ck)
    got = tint.render(ds, camera, film_cfg, config, mesh=share[1],
                      checkpoint_path=ck)
    ref = tint.render(ds, camera, film_cfg, config, mesh=share[1])
    assert not torch.equal(got, tint.render(ds, camera, film_cfg, config,
                                            mesh=share[0]))
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


def _grads_close(g, gj, name):
    assert np.isfinite(g).all() and np.abs(g).max() > 0.0, name
    fin = np.isfinite(gj)
    assert fin.mean() >= 0.8, name
    np.testing.assert_allclose(g[fin], gj[fin], rtol=GRAD_RTOL,
                               atol=GRAD_ATOL, err_msg=name)


@pytest.mark.parametrize("name", list(orc.PAR_TRAIN))
def test_train_step_matches_jax(ranks, name):
    ref = orc.load("par_train_" + name, orc.par_train_inputs(name))
    loss = float(ranks[0][name + "_loss"])
    assert np.isfinite(loss) and loss > 0.0
    np.testing.assert_allclose(loss, ref["loss"], rtol=LOSS_RTOL)
    for k in orc.PAR_TRAIN[name]["keys"]:
        _grads_close(ranks[0][f"{name}_{k}"], ref[k], f"{name} {k}")


@pytest.fixture(scope="module")
def one_rank_steps():
    """train_step_fn (no collective) on each train frame's whole wave."""
    one = tmesh.RayMesh(None, 0, 1, torch.device("cpu"))
    return {name: wk.train_step(name, one) for name in orc.PAR_TRAIN}


@pytest.mark.parametrize("name", list(orc.PAR_TRAIN))
def test_train_step_equals_one_rank_step(ranks, one_rank_steps, name):
    """Summing each rank's share of the gradient once gives the one-rank
    gradient of the whole wave: no factor of the world size."""
    loss1, grads1 = one_rank_steps[name]
    np.testing.assert_allclose(float(ranks[0][name + "_loss"]), loss1,
                               rtol=LOSS_RTOL)
    for k, g1 in grads1.items():
        _grads_close(ranks[0][f"{name}_{k}"], g1, f"{name} {k}")


def test_tiny_kd_gradient_reads_as_jax_devices():
    """JAX's 2-device step reads (kd - kd_new) / lr for material 0 as its
    1- and 8-device steps do (JAX 0.9.0 on the CPU)."""
    ref = orc.load("par_train_tiny", orc.par_train_inputs("tiny"))
    np.testing.assert_allclose(ref["kd"][0], [0.660366, 0.550305, 0.440244],
                               rtol=5e-6)
    np.testing.assert_allclose(ref["loss"], 0.4237347, rtol=1e-6)


@pytest.mark.parametrize("name", list(orc.PAR_RENDER))
def test_one_rank_render_equals_render(name):
    assert not torch.distributed.is_initialized()
    ds, camera, film_cfg, config, _ = wk.setup(name, "render")
    mesh = tmesh.make_ray_mesh(device="cpu")
    assert (mesh.group, mesh.rank, mesh.size) == (None, 0, 1)
    img = tmesh.render_sharded(ds, camera, film_cfg, config, mesh)
    ref = tint.render(ds, camera, film_cfg, config)
    np.testing.assert_array_equal(img.numpy(), ref.numpy())


def test_one_rank_step_equals_train_step_fn():
    ds, camera, film_cfg, config, scene = wk.setup("cb", "train")
    p = orc.PAR_TRAIN["cb"]
    w, h = p["res"]
    params = {k: torch.tensor(np.asarray(getattr(scene.materials, k)))
              for k in p["keys"]}
    target = torch.tensor(orc.train_target(p["res"], p["target"]))
    ray_idx = torch.arange(w * h * p["spp"])
    mesh = tmesh.make_ray_mesh(device="cpu")
    a, la = tmesh.sharded_train_step_fn(ds, camera, film_cfg, config, mesh,
                                        lr=p["lr"])(params, target, ray_idx)
    b, lb = tmesh.train_step_fn(ds, camera, film_cfg, config,
                                lr=p["lr"])(params, target, ray_idx)
    assert la.item() == lb.item()
    for k in p["keys"]:
        assert torch.equal(a[k], b[k]), k


def test_mesh_checks():
    mesh = tmesh.make_ray_mesh(device="cpu")
    t = torch.arange(4.0)
    assert mesh.all_reduce_(t) is t and torch.equal(t, torch.arange(4.0))
    two = tmesh.RayMesh(None, 1, 2, torch.device("cpu"))
    assert torch.equal(two.shard(torch.arange(6)), torch.tensor([3, 4, 5]))
    with pytest.raises(ValueError, match="does not divide"):
        two.shard(torch.arange(5))
    ds, camera, film_cfg, config, _ = wk.setup("tiny", "render")
    card = tmesh.RayMesh(None, 0, 1, torch.device("cuda", 0))
    with pytest.raises(ValueError, match="lies on"):
        tmesh.render_sharded(ds, camera, film_cfg, config, card)


def test_selftest_two_processes(capsys):
    """The module's own self-test: two workers of
    ``python -m arendur_tpu_torch.parallel.distributed --worker`` on the
    CPU render the tiny scene; both images equal."""
    assert tdist.main(["--selftest", "--device", "cpu"]) == 0
    assert "selftest images equal: True" in capsys.readouterr().out
