"""One rank of tests/test_torch_parallel.py's process group (not a test
file; it imports no JAX).

    python tests/torch_parallel_worker.py --init-method file:///PATH \\
        --rank R --size N --out OUT.npz

Joins the gloo group on the CPU and, for each scene of
tests/torch_oracles.py PAR_RENDER / PAR_TRAIN, runs render_sharded and
render_multihost of the render frame and one sharded_train_step_fn step
of the train frame; on the tiny scene also render_sharded with waves
whose shards are not whole pixels (the scatter splat), with a
checkpoint of each rank's share and resumed from it, and
sharded_render_fn's one wave; saves the images, the loss and the
gradients read back from the new parameters to OUT.npz.
"""

import argparse
import dataclasses
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch_oracles as orc  # noqa: E402
from arendur_tpu_torch import scene as tsc  # noqa: E402
from arendur_tpu_torch.filming import film as tflm  # noqa: E402
from arendur_tpu_torch.io import scenedesc as tsd  # noqa: E402
from arendur_tpu_torch.parallel import distributed as tdist  # noqa: E402
from arendur_tpu_torch.parallel import mesh as tmesh  # noqa: E402


def setup(name, what):
    """The port's (DeviceScene on the CPU, camera, film_cfg, config) of a
    sharded oracle's frame, and its SceneData."""
    scene, camera, film_cfg, config = orc.par_setup(
        name, what, tsc, tsd.parse_scene, tdist._tiny_setup)
    return tsc.DeviceScene.build(scene, "cpu"), camera, film_cfg, config, \
        scene


def train_step(name, mesh):
    """One step of the train frame over `mesh`: (loss, {key: (p - p_new)
    / lr})."""
    ds, camera, film_cfg, config, scene = setup(name, "train")
    p = orc.PAR_TRAIN[name]
    w, h = p["res"]
    params = {k: torch.tensor(np.asarray(getattr(scene.materials, k)))
              for k in p["keys"]}
    step = tmesh.sharded_train_step_fn(ds, camera, film_cfg, config, mesh,
                                       lr=p["lr"])
    arg = params["kd"] if p["keys"] == ("kd",) else params
    new, loss = step(arg, torch.tensor(orc.train_target(p["res"],
                                                        p["target"])),
                     torch.arange(w * h * p["spp"]))
    if p["keys"] == ("kd",):
        new = {"kd": new}
    return loss.item(), {k: ((params[k] - new[k]) / p["lr"]).numpy()
                         for k in p["keys"]}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--init-method", required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--size", type=int, required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    torch.set_num_threads(2)
    mesh = tdist.init_distributed(
        num_processes=args.size, process_id=args.rank,
        init_method=args.init_method, device="cpu", timeout_s=120)
    out = {"size": np.asarray(mesh.size), "rank": np.asarray(mesh.rank)}
    try:
        for name in orc.PAR_RENDER:
            ds, camera, film_cfg, config, _ = setup(name, "render")
            out[f"{name}_sharded"] = tmesh.render_sharded(
                ds, camera, film_cfg, config, mesh).numpy()
            out[f"{name}_multihost"] = tdist.render_multihost(
                ds, camera, film_cfg, config)
        ds, camera, film_cfg, config, _ = setup("tiny", "render")
        # waves whose shards are not whole pixels: the scatter splat
        out["tiny_scatter"] = tmesh.render_sharded(
            ds, camera, film_cfg, dataclasses.replace(config, wave_size=200),
            mesh).numpy()
        # a checkpoint of this rank's share, then a render resumed from it
        ck = os.path.join(os.path.dirname(os.path.abspath(args.out)),
                          f"ck_{mesh.rank}.npz")
        for key in ("tiny_ckpt", "tiny_resumed"):
            out[key] = tmesh.render_sharded(
                ds, camera, film_cfg, config, mesh, checkpoint_path=ck,
                checkpoint_every=1).numpy()
        # sharded_render_fn's one wave, finalized
        out["tiny_fn"] = tflm.film_finalize(tmesh.sharded_render_fn(
            ds, camera, film_cfg, config, mesh)(0), film_cfg).numpy()
        for name in orc.PAR_TRAIN:
            loss, grads = train_step(name, mesh)
            out[f"{name}_loss"] = np.asarray(loss)
            out.update({f"{name}_{k}": g for k, g in grads.items()})
    finally:
        torch.distributed.destroy_process_group()
    np.savez(args.out, **out)


if __name__ == "__main__":
    main()
