"""Count the bounce-shade backward's (K4) work per bounce of a train step
on the CPU: counts, not device times.

    python tools/k4_cpu_counts.py

One plain-path train step (parallel/mesh.py, kd only) on the Cornell
box (examples/cornellbox/cb.json) at 256x256, 16 spp, depth 8, on its
first 8,192 lanes, kd at 1.25x its table value against the plain
path's 1-spp image, its bounce inputs and cotangents recorded by
render/fuzz.py train_step_bounces.  Per bounce, with K4's
per-lane code built for the host (kernels/host_bwd.py): the inactive
lanes (alive and hit not both set), the tape nodes per lane were every
lane taped (a random cotangent in every column; a lane's node count
depends on its forward alone), their mean over live and inactive
lanes, the sum of each 32-lane warp's largest count over the sum of
the counts (1 where the lanes of every warp tape alike), and the lanes
that need no body under the step's own cotangent.  Prints one JSON
object per bounce.
"""

import dataclasses
import json
import os
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
LANES = 8192


def main():
    import torch
    from arendur_tpu_torch import scene as sc
    from arendur_tpu_torch.io import scenedesc
    from arendur_tpu_torch.kernels import host_bwd
    from arendur_tpu_torch.render import cbounce as cb
    from arendur_tpu_torch.render import fuzz
    from arendur_tpu_torch.render import integrator as integ

    scene, camera, film, config, _ = scenedesc.parse_scene(
        os.path.join(REPO, "examples/cornellbox/cb.json"),
        spp_override=16, resolution_override=(256, 256))
    config = dataclasses.replace(config, max_depth=8, wave_size=1 << 16)
    ds = sc.DeviceScene.build(scene, "cpu")
    # the target: the plain path's image at 1 spp, in waves of 8,192
    target = integ.render(
        ds, camera, film, dataclasses.replace(
            config, spp=1, sample_dx=1, sample_dy=1, wave_size=8192),
        ops=integ.PLAIN_OPS).reshape(-1, 3)
    bounces = fuzz.train_step_bounces(ds, camera, film, config,
                                      integ.PLAIN_OPS, target,
                                      torch.arange(LANES))
    cfg = (ds.static, config.min_depth, config.rr_threshold)
    with tempfile.TemporaryDirectory() as tmp:
        fn = host_bwd.build(tmp)
        if fn is None:
            raise SystemExit("k4_cpu_counts: no host C++ compiler (g++)")
        for b, r in enumerate(bounces):
            xt, tabs = r["xt"], (r["ltab"], r["mtab"], r["stab"])
            every = torch.tensor(np.random.default_rng(b).normal(
                size=tuple(r["ct"].shape)).astype(np.float32))
            nodes = host_bwd.run(fn, xt, every, *tabs, *cfg)[5]
            need = host_bwd.run(fn, xt, r["ct"], *tabs, *cfg)[4]
            live = ((xt[cb.C_ALIVE] > 0.5) & (xt[cb.C_HIT] > 0.5)).numpy()
            warps = nodes[:len(nodes) // 32 * 32].reshape(-1, 32)
            mean = lambda m: float(nodes[m].mean()) if m.any() else None
            print(json.dumps(dict(
                bounce=b, lanes=len(nodes), inactive=int((~live).sum()),
                nodes_mean=float(nodes.mean()), nodes_mean_live=mean(live),
                nodes_mean_inactive=mean(~live),
                warp_max_ratio=float(32 * warps.max(1).sum() / warps.sum()),
                no_body=int((~need).sum()))), flush=True)


if __name__ == "__main__":
    main()
