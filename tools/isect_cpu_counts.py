"""Count the cluster closest-hit / any-hit kernels' (K1 / K2) work per
query of a fused wave on the CPU: counts, not device times.

    python tools/isect_cpu_counts.py

One plain-path wave of the Cornell box (examples/cornellbox/cb.json) at
256x256, 16 spp, depth 8: its first 8,192 lanes (pixels 0-511), their
9 closest-hit and 8 any-hit queries recorded by render/fuzz.py
wave_queries.  Each query goes through K1 / K2's per-thread loop built
for the host (kernels/host_isect.py), which gives, per ray and cluster,
the 64-triangle chunks the ray needs (none where its slab test fails
against its running bound).  Per query: the live rays, the (ray,
cluster) pairs the rays need ("ray"), and the pairs a culling grain of
G consecutive rays computes (G times the clusters any of them needs;
32 rays: a block of the kernels, one ray a thread; 64: two rays a
thread; 256: the first version's block) with their ratio to the rays'
own; for the any hit, the chunks the 32-ray blocks compute without and
with leaving a cluster once all its wanting rays are blocked.  Also checks the host build's
results against the recorded plain ones.  Prints one JSON object per
query.
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
GRAINS = (32, 64, 256)
WARP = 32   # rays of a block: the kernels' culling grain


def grain_pairs(wanted, grain):
    """Pairs computed when a grain of `grain` consecutive rays tests each
    cluster any of its rays needs: wanted [N, C] bool."""
    n, c = wanted.shape
    pad = (-n) % grain
    w = np.concatenate([wanted, np.zeros((pad, c), bool)])
    return int(grain * w.reshape(-1, grain, c).any(1).sum())


def main():
    import torch
    from arendur_tpu_torch import scene as sc
    from arendur_tpu_torch.io import scenedesc
    from arendur_tpu_torch.kernels import host_isect
    from arendur_tpu_torch.render import fuzz
    from arendur_tpu_torch.render import integrator as integ

    scene, camera, film, config, _ = scenedesc.parse_scene(
        os.path.join(REPO, "examples/cornellbox/cb.json"),
        spp_override=16, resolution_override=(256, 256))
    config = dataclasses.replace(config, max_depth=8, wave_size=LANES)
    ds = sc.DeviceScene.build(scene, "cpu")
    queries = fuzz.wave_queries(ds, camera, film, config, integ.PLAIN_OPS)
    per = ds.cw.shape[2] // 4 // host_isect.CHUNK
    with tempfile.TemporaryDirectory() as tmp:
        fn = host_isect.build(tmp)
        if fn is None:
            raise SystemExit("isect_cpu_counts: no host C++ compiler (g++)")
        seen = {"closest": 0, "any": 0}
        for q in queries:
            anyhit = q["kind"] == "any"
            n = q["o"].shape[0]
            na = n if q["n_alive"] is None else int(q["n_alive"])
            t, out, need = host_isect.run(
                fn, anyhit, ds.cw, ds.cbox, q["o"], q["d"], q["tmax"], na,
                q["period"], q["sph_tab"], q["full_phi"])
            same = bool(np.array_equal(out, q["blocked"].numpy())) \
                if anyhit else bool(np.array_equal(out, q["slot"].numpy())
                                    and np.array_equal(t, q["t"].numpy()))
            wanted = need > 0
            ray = int(wanted.sum())
            # bounce 8 of the closest hit: the final deferred-MIS query
            row = dict(query=q["kind"], bounce=seen[q["kind"]], live=na,
                       equal_to_plain=same, pairs_ray=ray)
            seen[q["kind"]] += 1
            for g in GRAINS:
                pairs = grain_pairs(wanted, g)
                row[f"pairs_{g}"] = pairs
                row[f"ratio_{g}"] = pairs / max(ray, 1)
            if anyhit:
                pad = (-n) % WARP
                nw = np.concatenate([need, np.zeros((pad, need.shape[1]),
                                                    need.dtype)])
                warp_need = nw.reshape(-1, WARP, need.shape[1]).max(1)
                row["block_chunks_full"] = int(per * (warp_need > 0).sum())
                row["block_chunks_exit"] = int(warp_need.sum())
            print(json.dumps(row), flush=True)
            if not same:
                raise SystemExit("the host build disagrees with the plain "
                                 "path")


if __name__ == "__main__":
    main()
