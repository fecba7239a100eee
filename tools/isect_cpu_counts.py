"""Count the cluster closest-hit / any-hit kernels' (K1 / K2) work per
query of a fused wave on the CPU: counts, not device times.

    python tools/isect_cpu_counts.py [--scene PATH] [--lanes N] [--wave W]

One plain-path wave of a scene (default examples/cornellbox/cb.json) at
256x256, 16 spp, depth 8: wave W (default 0) of N lanes (default
8,192: pixels 0-511), its closest-hit and any-hit queries recorded by
render/fuzz.py wave_queries.  Each world query goes through K1 / K2's
per-thread loop built for the host (kernels/host_isect.py), which
gives, per ray and cluster, the 64-triangle chunks the ray needs (none
where its slab test fails against its running bound).  Per query: the
live rays, the (ray, cluster) pairs the rays need ("ray"), and the
pairs a culling grain of G consecutive rays computes (G times the
clusters any of them needs; 32 rays: a block of the kernels, one ray a
thread; 64: two rays a thread; 256: the first version's block) with
their ratio to the rays' own; for the any hit, the chunks the 32-ray
blocks compute without and with leaving a cluster once all its wanting
rays are blocked.

A scene with an instanced mesh (--scene
examples/cornellbox/cb_inst.json) adds, per instanced query, the work
of the instanced entries (the per-ray loop of kernels/intersect.cu
instanced_kernel, host_isect.run_instanced) beside the earlier route's
(one K1 / K2 over the [I * N] (instance, ray) lanes with period N,
host_isect.run): the lanes the earlier route launches and its live
ones; the (ray, instance) pairs whose padded world box the ray enters
(at its running bound: "box_pairs", and at the query's fixed bound);
the (ray, instance, cluster) pairs the rays need ("need_pairs") and
the chunks; what the 32-ray blocks compute, in (ray, instance,
cluster) pairs and in chunks (the any hit: without and with the early
exits: a ray leaves the instance walk at the first instance that
blocks it, a block leaves a cluster once its wanting rays are blocked);
and the same counts of the earlier route's 32-lane blocks.  Also
checks the host builds' results against the recorded plain ones.
Prints one JSON object per query.
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
    if c == 0:
        return 0
    pad = (-n) % grain
    w = np.concatenate([wanted, np.zeros((pad, c), bool)])
    return int(grain * w.reshape(-1, grain, c).any(1).sum())


def block_counts(need, per, exits):
    """What blocks of WARP consecutive rays compute of need [N, P]
    (chunks each ray needs of each of P units, cluster or (instance,
    cluster)): (pairs: WARP times the units any ray of the block
    needs, chunks: per such unit the most chunks any of its rays needs
    where `exits`, else `per`)."""
    n, p = need.shape
    pad = (-n) % WARP
    nw = np.concatenate([need, np.zeros((pad, p), need.dtype)])
    unit = nw.reshape(-1, WARP, p).max(1)
    return (int(WARP * (unit > 0).sum()),
            int(unit.sum() if exits else per * (unit > 0).sum()))


def instanced_row(fn, q, per):
    """The counts of one instanced query (the module's docstring), and
    whether both host builds equal the recorded plain results."""
    import torch
    from arendur_tpu_torch.kernels import host_isect
    from arendur_tpu_torch.shapes import cluster_intersect as ci
    anyhit = q["kind"] == "any_instanced"
    w, cbox, itab = q["w"], q["cbox"], q["itab"]
    o, d, bound = q["o"], q["d"], q["tmax"]
    n, ni, c = o.shape[0], itab.shape[0], w.shape[0]
    na = n if q["n_alive"] is None else int(q["n_alive"])
    t, out, inst, (ibox, need) = host_isect.run_instanced(
        fn, anyhit, w, cbox, itab, o, d, bound, na, q["blocked_in"])
    same = bool(np.array_equal(out, q["blocked"].numpy())) if anyhit \
        else bool(np.array_equal(out, q["slot"].numpy())
                  and np.array_equal(inst, q["inst"].numpy())
                  and np.array_equal(t, q["t"].numpy()))
    # the earlier route: [I * N] lanes, period N, each bounded by the
    # query's bound
    ol, dl = ci.instance_frame(itab[:, None], o[None], d[None])
    _, out_f, need_f = host_isect.run(
        fn, anyhit, w, cbox, ol.reshape(-1, 3), dl.reshape(-1, 3),
        bound.repeat(ni), na, n)
    if anyhit:
        old = out_f.reshape(ni, n).any(0)
        if q["blocked_in"] is not None:
            old = old | (q["blocked_in"].numpy() & (np.arange(n) < na))
        same = same and bool(np.array_equal(old, out))
    fixed = ci.instance_box_mask(itab, o[:na], d[:na], bound[:na])
    flat = need.reshape(n, ni * c)
    row = dict(query=q["kind"], live=na, equal_to_plain=same,
               old_lanes=ni * n, old_live_lanes=ni * na,
               box_pairs=int(ibox.sum()), box_pairs_fixed=int(fixed.sum()),
               need_pairs=int((need > 0).sum()), need_chunks=int(need.sum()),
               old_need_pairs=int((need_f > 0).sum()),
               old_need_chunks=int(need_f.sum()))
    row["block_pairs"], row["block_chunks"] = block_counts(flat, per, True)
    row["old_block_pairs"], row["old_block_chunks"] = block_counts(
        need_f, per, True)
    if anyhit:
        row["block_chunks_no_exit"] = block_counts(flat, per, False)[1]
        row["old_block_chunks_no_exit"] = block_counts(need_f, per,
                                                       False)[1]
        row["world_blocked"] = 0 if q["blocked_in"] is None \
            else int(q["blocked_in"][:na].sum())
        row["blocked"] = int(out[:na].sum())
    else:
        row["hit"] = int((out[:na] >= 0).sum())
    return row, same


def main(argv=None):
    import argparse
    import torch
    from arendur_tpu_torch import scene as sc
    from arendur_tpu_torch.io import scenedesc
    from arendur_tpu_torch.kernels import host_isect
    from arendur_tpu_torch.render import fuzz
    from arendur_tpu_torch.render import integrator as integ

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default=os.path.join(
        REPO, "examples/cornellbox/cb.json"))
    ap.add_argument("--lanes", type=int, default=LANES)
    ap.add_argument("--wave", type=int, default=0)
    args = ap.parse_args(argv)
    torch.set_num_threads(max(1, min(4, os.cpu_count() or 1)))
    scene, camera, film, config, _ = scenedesc.parse_scene(
        args.scene, spp_override=16, resolution_override=(256, 256))
    config = dataclasses.replace(config, max_depth=8, wave_size=args.lanes)
    ds = sc.DeviceScene.build(scene, "cpu")
    queries = fuzz.wave_queries(ds, camera, film, config, integ.PLAIN_OPS,
                                args.wave)
    with tempfile.TemporaryDirectory() as tmp:
        fn = host_isect.build(tmp)
        if fn is None:
            raise SystemExit("isect_cpu_counts: no host C++ compiler (g++)")
        seen = {}
        for q in queries:
            # bounce 8 of the closest hit: the final deferred-MIS query
            bounce = seen.get(q["kind"], 0)
            seen[q["kind"]] = bounce + 1
            if q["kind"].endswith("_instanced"):
                per = q["w"].shape[2] // 4 // host_isect.CHUNK
                row, same = instanced_row(fn, q, per)
                print(json.dumps(dict(row, bounce=bounce)), flush=True)
                if not same:
                    raise SystemExit("the host builds disagree with the "
                                     "plain path")
                continue
            per = ds.cw.shape[2] // 4 // host_isect.CHUNK
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
            row = dict(query=q["kind"], bounce=bounce, live=na,
                       equal_to_plain=same, pairs_ray=ray)
            for g in GRAINS:
                pairs = grain_pairs(wanted, g)
                row[f"pairs_{g}"] = pairs
                row[f"ratio_{g}"] = pairs / max(ray, 1)
            if anyhit and ds.cw.shape[0]:
                row["block_chunks_full"] = block_counts(need, per, False)[1]
                row["block_chunks_exit"] = block_counts(need, per, True)[1]
            print(json.dumps(row), flush=True)
            if not same:
                raise SystemExit("the host build disagrees with the plain "
                                 "path")


if __name__ == "__main__":
    main()
