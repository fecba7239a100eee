"""Break one BPT wave's kernel time down by call, on the card.

    python tools/bpt_wave_kernels.py

Records wave 0 of a 256x256, 16 spp, depth-8 BPT render of
examples/cornellbox/cb.json as the kernel path runs it (render/fuzz.py
bpt_wave_sets: 17 closest-hit and 44 any-hit queries, 17 BSDF samples,
161 fused evaluations), then times on the card, each by CUDA events
around calls queued while the card sleeps (chip_smoke.py queued_ms):

* each K1 / K2 query as recorded, all 65,536 lanes;
* each walk query after a walk's first again with the lanes that hit at
  every earlier step of the walk moved to the front and the live count
  set to their number: what compacting the walk would leave K1 (a walk
  that missed is dead; the count is an upper bound on the live lanes,
  since a BSDF sample also ends walks);
* K8 on each walk vertex as recorded and with its lanes sorted by their
  slot types (the material recipe), which takes divergence within a
  warp away;
* K9's calls, the mean by kind of call (the walks' reverse densities,
  the connections' evaluations).

Needs one card.  Prints one JSON object, with the card's name and power
limit.
"""

import dataclasses
import importlib.util
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "bpt_wave_kernels_chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bpt_wave_kernels: CUDA is not available")
    cs = _chip_smoke()
    from arendur_tpu_torch import scene as sc
    from arendur_tpu_torch.bxdf import slot_shade as ssh
    from arendur_tpu_torch.io import scenedesc
    from arendur_tpu_torch.kernels import build, ops
    from arendur_tpu_torch.render import fuzz
    from arendur_tpu_torch.render import integrator as integ

    dev = torch.device("cuda", 0)
    build.build()
    build.load()
    scene, camera, film_cfg, config, _ = scenedesc.parse_scene(
        os.path.join(REPO, "examples/cornellbox/cb.json"), spp_override=16,
        resolution_override=(256, 256))
    config = dataclasses.replace(config, max_depth=8, wave_size=1 << 16)
    ds = sc.DeviceScene.build(scene, dev)
    with torch.no_grad():
        sets = fuzz.bpt_wave_sets(ds, camera, film_cfg, config,
                                  integ.KERNEL_OPS)

    def query_args(q, perm=None, n_alive=None):
        o, d, tmax = q["o"], q["d"], q["tmax"]
        if perm is not None:
            o, d, tmax = o[perm], d[perm], tmax[perm]
        return (ds.cw, ds.cbox, o, d, tmax, n_alive, q["period"],
                q["sph_tab"], q["full_phi"])

    queries, prev_hit = [], {}
    for q in sets["queries"]:
        fn = ops.closest_hit if q["kind"] == "closest" else ops.any_hit
        args = query_args(q)
        row = dict(tag=q["tag"], kind=q["kind"],
                   ms=cs.queued_ms(lambda: fn(*args)))
        walk = q["tag"].rsplit(" ", 1)[0] if "walk" in q["tag"] else None
        if walk in prev_hit:
            hit = prev_hit[walk]
            perm = torch.argsort((~hit).to(torch.int8), stable=True)
            n_live = hit.sum().to(torch.int32)
            cargs = query_args(q, perm, n_live)
            row.update(live=int(n_live),
                       compacted_ms=cs.queued_ms(lambda: fn(*cargs)))
        if walk is not None:
            hit = q["slot"] != -1
            prev_hit[walk] = hit & prev_hit[walk] if walk in prev_hit \
                else hit
        queries.append(row)

    def sample_ms(r, perm=None):
        xs = ssh.pack_slots(r["b"], r["wo"], r["u"])
        if perm is not None:
            xs = xs[:, perm].contiguous()
        return cs.queued_ms(lambda: ops.slot_sample(
            xs, r["types"], r["b"].present, r["b"].dists))

    samples = []
    for i, r in enumerate(sets["samples"]):
        t = r["b"].type.to(torch.int64)
        key = sum(t[:, j] * 16 ** j for j in range(t.shape[1]))
        samples.append(dict(
            call=i, recipes=int(torch.unique(key).numel()),
            ms=sample_ms(r),
            sorted_ms=sample_ms(r, torch.argsort(key, stable=True))))

    n_walk = len(sets["samples"])
    evals = []
    for r in sets["evals"]:
        xs = ssh.pack_slots(r["b"], r["wo"], r["wi"])
        evals.append(cs.queued_ms(lambda: ops.slot_eval_pdf(
            xs, r["types"], r["b"].present, r["b"].dists)))
    # the walks' reverse densities are the first K9 call after each
    # walk step's sample, in the walks' order (render/bpt.py)
    walk_evals = evals[:n_walk]
    conn_evals = evals[n_walk:]
    mean = lambda v: sum(v) / max(len(v), 1)  # noqa: E731
    print(json.dumps(dict(
        card=cs.card_line(), queries=queries, k8=samples,
        k9=dict(walk_mean_ms=mean(walk_evals), walk_ms=walk_evals,
                connection_mean_ms=mean(conn_evals),
                connection_calls=len(conn_evals)))))


if __name__ == "__main__":
    main()
