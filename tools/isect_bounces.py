"""Time the cluster closest hit (K1) and any hit (K2) on each query of one
fused wave on the card, for any checkout, and compare two checkouts'
results to the bit.

    [PYTHONPATH=DIR] python tools/isect_bounces.py --queries Q.pt --save OUT.pt
    python tools/isect_bounces.py --compare A.pt B.pt

Times the arendur_tpu_torch that Python imports: this checkout's, or
the one in DIR, so that one call can time two checkouts in turns
(unpack each with git archive; run parent, change, change, parent).
The wave is chip_smoke.py phase 3's: wave 0 of
examples/cornellbox/cb.json at 256x256, 16 spp, depth 8, waves of
65,536, its 9 closest-hit and 8 any-hit queries (with the scene's
sphere table) recorded by this checkout's render/fuzz.py wave_queries.
With --queries, the queries and their results are read from Q.pt where
it exists and written there where it does not, so that every run times
the same inputs and "recorded" says whether a query's results equal
those of the checkout that wrote Q.pt.  Each query is checked and timed
by this checkout's chip_smoke.py wave_query_rows (lanes equal to the
plain version, a second launch, ms by CUDA events and on the card, live
rays, bound).  --save writes each query's results (t, slot, or blocked)
to OUT.pt; --compare says whether two such files are equal to the bit.
Paths/s and the wave's device busy time are chip_smoke.py's (phases 6,
8, 10, 12), run from each checkout.  Needs one card.  Prints one JSON
object, with the card's name and power limit.
"""

import argparse
import dataclasses
import importlib.util
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.append(REPO)


def this_checkouts(name, path):
    """This checkout's module at path, whichever arendur_tpu_torch Python
    imports (another checkout's may come first on the path)."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = this_checkouts("isect_bounces_chip_smoke", "chip_smoke.py")


def compare(a, b):
    import torch
    qa, qb = torch.load(a), torch.load(b)
    equal = [len(x) == len(y) and all(torch.equal(u, v)
                                      for u, v in zip(x, y))
             for x, y in zip(qa, qb)]
    print(json.dumps(dict(compare=[a, b], queries=len(qa),
                          equal=len(qa) == len(qb) and all(equal),
                          per_query=equal)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--queries", help="the recorded queries (read where "
                    "the file exists, else written)")
    ap.add_argument("--save", help="write each query's results here")
    ap.add_argument("--compare", nargs=2, help="compare two --save files")
    args = ap.parse_args()
    if args.compare:
        return compare(*args.compare)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("isect_bounces: CUDA is not available")
    import arendur_tpu_torch
    from arendur_tpu_torch import scene as sc
    from arendur_tpu_torch.io import scenedesc
    from arendur_tpu_torch.render import integrator as integ

    dev = torch.device("cuda", 0)
    scene, camera, film_cfg, config, _ = scenedesc.parse_scene(
        os.path.join(REPO, "examples/cornellbox/cb.json"),
        spp_override=16, resolution_override=(256, 256))
    config = dataclasses.replace(config, max_depth=8, wave_size=1 << 16)
    ds = sc.DeviceScene.build(scene, dev)
    if args.queries and os.path.exists(args.queries):
        queries = torch.load(args.queries)
        for q in queries:
            q.update({k: v.to(dev) for k, v in q.items()
                      if isinstance(v, torch.Tensor)})
    else:
        fuzz = this_checkouts("isect_bounces_fuzz",
                              "arendur_tpu_torch/render/fuzz.py")
        queries = fuzz.wave_queries(ds, camera, film_cfg, config,
                                    integ.KERNEL_OPS)
        if args.queries:
            torch.save([{k: (v.cpu() if isinstance(v, torch.Tensor) else v)
                         for k, v in q.items()} for q in queries],
                       args.queries)
    rows, outs = cs.wave_query_rows(ds, queries)
    if args.save:
        torch.save([[x.cpu() for x in got] for got in outs], args.save)
    k1 = [r for r in rows if r["kind"] == "closest"]
    k2 = [r for r in rows if r["kind"] == "any"]
    mean = lambda rs, k: sum(r[k] for r in rs) / len(rs)  # noqa: E731
    print(json.dumps(dict(
        card=cs.card_line(), torch=torch.__version__,
        package=os.path.dirname(os.path.abspath(arendur_tpu_torch.__file__)),
        per_query=rows,
        k1_mean_ms=mean(k1, "ms"), k1_mean_device_ms=mean(k1, "device_ms"),
        k1_mean_bound_ms=mean(k1, "bound_ms"), k2_mean_ms=mean(k2, "ms"),
        k2_mean_device_ms=mean(k2, "device_ms"),
        k2_mean_bound_ms=mean(k2, "bound_ms"),
        k1_k2_device_ms_per_wave=sum(r["device_ms"] for r in rows))))


if __name__ == "__main__":
    main()
