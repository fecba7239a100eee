"""Host time per launch of the shade kernels' wrappers on the card.

    [PYTHONPATH=DIR] python tools/launch_ms.py

Times the arendur_tpu_torch that Python imports (this checkout's, or
DIR's, so that one call can time two checkouts in turns): for the
wrappers of K3 (ops.bounce_shade, with a live count where it takes
one), K5 (hit_shade), K6 (shade_split), K8 (slot_sample) and K9
(slot_eval_pdf), K8's recipe order (slot_order) where the checkout
has one, and the whole K8 / K9 entry calls (bxdf/slot_shade.py
bsdf_sample / bsdf_eval_pdf; with the order, also the earlier route's
pack, launch and split), the host's wall time per call over 200 calls
issued back to back without a sync (the launch work: checks, allocation,
configuration, the ctypes call and the launch), the median of 7 such
runs after a warm-up.  The inputs are 4,096 fuzz lanes over cb.json's
tables (render/fuzz.py), so the card keeps up with the host.  Needs one
card.  Prints one JSON object, with the card's name and power limit.
"""

import inspect
import json
import os
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.append(REPO)

CALLS, RUNS, LANES = 200, 7, 4096


def host_us(fn):
    """Median host microseconds per call of fn over RUNS runs of CALLS."""
    import torch
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(RUNS):
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        runs.append(1e6 * (time.perf_counter() - t0) / CALLS)
        torch.cuda.synchronize()
    return statistics.median(runs)


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("launch_ms: CUDA is not available")
    import chip_smoke as cs
    import arendur_tpu_torch
    from arendur_tpu_torch import scene as sc
    from arendur_tpu_torch.io import scenedesc
    from arendur_tpu_torch.kernels import ops
    from arendur_tpu_torch.bxdf import slot_shade as ssh
    from arendur_tpu_torch.render import fuzz

    dev = torch.device("cuda", 0)
    scene, *_ = scenedesc.parse_scene(
        os.path.join(REPO, "examples/cornellbox/cb.json"))
    ds = sc.DeviceScene.build(scene, dev)
    xh, xs, xf = fuzz.fuzz_split_inputs(ds.ltab, ds.mtab, ds.stab, seed=0,
                                        n=LANES)
    kw = {}
    if "n_alive" in inspect.signature(ops.bounce_shade).parameters:
        kw["n_alive"] = torch.tensor(LANES - 100, dtype=torch.int32,
                                     device=dev)
    shade = (ds.static, 4, 0.05)
    bx, wo, u, wi = fuzz.fuzz_slots(fuzz.fuzz_slot_inputs(LANES, 9), dev)
    calls = {
        "bounce_shade": lambda: ops.bounce_shade(
            xf, ds.ltab, ds.mtab, ds.stab, *shade, **kw),
        "hit_shade": lambda: ops.hit_shade(xh, ds.stab),
        "shade_split": lambda: ops.shade_split(xs, ds.ltab, *shade, **kw),
        # the whole K8 / K9 entry calls, in every checkout
        "slot_sample_entry": lambda: ssh.bsdf_sample(bx, wo, u),
        "slot_eval_pdf_entry": lambda: ssh.bsdf_eval_pdf(bx, wo, wi),
    }
    if hasattr(ops, "slot_order"):
        # the in-place wrappers as the entries call them (K8 with the
        # order kept), the order's wrapper, and the earlier route's
        # whole call (pack, launch, split)
        order = ssh.lane_order(bx)
        calls.update({
            "slot_sample": lambda: ops.slot_sample(bx, wo, u, 31, order),
            "slot_eval_pdf": lambda: ops.slot_eval_pdf(bx, wo, wi, 31),
            "slot_order": lambda: ops.slot_order(bx),
            "slot_sample_earlier_entry": lambda: ssh.sample_packed(bx, wo,
                                                                   u),
            "slot_eval_pdf_earlier_entry": lambda: ssh.eval_pdf_packed(
                bx, wo, wi)})
    else:
        x8, x9 = ssh.pack_slots(bx, wo, u), ssh.pack_slots(bx, wo, wi)
        slot = (31, bx.present, bx.dists)
        calls.update({
            "slot_sample": lambda: ops.slot_sample(x8, *slot),
            "slot_eval_pdf": lambda: ops.slot_eval_pdf(x9, *slot)})
    print(json.dumps(dict(
        card=cs.card_line(), package=os.path.dirname(os.path.abspath(
            arendur_tpu_torch.__file__)),
        host_us_per_call={k: host_us(f) for k, f in calls.items()})))


if __name__ == "__main__":
    main()
