"""Where the card's time goes in one wave of an instanced scene: the
device kernels of one fused wave of examples/cornellbox/cb_inst.json
(256x256, 16 spp, depth 8, wave 0 of 65,536 paths), grouped by name.

    python tools/inst_wave_ops.py [--top N] [--scene PATH]

Runs the wave once to warm up, then takes a torch.profiler trace of one
more (through chip_smoke.py's ``profiled``, which retakes a trace that
holds no device event) and prints, per kernel name, its launches and
device ms summed over the wave, the N largest first, beside the wave's
busy time (the union of its kernel intervals, chip_smoke.py
``_busy_s``), its wall time, the batched matrix products it ran (the
frame transforms of the earlier instanced route), its peak device
memory and the card's name and power limit.  The K1 / K2 launches are
named by kernel: the world's (cluster_kernel) and the instanced
entries' (instanced_kernel).  Needs one card.  Prints one JSON
object.
"""

import argparse
import collections
import dataclasses
import importlib.util
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.append(REPO)

_spec = importlib.util.spec_from_file_location(
    "inst_wave_ops_chip_smoke", os.path.join(REPO, "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--scene", default=os.path.join(
        REPO, "examples/cornellbox/cb_inst.json"))
    args = ap.parse_args(argv)
    import torch
    from arendur_tpu_torch import scene as sc
    from arendur_tpu_torch.io import scenedesc
    from arendur_tpu_torch.render import integrator as integ
    from arendur_tpu_torch.sampling import sampler as smp
    if not torch.cuda.is_available():
        raise SystemExit("inst_wave_ops: CUDA is not available")
    dev = torch.device("cuda", 0)
    scene, camera, _, config, _ = scenedesc.parse_scene(
        args.scene, spp_override=16, resolution_override=(256, 256))
    config = dataclasses.replace(config, max_depth=8, wave_size=1 << 16)
    ds = sc.DeviceScene.build(scene, dev)
    n = 1 << 16
    ray_idx = torch.arange(n, device=dev)
    pid, sid = ray_idx // 16, ray_idx % 16
    pxy = torch.stack([(pid % 256).float(), (pid // 256).float()], -1)
    wave = (ds, camera, config, pxy, pid, sid, smp.make_base_key(0))
    with torch.no_grad():
        integ.trace_wave(*wave)
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        integ.trace_wave(*wave)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - mem0
        _, prof = cs.profiled(lambda: integ.trace_wave(*wave))
    if prof is None:
        raise SystemExit("inst_wave_ops: no trace held the device events")
    busy, launches, _ = cs._busy_s(prof)
    events = [e for e in prof.events()
              if e.device_type.name == "CUDA" and e.time_range.end > 0]
    groups = collections.defaultdict(lambda: [0, 0.0])
    for e in events:
        name = e.name
        for key, label in (("cluster_kernel", " world"),
                           ("instanced_kernel", " instanced")):
            if key in name:
                kind = "K1" if ("<false>" in name or "ILb0E" in name) \
                    else "K2"
                name = kind + label
        g = groups[name[:90]]
        g[0] += 1
        g[1] += 1e-3 * (e.time_range.end - e.time_range.start)
    top = sorted(groups.items(), key=lambda kv: -kv[1][1])[:args.top]
    print(json.dumps(dict(
        scene=os.path.relpath(args.scene, REPO), wall_ms=1e3 * wall,
        busy_ms=1e3 * busy, launches=launches,
        batched_products=cs.batched_products(prof), peak_bytes=peak,
        kernels=[dict(name=k, launches=v[0], device_ms=v[1])
                 for k, v in top],
        card=cs.card_line()), indent=1))


if __name__ == "__main__":
    main()
