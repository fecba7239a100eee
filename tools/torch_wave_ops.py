"""Count the PyTorch operations one wave of the port issues, by stage.

    python tools/torch_wave_ops.py [--textured] [--res 16x16] [--spp 4]

Runs one trace_wave of the Cornell box (examples/cornellbox/cb.json;
with --textured, bench.py's checkerboard kd texture on every matte
material) on the CPU, at depth 8, and counts every aten operation it
dispatches.  On the card each of these is at least one kernel launch
issued by the host, so the count is the host's launch work per wave;
it does not depend on the wave's width.  The hand-written kernels (K1,
K2, K3, K5, K6) count as one launch per call: their plain versions run
here, and their own operations are not counted.  Each other operation
is put in the stage of the innermost function on the Python stack that
names one.  Prints one JSON object: the stages, their counts, and the
total.
"""

import argparse
import collections
import dataclasses
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

# (file, function or None for any function of the file) -> stage
STAGES = (
    ("sampler.py", None, "sampler"),
    ("camera.py", None, "camera"),
    ("sphere.py", None, "sphere tests"),
    ("texture.py", None, "texel lookups"),
    ("materials.py", "resolve_params", "texel lookups"),
    ("materials.py", "apply_bump", "texel lookups"),
    ("nee.py", None, "light select"),
    ("integrator.py", "_compact_perm", "compaction"),
    ("integrator.py", "_permute", "compaction"),
    ("integrator.py", "pack_bounce_input", "packing"),
    ("integrator.py", "pack_hit_input", "packing"),
    ("integrator.py", "pack_shade_input", "packing"),
    ("integrator.py", "curv_spread", "cone"),
    ("integrator.py", "_length", "cone"),
    ("cbounce.py", "unpack_out_t", "unpack"),
    ("cbounce.py", "unpack_hit_t", "unpack"),
    ("integrator.py", "intersect_raw", "hit glue"),
    ("integrator.py", "intersect_light", "hit glue"),
    ("integrator.py", "_tri_closest", "hit glue"),
    ("integrator.py", "occluded", "shadow glue"),
)


def _stage(frame):
    while frame is not None:
        fname = os.path.basename(frame.f_code.co_filename)
        for f, fn, stage in STAGES:
            if fname == f and (fn is None or frame.f_code.co_name == fn):
                return stage
        frame = frame.f_back
    return "other"


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()
        self.muted = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.muted:
            self.counts[_stage(sys._getframe(1))] += 1
        return func(*args, **(kwargs or {}))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--textured", action="store_true")
    ap.add_argument("--res", default="16x16")
    ap.add_argument("--spp", type=int, default=4)
    args = ap.parse_args(argv)
    from arendur_tpu_torch import scene as sc
    from arendur_tpu_torch.io import scenedesc
    from arendur_tpu_torch.render import integrator as integ
    from arendur_tpu_torch.sampling import sampler as smp

    w, h = (int(v) for v in args.res.lower().split("x"))
    scene, camera, _, config, _ = scenedesc.parse_scene(
        os.path.join(REPO, "examples/cornellbox/cb.json"),
        spp_override=args.spp, resolution_override=(w, h))
    config = dataclasses.replace(config, max_depth=8)
    if args.textured:
        from arendur_tpu_torch.render import fuzz
        scene, atlas = fuzz.checker_textured(scene)
        config = dataclasses.replace(config, textures=atlas)
    ds = sc.DeviceScene.build(scene, "cpu")
    counter = _Counter()

    def kernel(name, fn):
        def call(*a, **k):
            counter.counts["kernel: " + name] += 1
            counter.muted += 1
            try:
                return fn(*a, **k)
            finally:
                counter.muted -= 1
        return call

    plain = integ.PLAIN_OPS
    wave_ops = dataclasses.replace(
        plain, **{f.name: kernel(f.name, getattr(plain, f.name))
                  for f in dataclasses.fields(plain)})
    n = w * h * args.spp
    ray_idx = torch.arange(n)
    pid, sid = ray_idx // args.spp, ray_idx % args.spp
    pxy = torch.stack([(pid % w).float(), (pid // w).float()], -1)
    with torch.no_grad(), counter:
        integ.trace_wave(ds, camera, config, pxy, pid, sid,
                         smp.make_base_key(0), ops=wave_ops)
    counts = dict(sorted(counter.counts.items()))
    print(json.dumps(dict(textured=args.textured, stages=counts,
                          total=sum(counts.values()))))


if __name__ == "__main__":
    main()
