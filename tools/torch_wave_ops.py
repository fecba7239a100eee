"""Count the PyTorch operations one wave of the port issues, by stage.

    python tools/torch_wave_ops.py [--textured | --composed | --bpt |
                                    --whitted] [--res 16x16] [--spp 4]

Runs one trace_wave of the Cornell box (examples/cornellbox/cb.json;
with --textured, bench.py's checkerboard kd texture on every matte
material; with --composed, the emission-textured box
examples/cornellbox/cb_etex.json, which takes the composed bounce; with
--bpt / --whitted, one wave of the bidirectional or the Whitted
renderer, render/bpt.py trace_wave_bpt / render/whitted.py
whitted_wave, on cb.json) on the CPU, at depth 8, and counts every aten
operation it dispatches.  On
the card each of these is at least one kernel launch issued by the
host, so the count is the host's launch work per wave; it does not
depend on the wave's width.  The hand-written kernels (K1, K2, K3, K5,
K6, K8, K9) count as one launch per call: their plain versions run
here, and their own operations are not counted (K1 / K2 test the
spheres too; the rebuild of a sphere hit's local point after K1 is the
stage "p_local rebuild"); K8's recipe order counts as one call
(kernel: slot_order) on the first K8 call on each BSDF, and the
host operations of the K8 / K9 entries around their launch (the
outputs' and the order's allocations) are replayed and counted as
"slot entries".  Each
other operation is put in the stage of the innermost function on the
Python stack that names one.  Prints one JSON object: the stages,
their counts, and the total.
"""

import argparse
import collections
import dataclasses
import json
import os
import sys
import weakref

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

# (file, function or None for any function of the file) -> stage
STAGES = (
    ("torch_wave_ops.py", "_slot_entry_host_ops", "slot entries"),
    ("scene.py", "intersect", "hit glue"),
    ("scene.py", "sphere_hit_info", "hit glue"),
    ("scene.py", "occluded", "shadow glue"),
    ("scene.py", "light_emission", "emission"),
    ("scene.py", "emission_tex_factor", "emission"),
    ("nee.py", "_occlusion_query", "shadow glue"),
    ("nee.py", "light_sample", "light sample"),
    ("nee.py", "path_mis_weight", "MIS weight"),
    ("nee.py", "direct_light_contrib", "NEE glue"),
    ("nee.py", "light_branch", "NEE glue"),
    ("nee.py", "uniform_sample_one_light", "NEE glue"),
    ("materials.py", "build_slots", "material recipe"),
    ("materials.py", "compute_scattering", "material recipe"),
    ("integrator.py", "composed_bounce", "composed glue"),
    ("sampler.py", None, "sampler"),
    ("camera.py", None, "camera"),
    ("sphere.py", "hit_p_local", "p_local rebuild"),
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
    ("integrator.py", "_closest", "hit glue"),
    ("integrator.py", "occluded", "shadow glue"),
    ("bpt.py", "mis_weight", "MIS weight"),
    ("bpt.py", "_random_walk", "walk glue"),
    ("bpt.py", None, "connection glue"),
    ("emission.py", None, "light emission"),
    ("importance.py", None, "camera importance"),
    ("distribution.py", None, "light select"),
    ("whitted.py", None, "Whitted glue"),
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


def _slot_entry_host_ops(b, w, rows, first):
    """The host operations of a K8 / K9 entry around its launch
    (bxdf/slot_shade.py, kernels/ops.py): the outputs' allocations and,
    on K8's first call on a BSDF, its recipe order's (the fields are
    read where they lie: no pack, no split)."""
    from arendur_tpu_torch.bxdf import slot_shade as ssh
    n = w.shape[0]
    if first:
        torch.empty(n, dtype=torch.int32)
        torch.empty(1, dtype=torch.int32)
    torch.empty(n, 3)
    if rows == ssh.SAMPLE_OUT_COLS:
        torch.empty(n, 3)
        torch.empty(n)
        torch.empty(n, dtype=torch.int32)
    else:
        torch.empty(n)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--textured", action="store_true")
    mode.add_argument("--composed", action="store_true")
    mode.add_argument("--bpt", action="store_true")
    mode.add_argument("--whitted", action="store_true")
    ap.add_argument("--res", default="16x16")
    ap.add_argument("--spp", type=int, default=4)
    args = ap.parse_args(argv)
    from arendur_tpu_torch import scene as sc
    from arendur_tpu_torch.io import scenedesc
    from arendur_tpu_torch.render import integrator as integ
    from arendur_tpu_torch.sampling import sampler as smp

    w, h = (int(v) for v in args.res.lower().split("x"))
    scene, camera, film_cfg, config, _ = scenedesc.parse_scene(
        os.path.join(REPO, "examples/cornellbox", "cb_etex.json"
                     if args.composed else "cb.json"),
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

    ordered = weakref.WeakSet()   # the BSDFs whose order is built
    order = kernel("slot_order", lambda b: None)

    def slot_kernel(name, fn, rows):
        launch = kernel(name, fn)

        def call(b, w, x, types):
            # K8's entry builds the BSDF's order at its first call
            first = rows == ssh.SAMPLE_OUT_COLS and b not in ordered
            if first:
                ordered.add(b)
                order(b)
            _slot_entry_host_ops(b, w, rows, first)
            return launch(b, w, x, types)
        return call

    from arendur_tpu_torch.bxdf import slot_shade as ssh
    plain = integ.PLAIN_OPS
    wave_ops = dataclasses.replace(
        plain, **{f.name: kernel(f.name, getattr(plain, f.name))
                  for f in dataclasses.fields(plain)})
    wave_ops = dataclasses.replace(
        wave_ops,
        bsdf_sample=slot_kernel("bsdf_sample", plain.bsdf_sample,
                                ssh.SAMPLE_OUT_COLS),
        bsdf_eval_pdf=slot_kernel("bsdf_eval_pdf", plain.bsdf_eval_pdf,
                                  ssh.EVAL_OUT_COLS))
    n = w * h * args.spp
    ray_idx = torch.arange(n)
    pid, sid = ray_idx // args.spp, ray_idx % args.spp
    pxy = torch.stack([(pid % w).float(), (pid // w).float()], -1)
    key = smp.make_base_key(0)
    with torch.no_grad(), counter:
        if args.bpt:
            from arendur_tpu_torch.render import bpt
            bpt.trace_wave_bpt(ds, camera, config, film_cfg, pxy, pid, sid,
                               key, ops=wave_ops)
        elif args.whitted:
            from arendur_tpu_torch.render import whitted
            whitted.whitted_wave(ds, camera, config, pxy, pid, sid, key,
                                 ops=wave_ops)
        else:
            integ.trace_wave(ds, camera, config, pxy, pid, sid, key,
                             ops=wave_ops)
    counts = dict(sorted(counter.counts.items()))
    print(json.dumps(dict(textured=args.textured, composed=args.composed,
                          bpt=args.bpt, whitted=args.whitted,
                          stages=counts, total=sum(counts.values()))))


if __name__ == "__main__":
    main()
