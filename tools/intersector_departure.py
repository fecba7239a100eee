"""How far the renders with the BVH walk or the brute force lie from the
cluster render, and why: cb.json at 64x48, 32 spp, depth 8 (one wave)
through --intersector cluster, naive and bvh, and naive once more with
the cluster kernels' self-hit guard (t > 1e-5 (1 + max |o|),
shapes/mxu_intersect.py ray_teps) added to its accept test.

    python tools/intersector_departure.py [--device cpu|cuda] [--spp N]

Prints per intersector the largest per-pixel difference from the
cluster render, the pixels past 3e-3 and the difference of the image
means.  The watertight test of the walk and the brute force (the JAX
package's) accepts hits closer than that guard; the guarded run shows
whether the guard is the whole departure.  On the CPU it takes ~8 min.
"""

import argparse
import dataclasses
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--spp", type=int, default=32)
    args = ap.parse_args(argv)
    import torch
    from arendur_tpu_torch import scene as sc
    from arendur_tpu_torch.io import scenedesc
    from arendur_tpu_torch.render import integrator as integ
    from arendur_tpu_torch.shapes import triangle as tri
    cb = os.path.join(REPO, "examples/cornellbox/cb.json")

    def render(intersector):
        s, cam, film, cfg, _ = scenedesc.parse_scene(
            cb, spp_override=args.spp, resolution_override=(64, 48),
            intersector=intersector)
        cfg = dataclasses.replace(cfg, max_depth=8,
                                  wave_size=64 * 48 * args.spp)
        return integ.render(sc.DeviceScene.build(s, args.device), cam, film,
                            cfg)

    ref = render("cluster")
    imgs = {k: render(k) for k in ("naive", "bvh")}
    plain_batch = tri.intersect_batch

    def guarded(o, d, tmax, perm, shear, v0, v1, v2):
        hit, t, b0, b1 = plain_batch(o, d, tmax, perm, shear, v0, v1, v2)
        teps = 1e-5 * (1.0 + o.abs().amax(-1))
        return hit & (t > teps[:, None]), t, b0, b1
    tri.intersect_batch = guarded
    try:
        imgs["naive with the cluster kernels' guard"] = render("naive")
    finally:
        tri.intersect_batch = plain_batch
    dev = torch.cuda.get_device_name(0) if args.device.startswith("cuda") \
        else "cpu"
    for k, img in imgs.items():
        d = (img - ref).abs().amax(-1)
        print(f"{k} vs cluster (cb.json 64x48 {args.spp}spp depth 8, {dev}): "
              f"max |diff| {d.max().item():.6e}, pixels past 3e-3 "
              f"{int((d > 3e-3).sum())} of {d.numel()}, |mean diff| "
              f"{(img.mean() - ref.mean()).abs().item():.6e}")


if __name__ == "__main__":
    main()
