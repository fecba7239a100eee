"""arencli-compatible command line renderer (port of arendur_tpu/cli.py;
ref: examples/arencli.rs).

Usage:
    python -m arendur_tpu_torch.cli scene.json [options]

Renders the JSON scene description (cb.json schema) on one device with
the wavefront path tracer (``--renderer pt``), the bidirectional path
tracer (``bpt``) or Whitted direct lighting (``whitted``) and saves a
PNG, printing the wall-clock time like the reference ("Done! Time used:
{:.4}s", arencli.rs:54-61).  It takes the JAX CLI's flags:
``--intersector cluster|bvh|naive`` picks the world triangles' test
(the SAH cluster kernels, the BVH walk or the brute force; ``--bvh`` is
the old alias of ``bvh``), and ``--resume`` checkpoints the path
tracer's film to ``<output>.ckpt.npz`` every ``--checkpoint-every``
waves and resumes from it when it is there.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description="arendur_tpu_torch renderer")
    ap.add_argument("input", help="JSON scene description")
    ap.add_argument("-o", "--output", default=None,
                    help="output PNG (defaults to scene's outputfilename)")
    ap.add_argument("--spp", type=int, default=None,
                    help="override samples per pixel")
    ap.add_argument("--res", default=None,
                    help="override resolution, e.g. 512x384")
    ap.add_argument("--depth", type=int, default=None,
                    help="override max path depth")
    ap.add_argument("--renderer", choices=("pt", "whitted", "bpt"),
                    default="pt")
    ap.add_argument("--intersector", choices=("cluster", "bvh", "naive"),
                    default="cluster",
                    help="triangle intersection structure: 'cluster' "
                         "(SAH cluster tables, kernels K1 / K2; default), "
                         "'bvh' (per-ray stack traversal), 'naive' "
                         "(brute-force wavefront)")
    ap.add_argument("--bvh", action="store_true",
                    help="deprecated alias for --intersector bvh")
    ap.add_argument("--wave", type=int, default=1 << 16,
                    help="rays per wavefront launch")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default cuda; 'cpu' "
                         "runs the plain PyTorch versions of the kernels)")
    ap.add_argument("--cpu", action="store_true",
                    help="alias for --device cpu")
    ap.add_argument("--resume", action="store_true",
                    help="checkpoint the film every few waves and "
                         "resume from <output>.ckpt.npz if present "
                         "(bit-identical to an uninterrupted render; "
                         "--renderer pt)")
    ap.add_argument("--checkpoint-every", type=int, default=4,
                    help="waves between checkpoints with --resume")
    ap.add_argument("--composed", action="store_true",
                    help="render through the composed bounce even where "
                         "the fused one serves (the JAX CLI's "
                         "ARENDUR_SHADE=xla); scenes with emission "
                         "textures always take it")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="per-wave progress + invalid-sample warnings")
    args = ap.parse_args(argv)

    import torch
    from arendur_tpu_torch import scene as sc
    from arendur_tpu_torch.filming import film as flm
    from arendur_tpu_torch.io import scenedesc
    from arendur_tpu_torch.render import integrator as integ

    device = torch.device("cpu" if args.cpu else args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("error: CUDA is not available (pass --device cpu to run "
              "the plain PyTorch path)", file=sys.stderr)
        return 2

    res = None
    if args.res:
        w, h = args.res.lower().split("x")
        res = (int(w), int(h))
    intersector = "bvh" if args.bvh else args.intersector
    scene, camera, film_cfg, config, outname = scenedesc.parse_scene(
        args.input, spp_override=args.spp, resolution_override=res,
        intersector=intersector)
    if args.depth is not None:
        config = dataclasses.replace(config, max_depth=args.depth)
    config = dataclasses.replace(config, wave_size=args.wave,
                                 seed=args.seed)
    out = args.output or outname
    print(f"rendering {args.input}: {film_cfg.resolution[0]}x"
          f"{film_cfg.resolution[1]}, {config.spp} spp, "
          f"depth {config.max_depth}, renderer={args.renderer}, "
          f"intersector={intersector}, device={device}")
    if args.verbose:
        import logging
        logging.basicConfig(level=logging.INFO)
    t0 = time.time()
    dscene = sc.DeviceScene.build(scene, device)
    if args.renderer == "pt":
        ckpt = (out + ".ckpt.npz") if args.resume else None
        img = integ.render(dscene, camera, film_cfg, config,
                           progress=args.verbose, composed=args.composed,
                           checkpoint_path=ckpt,
                           checkpoint_every=args.checkpoint_every)
    elif args.renderer == "bpt":
        from arendur_tpu_torch.render import bpt
        img = bpt.render_bpt(dscene, camera, film_cfg, config,
                             progress=args.verbose)
    else:
        from arendur_tpu_torch.render import whitted
        img = whitted.render_whitted(dscene, camera, film_cfg, config,
                                     progress=args.verbose)
    img = img.cpu()
    dt = time.time() - t0
    print(f"Done! Time used: {dt:.4f}s")
    flm.save_png(img, out)
    print(f"saved {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
