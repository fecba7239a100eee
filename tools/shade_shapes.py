"""Build the bounce-shade kernels K3 and K6 at other launch shapes and
time them on the card.

    python tools/shade_shapes.py [--shapes 128x4,128x6,256x3]

A shape BxM is BLOCK = B threads a block and MIN_BLOCKS = M blocks an
SM in __launch_bounds__, which caps a thread's registers at what M
blocks of B threads leave (kernels/cbounce.cu; SPLIT_BLOCK /
SPLIT_MIN_BLOCKS in kernels/cbounce_split.cu).  Each shape's copy of
the two sources is built under kernels/_build/shapes/ with the
package's nvcc flags and -Xptxas -v, every nvcc at once, and loaded
beside the package's kernels.  The inputs are tools/shade_bounces.py's
waves (wave 0 of cb.json at 256x256, 16 spp, depth 8: K3 on the fused
wave's eight bounces, K6 on the textured wave's), recorded through the
package's kernels; each shape's output must equal theirs to the bit on
every lane of every bounce.  Per shape: ptxas's registers, stack and
spills, the blocks an SM holds (the occupancy entries), and the device
ms per launch at each bounce by the profiler on inputs rotated past the
L2 (chip_smoke.py kernel_ms), summed over the wave.  Needs one card and
nvcc.  Prints one JSON object, with the card's name and power limit.
"""

import argparse
import ctypes
import dataclasses
import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

# (source, its launch-shape constants)
SOURCES = (("cbounce.cu", "BLOCK", "MIN_BLOCKS"),
           ("cbounce_split.cu", "SPLIT_BLOCK", "SPLIT_MIN_BLOCKS"))


def build_shapes(shapes):
    """{shape: (library, ptxas log)} of each shape's copy of SOURCES."""
    from arendur_tpu_torch.kernels import build
    kdir = os.path.dirname(os.path.abspath(build.__file__))
    procs = []
    for shape in shapes:
        block, mins = shape.split("x")
        out_dir = os.path.join(build.BUILD_DIR, "shapes", shape)
        os.makedirs(out_dir, exist_ok=True)
        srcs = []
        for name, c_block, c_min in SOURCES:
            with open(os.path.join(kdir, name)) as f:
                text = f.read()
            for const, value in ((c_block, block), (c_min, mins)):
                text, k = re.subn(rf"constexpr int {const} = \d+;",
                                  f"constexpr int {const} = {value};", text)
                if k != 1:
                    raise AssertionError(f"{name}: no {const} to set")
            srcs.append(os.path.join(out_dir, name))
            with open(srcs[-1], "w") as f:
                f.write(text)
        lib = os.path.join(out_dir, "libshapes.so")
        cmd = ([build.find_nvcc()] + build.NVCC_FLAGS
               + ["-Xptxas", "-v", "-I", kdir, "-o", lib] + srcs)
        procs.append((shape, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    built = {}
    for shape, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {shape}:\n{log}")
        built[shape] = (lib, log)
    return built


def load(path):
    lib = ctypes.CDLL(path)
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    lib.arendur_bounce_shade.argtypes = [P, P, I, I, P, I, P, I, I, L, P,
                                         P, P, P]
    lib.arendur_shade_split.argtypes = [P, P, I, I, I, L, P, P, P, P]
    lib.arendur_bounce_shade_occupancy.argtypes = [I, I, I, I, I, P]
    lib.arendur_shade_split_occupancy.argtypes = [I, I, I, P]
    return lib


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default="128x4,128x5,128x6,128x8,256x2,"
                    "256x3,64x12")
    shapes = ap.parse_args(argv).shapes.split(",")
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("shade_shapes: CUDA is not available")
    from arendur_tpu_torch import scene as sc
    from arendur_tpu_torch.io import scenedesc
    from arendur_tpu_torch.kernels import ops
    from arendur_tpu_torch.render import cbounce as cb
    from arendur_tpu_torch.render import fuzz
    from arendur_tpu_torch.render import integrator as integ
    from arendur_tpu_torch.shapes import sphere as sph

    built = build_shapes(shapes)
    dev = torch.device("cuda", 0)
    scene, camera, film_cfg, config, _ = scenedesc.parse_scene(
        os.path.join(REPO, "examples/cornellbox/cb.json"),
        spp_override=16, resolution_override=(256, 256))
    config = dataclasses.replace(config, max_depth=8, wave_size=1 << 16)
    ds = sc.DeviceScene.build(scene, dev)
    scene_t, atlas = fuzz.checker_textured(scene, dev)
    ds_t = sc.DeviceScene.build(scene_t, dev)
    waves = {"K3": fuzz.wave_shades(ds, camera, film_cfg, config,
                                    integ.KERNEL_OPS),
             "K6": fuzz.wave_shades(
                 ds_t, camera, film_cfg,
                 dataclasses.replace(config, textures=atlas),
                 integ.KERNEL_OPS)}
    cfg = ops.pack_shade_cfg(ds.static, config.min_depth,
                             config.rr_threshold, sph.THETA_UNIFORM_COMPAT)
    cfg_t = ops.pack_shade_cfg(ds_t.static, config.min_depth,
                               config.rr_threshold, sph.THETA_UNIFORM_COMPAT)
    p = lambda a: a.ctypes.data  # noqa: E731
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def k3(lib, x, na):
        out = torch.empty(cb.OUT_COLS, x.shape[1], device=dev)
        code = lib.arendur_bounce_shade(
            x.data_ptr(), ds.ltab.data_ptr(), *ds.ltab.shape,
            ds.mtab.data_ptr(), ds.mtab.shape[0], ds.stab.data_ptr(),
            ds.stab.shape[0], ops.STAGE_ALL, x.shape[1], na.data_ptr(),
            p(cfg),
            out.data_ptr(), stream())
        if code:
            raise RuntimeError(f"K3 launch failed: cudaError {code}")
        return out

    def k6(lib, x, na):
        out = torch.empty(cb.OUT_COLS, x.shape[1], device=dev)
        code = lib.arendur_shade_split(
            x.data_ptr(), ds_t.ltab.data_ptr(), *ds_t.ltab.shape,
            ops.STAGE_L, x.shape[1], na.data_ptr(), p(cfg_t), out.data_ptr(),
            stream())
        if code:
            raise RuntimeError(f"K6 launch failed: cudaError {code}")
        return out

    res = dict(card=cs.card_line(), shapes={})
    for shape, (path, log) in built.items():
        lib = load(path)
        info3, info6 = (ctypes.c_int * 4)(), (ctypes.c_int * 4)()
        lib.arendur_bounce_shade_occupancy(*ds.ltab.shape, ds.mtab.shape[0],
                                           ds.stab.shape[0], ops.STAGE_ALL,
                                           info3)
        lib.arendur_shade_split_occupancy(*ds_t.ltab.shape, ops.STAGE_L,
                                          info6)
        row = dict(ptxas=cs.ptxas_report([log]),
                   blocks_per_sm={"K3": info3[1], "K6": info6[1]})
        for name, fn, key in (("K3", k3, "bounce_shade_kernel"),
                              ("K6", k6, "shade_split_kernel")):
            per = []
            for r in waves[name]:
                na = r["n_alive"]
                if na is None:
                    na = torch.tensor(r["xt"].shape[1], dtype=torch.int32,
                                      device=dev)
                got = fn(lib, r["xt"], na)
                same = ((got == r["out"])
                        | (torch.isnan(got) & torch.isnan(r["out"]))).all()
                if not same:
                    raise AssertionError(f"{shape} {name}: not equal to the "
                                         f"package's kernel")
                call = cs.rotating(lambda x: fn(lib, x, na),  # noqa: B023
                                   r["xt"])
                per.append(cs.kernel_ms(call, key)[0])
            row[name] = dict(device_ms=per, device_ms_per_wave=sum(per))
        res["shapes"][shape] = row
    print(json.dumps(res))


if __name__ == "__main__":
    main()
