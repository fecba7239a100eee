"""On-card check of the PyTorch port (arendur_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, one line each:
  1. the card (nvidia-smi name and power limit) and the CUDA version;
  2. the build of the hand-written kernels, from the sources here;
  3. closest hit (K1) and shadow any hit (K2) against their plain
     PyTorch versions on a 65,536-ray Cornell camera wave, random
     secondary rays with n_alive < N, and real shadow rays;
  4. the bounce shade (K3) against its plain version on the first
     bounce of a real wave and on fuzz input over the Cornell tables
     and a table set that reaches every light and material branch;
  5. the main path: a 64x48, 32 spp, depth-8 Cornell render through
     the kernels, held against the reference image
     (tests/data/cornell_golden_128x96.npy) and against the same render
     on the plain path; every kernel must have launched in it;
  6. throughput at 256x256, 16 spp, depth 8 (waves of 65,536 paths) on
     the kernel path and on the plain path.
Then one JSON line per kernel set, the card line, and the result line.
Any failure raises; the exit code is then non-zero and no result line
is printed.  ``--out DIR`` also writes the measurements
(chip_smoke.json) and the kernel-path image (.npy) into DIR.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

K1_K2_GATE = 0.999       # slot / blocked agreement (share of lanes)
T_RTOL = 1e-5            # t where the slots agree
K3_GATE = 0.999          # share of elements within rtol 1e-4 / atol 1e-5
K3_RTOL, K3_ATOL = 1e-4, 1e-5
MSE_DS4_GATE = 1.7e-3    # golden gate of tests/test_golden.py
MEAN_GATE = 0.018
PLAIN_ATOL = 3e-3        # kernel path vs plain path, per pixel


def _say(msg):
    print(msg, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, iters=10):
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def _block_mean(a, f):
    h, w, _ = a.shape
    return a.reshape(h // f, f, w // f, f, 3).mean((1, 3))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="directory for chip_smoke.json and the image")
    out_dir = ap.parse_args(argv).out
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    sys.path.insert(0, REPO)
    import numpy as np
    from arendur_tpu_torch import scene as sc
    from arendur_tpu_torch.io import scenedesc
    from arendur_tpu_torch.kernels import build, ops
    from arendur_tpu_torch.render import cbounce as cb
    from arendur_tpu_torch.render import fuzz
    from arendur_tpu_torch.render import integrator as integ
    from arendur_tpu_torch.filming import camera as cam
    from arendur_tpu_torch.sampling import sampler as smp
    from arendur_tpu_torch.shapes import cluster_intersect as ci
    from arendur_tpu_torch.lighting import nee

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    # phase 1
    if torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("float32 matmul precision is not 'highest'")
    _say(f"[1] card: {card}; torch {torch.__version__}, "
         f"cuda {torch.version.cuda}; device count "
         f"{torch.cuda.device_count()}")

    # phase 2
    t0 = time.perf_counter()
    path = build.build(verbose=False)
    build.load()
    _say(f"[2] kernels built in {time.perf_counter() - t0:.1f} s "
         f"({os.path.relpath(path, REPO)})")

    cb_json = os.path.join(REPO, "examples/cornellbox/cb.json")
    scene, camera, film_cfg, config, _ = scenedesc.parse_scene(
        cb_json, spp_override=16, resolution_override=(256, 256))
    config = dataclasses.replace(config, max_depth=8, wave_size=1 << 16)
    ds = sc.DeviceScene.build(scene, dev)
    n = 1 << 16
    rng = np.random.default_rng(0)

    # a real first wave: camera rays of pixels 0..4095 at 16 spp
    ray_idx = torch.arange(n, device=dev)
    pid, sid = ray_idx // 16, ray_idx % 16
    pxy = torch.stack([(pid % 256).float(), (pid // 256).float()], -1)
    ws = smp.WaveSampler(smp.make_base_key(0), pid, sid, sample_dx=4,
                         sample_dy=4)
    o_cam, d_cam = cam.generate_rays(camera, pxy + ws.film_jitter(),
                                     ws.u2(2))
    tinf = torch.full((n,), float("inf"), device=dev)

    # phase 3: K1 / K2
    kern_rows = {}
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    o_sec = torch.tensor(rng.uniform([-1.9, -1.4, 2.1], [1.9, 2.4, 5.9],
                                     (n, 3)), dtype=torch.float32,
                         device=dev)
    d_sec = torch.tensor(dirs, dtype=torch.float32, device=dev)
    n_alive = torch.tensor(n - 9000, device=dev)
    k1 = []
    for name, o_, d_, na in (("camera", o_cam, d_cam, None),
                             ("secondary", o_sec, d_sec, n_alive)):
        t_k, s_k = ci.intersect_clusters(ds.cw, ds.cbox, o_, d_, tinf, na)
        t_p, s_p = ci.intersect_clusters_reference(ds.cw, ds.cbox, o_, d_,
                                                   tinf, na)
        agree = (s_k == s_p)
        frac = agree.float().mean().item()
        hit = agree & (s_k >= 0)
        terr = (t_k - t_p).abs()[hit]
        trel = (terr / t_p.abs()[hit]).max().item() if hit.any() else 0.0
        k1.append((name, frac, trel, terr.max().item() if hit.any()
                   else 0.0, hit.float().mean().item()))
        if frac < K1_K2_GATE or trel > T_RTOL:
            raise AssertionError(f"K1 {name}: slots agree on {frac}, "
                                 f"t rel err {trel}")
        if na is not None and (s_k[n - 9000:] != -1).any():
            raise AssertionError("K1 reported hits past n_alive")
    k1_ms = time_ms(lambda: ops.closest_hit(ds.cw, ds.cbox, o_cam, d_cam,
                                            tinf))
    k1_plain = time_ms(lambda: ci.intersect_clusters_reference(
        ds.cw, ds.cbox, o_cam, d_cam, tinf))
    kern_rows["closest_hit"] = dict(
        max_abs_err=max(r[3] for r in k1), ms=k1_ms, plain_ms=k1_plain)

    # real shadow rays: the first bounce of the wave, on the plain path
    carry = integ.initial_carry(o_cam, d_cam, ws.keys)
    raw = integ.intersect_raw(ds, o_cam, d_cam, None, integ.PLAIN_OPS)
    u_sel, u_l, u_b, u_rr = integ.bounce_draws(config, ws.keys, 0)
    lidx, selpdf = nee.sample_one_light(ds, u_sel)
    x0 = integ.pack_bounce_input(carry, raw, lidx, selpdf, u_l, u_b, u_rr,
                                 0)
    r0 = cb.unpack_out_t(cb.cbody_reference(
        x0, ds.ltab, ds.mtab, ds.stab, ds.static, config.min_depth,
        config.rr_threshold))
    sh = (r0["sh_o"].contiguous(), r0["sh_d"].contiguous(),
          r0["sh_t"].contiguous())
    tmax_sec = torch.tensor(rng.uniform(0.05, 6.0, n), dtype=torch.float32,
                            device=dev)
    k2 = []
    for name, (o_, d_, tm_), na in (("shadow", sh, None),
                                    ("secondary", (o_sec, d_sec, tmax_sec),
                                     n_alive)):
        b_k = ci.occluded_clusters(ds.cw, ds.cbox, o_, d_, tm_, na)
        b_p = ci.occluded_clusters_reference(ds.cw, ds.cbox, o_, d_, tm_,
                                             na)
        frac = (b_k == b_p).float().mean().item()
        k2.append((name, frac, b_k.float().mean().item()))
        if frac < K1_K2_GATE:
            raise AssertionError(f"K2 {name}: agree on {frac}")
    k2_ms = time_ms(lambda: ops.any_hit(ds.cw, ds.cbox, *sh))
    k2_plain = time_ms(lambda: ci.occluded_clusters_reference(
        ds.cw, ds.cbox, *sh))
    kern_rows["any_hit"] = dict(
        max_abs_err=max(float(r[1] < 1.0) for r in k2), ms=k2_ms,
        plain_ms=k2_plain)
    _say("[3] K1 " + "; ".join(
        f"{nm}: slots agree {fr:.6f}, max t rel {tr:.2e}, hit {h:.3f}"
        for nm, fr, tr, _, h in k1) + f"; {k1_ms:.3f} ms vs plain "
        f"{k1_plain:.3f} ms | K2 " + "; ".join(
        f"{nm}: agree {fr:.6f}, blocked {b:.3f}" for nm, fr, b in k2)
        + f"; {k2_ms:.3f} ms vs plain {k2_plain:.3f} ms")

    # phase 4: K3
    b2 = fuzz.all_branches_scene(sc.SceneBuilder())
    ds2 = sc.DeviceScene.build(b2, dev)
    k3 = []
    k3_err = 0.0
    flag_cols = (12, 13, 16, 24)
    cases = [("first bounce", x0, ds), ]
    for nm, dsx in (("fuzz cornell", ds), ("fuzz all-branches", ds2)):
        xf = fuzz.fuzz_bounce_inputs(dsx.ltab.cpu().numpy(),
                                     dsx.mtab.cpu().numpy(),
                                     dsx.stab.cpu().numpy(), seed=0, n=n)
        cases.append((nm, torch.tensor(xf.T.copy(), device=dev), dsx))
    for nm, xt, dsx in cases:
        args = (dsx.ltab, dsx.mtab, dsx.stab, dsx.static, config.min_depth,
                config.rr_threshold)
        out_k = cb.bounce_shade_t(xt, *args)
        out_p = cb.cbody_reference(xt, *args)
        both_nan = torch.isnan(out_k) & torch.isnan(out_p)
        close = torch.isclose(out_k, out_p, rtol=K3_RTOL, atol=K3_ATOL) \
            | both_nan
        frac = close.float().mean().item()
        flags = min((out_k[j] == out_p[j]).float().mean().item()
                    for j in flag_cols)
        exact = ((out_k == out_p) | both_nan).float().mean().item()
        k3_err = max(k3_err, (out_k - out_p).abs()[close].max().item())
        k3.append((nm, frac, flags, exact))
        if frac < K3_GATE or flags < K3_GATE:
            raise AssertionError(f"K3 {nm}: close {frac}, flags {flags}")
    args0 = (ds.ltab, ds.mtab, ds.stab, ds.static, config.min_depth,
             config.rr_threshold)
    k3_ms = time_ms(lambda: ops.bounce_shade(x0, *args0))
    k3_plain = time_ms(lambda: cb.cbody_reference(x0, *args0), iters=3)
    kern_rows["bounce_shade"] = dict(max_abs_err=k3_err, ms=k3_ms,
                                     plain_ms=k3_plain)
    _say("[4] K3 " + "; ".join(
        f"{nm}: close {fr:.6f}, flags {fl:.6f}, bit-exact {ex:.4f}"
        for nm, fr, fl, ex in k3) + f"; {k3_ms:.3f} ms vs plain "
        f"{k3_plain:.3f} ms")

    # phase 5: the main path against the golden and the plain path
    golden = np.load(os.path.join(REPO,
                                  "tests/data/cornell_golden_128x96.npy"))
    g64 = _block_mean(golden, 2)
    s5, cam5, film5, cfg5, _ = scenedesc.parse_scene(
        cb_json, spp_override=32, resolution_override=(64, 48))
    cfg5 = dataclasses.replace(cfg5, max_depth=8, wave_size=64 * 48 * 32)
    ds5 = sc.DeviceScene.build(s5, dev)
    ops.reset_counts()
    img_k = integ.render(ds5, cam5, film5, cfg5)
    torch.cuda.synchronize()
    launches = ops.counts()
    img_p = integ.render(ds5, cam5, film5, cfg5, ops=integ.PLAIN_OPS)
    img_k = img_k.cpu().numpy()
    img_p = img_p.cpu().numpy()
    if not np.isfinite(img_k).all() or img_k.shape != (48, 64, 3):
        raise AssertionError("kernel-path render is not finite [48,64,3]")
    clip = np.clip(img_k, 0.0, 1.0)
    mse_ds4 = float(((_block_mean(clip, 4) - _block_mean(g64, 4)) ** 2)
                    .mean())
    dmean = float(abs(clip.mean() - g64.mean()))
    dplain = float(np.abs(img_k - img_p).max())
    if out_dir:
        np.save(os.path.join(out_dir, "cornell_64x48_kernels.npy"), img_k)
    _say(f"[5] main path 64x48 32spp depth 8: launches {launches}; "
         f"mse_ds4 {mse_ds4:.3e} (gate {MSE_DS4_GATE}), |dmean| "
         f"{dmean:.3e} (gate {MEAN_GATE}); max |kernel - plain| "
         f"{dplain:.3e} (gate {PLAIN_ATOL})")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel was not launched: {launches}")
    if mse_ds4 >= MSE_DS4_GATE or dmean >= MEAN_GATE:
        raise AssertionError("golden gate failed")
    if dplain > PLAIN_ATOL:
        raise AssertionError("kernel path and plain path disagree")

    # phase 6: throughput
    rates = {}
    for name, wops in (("kernels", integ.KERNEL_OPS),
                       ("plain", integ.PLAIN_OPS)):
        integ.render(ds, camera, film_cfg,
                     dataclasses.replace(config, spp=1, sample_dx=1,
                                         sample_dy=1), ops=wops)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = integ.render(ds, camera, film_cfg, config, ops=wops)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if not torch.isfinite(img).all():
            raise AssertionError(f"{name} render not finite")
        rates[name] = 256 * 256 * 16 / dt
    _say(f"[6] throughput 256x256 16spp depth 8: kernels "
         f"{rates['kernels']:.0f} paths/s, plain {rates['plain']:.0f} "
         f"paths/s ({card})")

    src = "arendur_tpu_torch/kernels/"
    meta = {
        "closest_hit": (src + "intersect.cu",
                        "arendur_tpu/shapes/pallas_intersect.py:138"),
        "any_hit": (src + "intersect.cu",
                    "arendur_tpu/shapes/pallas_intersect.py:195"),
        "bounce_shade": (src + "cbounce.cu",
                         "arendur_tpu/render/cbounce.py:955"),
    }
    rows = [dict(name=k, route="cuda", source=meta[k][0],
                 replaces=meta[k][1], launches=launches[k],
                 **kern_rows[k]) for k in ("closest_hit", "any_hit",
                                           "bounce_shade")]
    if out_dir:
        with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
            json.dump(dict(card=card, kernels=rows, paths_per_s=rates,
                           mse_ds4=mse_ds4, dmean=dmean, dplain=dplain,
                           k1=k1, k2=k2, k3=k3), f, indent=1)
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
