"""Time the bounce-shade backward (K4) at each bounce of one train step
on the card, and the step around it.

    [PYTHONPATH=DIR] python tools/k4_bounces.py

Times the arendur_tpu_torch that Python imports: this checkout's, or
the one in DIR, so that one call can time two checkouts in turns
(unpack each with git archive).  The cell is chip_smoke.py phase 8's:
examples/cornellbox/cb.json at 256x256, 16 spp, depth 8, waves of
65,536, kd at 1.25x its table value against the kernel-path image.
The bounces are recorded by this checkout's render/fuzz.py
train_step_bounces (with each bounce's live count, where the timed
checkout's wave hands its shade one) and timed with chip_smoke.py's
helpers: per bounce,
K4's ms per call by CUDA events (time_ms) and on the card (every
launch of the call, k4_device_ms); then fwd+bwd paths/s over 3 steps
after a warm one, and one step's wall and device busy time
(wave_profile, _busy_s).  Needs one card.  Prints one JSON object,
with the card's name and power limit.
"""

import dataclasses
import importlib.util
import json
import os
import sys
import time

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


cs = this_checkouts("k4_bounces_chip_smoke", "chip_smoke.py")


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("k4_bounces: CUDA is not available")
    import arendur_tpu_torch
    from arendur_tpu_torch import scene as sc
    from arendur_tpu_torch.io import scenedesc
    from arendur_tpu_torch.kernels import ops
    from arendur_tpu_torch.parallel import mesh
    from arendur_tpu_torch.render import integrator as integ

    dev = torch.device("cuda", 0)
    scene, camera, film_cfg, config, _ = scenedesc.parse_scene(
        os.path.join(REPO, "examples/cornellbox/cb.json"),
        spp_override=16, resolution_override=(256, 256))
    wave = 1 << 16
    config = dataclasses.replace(config, max_depth=8, wave_size=wave)
    ds = sc.DeviceScene.build(scene, dev)
    target = integ.render(ds, camera, film_cfg, config).reshape(-1, 3)
    idx0 = torch.arange(wave, device=dev)
    cfg = (ds.static, config.min_depth, config.rr_threshold)

    per_bounce = []
    fuzz = this_checkouts("k4_bounces_fuzz",
                          "arendur_tpu_torch/render/fuzz.py")
    for r in fuzz.train_step_bounces(
            ds, camera, film_cfg, config, integ.KERNEL_OPS, target, idx0):
        args = (r["xt"], r["ltab"], r["mtab"], r["stab"], r["ct"]) + cfg
        # the bounce's live count, where the checkout's wave hands one
        kw = {} if r.get("n_alive") is None else {"n_alive": r["n_alive"]}
        call = lambda: ops.bounce_shade_bwd(*args, **kw)  # noqa: E731
        per_bounce.append(dict(ms=cs.time_ms(call, 5),
                               device_ms=cs.k4_device_ms(call)))

    step = mesh.train_step_fn(ds, camera, film_cfg, config)
    kd0 = torch.tensor(scene.materials.kd, device=dev) * 1.25
    kd, _ = step(kd0, target, idx0)
    torch.cuda.synchronize()
    reps = 3
    t0 = time.perf_counter()
    for i in range(1, reps + 1):
        kd, _ = step(kd, target, (i % 16) * wave + idx0)
    torch.cuda.synchronize()
    paths_s = reps * wave / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    step(kd0, target, idx0)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    busy, launches, _ = cs._busy_s(
        cs.wave_profile(lambda: step(kd0, target, idx0)))
    print(json.dumps(dict(
        card=cs.card_line(), torch=torch.__version__,
        package=os.path.dirname(os.path.abspath(arendur_tpu_torch.__file__)),
        per_bounce=per_bounce,
        k4_ms_per_step=sum(r["ms"] for r in per_bounce),
        k4_device_ms_per_step=sum(r["device_ms"] for r in per_bounce),
        step_ms=1e3 * step_s, step_busy_ms=1e3 * busy,
        step_launches=launches, fwd_bwd_paths_per_s=paths_s)))


if __name__ == "__main__":
    main()
