"""Time the bounce-shade kernels at each bounce of one wave on the card:
K3 over the eight bounces of a fused wave, K6 over those of a textured
one.

    [PYTHONPATH=DIR] python tools/shade_bounces.py [--orders]

Times the arendur_tpu_torch that Python imports: this checkout's, or
the one in DIR, so that one call can time two checkouts in turns
(unpack each with git archive).  The cells are chip_smoke.py phase 6's
and phase 10's: wave 0 of examples/cornellbox/cb.json at 256x256, 16
spp, depth 8, waves of 65,536, untextured and with bench.py's checker
kd texture on every matte material (render/fuzz.py checker_textured).
The bounce inputs are recorded on the imported package's kernel path by
this checkout's render/fuzz.py wave_shades.  Per bounce: the live lanes
(the wave's compaction count: its lanes alive on entry, which come
first), the kernel's time per launch on inputs rotated past the L2 on
the card by the profiler and by queued CUDA events (chip_smoke.py
kernel_ms) and by CUDA events around back-to-back calls (time_ms,
which also counts the host's launch work), and the bound: the bytes of
the dead-lane contract (render/cbounce.py) over 3.35 TB/s: a live lane
reads its input and writes its output columns (K3 360 B, K6 328 B), a
lane past the live count reads 9 carried columns and writes 32 (164
B), and the tables are read once.  A checkout whose shade takes no
live count shades every lane, and is timed so.  With --orders, each
bounce is also timed with its live lanes in two other orders, to show
what divergence within a warp costs: sorted by branch class over the
whole launch (hit, sphere, material row or type, the sampled light's
type, the BSDF sample number in sixths: the arms of the body's
branches) and every live lane a copy of the first (one path, no
divergence).  Needs one card.  Prints one JSON object, with the card's
name and power limit.
"""

import argparse
import dataclasses
import importlib.util
import inspect
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.append(REPO)

LIVE_BYTES = {"K3": 4 * (58 + 32), "K6": 4 * (50 + 32)}
DEAD_BYTES = 4 * (9 + 32)


def this_checkouts(name, path):
    """This checkout's module at path, whichever arendur_tpu_torch Python
    imports (another checkout's may come first on the path)."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = this_checkouts("shade_bounces_chip_smoke", "chip_smoke.py")


def branch_order(xt, live, cols, ltab, c_ltype, stab):
    """The first `live` lanes of xt by branch class (stable), then the
    others; cols: the input columns of (hit, sphere or None, sphere row
    or None, material id or type, light index, BSDF sample)."""
    import torch
    c_hit, c_sph, c_sidx, c_mat, c_lidx, c_ub = cols
    x = xt[:, :live]
    hit = (x[c_hit] > 0.5).long()
    mat = x[c_mat]
    sph = torch.zeros_like(hit)
    if c_sph is not None:
        sph = (x[c_sph] > 0.5).long()
        srow = x[c_sidx].long().clamp(0, stab.shape[0] - 1)
        mat = torch.where(sph > 0, stab[srow, 20], mat)
    lt = ltab[x[c_lidx].long().clamp(0, ltab.shape[0] - 1), c_ltype].long()
    sixth = (x[c_ub] * 6.0).long().clamp(0, 5)
    key = ((((hit * 2 + sph) * 256 + mat.long().clamp(0, 255)) * 8
            + lt.clamp(0, 7)) * 8 + sixth)
    perm = torch.argsort(key, stable=True)
    return torch.cat([perm, torch.arange(live, xt.shape[1],
                                         device=xt.device)])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--orders", action="store_true",
                    help="also time each bounce's live lanes sorted by "
                    "branch class and as copies of one lane")
    orders = ap.parse_args().orders
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("shade_bounces: CUDA is not available")
    import arendur_tpu_torch
    from arendur_tpu_torch import scene as sc
    from arendur_tpu_torch.io import scenedesc
    from arendur_tpu_torch.kernels import ops
    from arendur_tpu_torch.render import cbounce as cb
    from arendur_tpu_torch.render import integrator as integ

    fuzz = this_checkouts("shade_bounces_fuzz",
                          "arendur_tpu_torch/render/fuzz.py")
    dev = torch.device("cuda", 0)
    scene, camera, film_cfg, config, _ = scenedesc.parse_scene(
        os.path.join(REPO, "examples/cornellbox/cb.json"),
        spp_override=16, resolution_override=(256, 256))
    config = dataclasses.replace(config, max_depth=8, wave_size=1 << 16)
    ds = sc.DeviceScene.build(scene, dev)
    scene_t, atlas = fuzz.checker_textured(scene, dev)
    ds_t = sc.DeviceScene.build(scene_t, dev)
    takes_count = "n_alive" in inspect.signature(
        ops.bounce_shade).parameters
    shade = dict(rr=config.rr_threshold, md=config.min_depth)

    def k3(dsx):
        return lambda x, **kw: ops.bounce_shade(
            x, dsx.ltab, dsx.mtab, dsx.stab, dsx.static, shade["md"],
            shade["rr"], **kw)

    def k6(dsx):
        return lambda x, **kw: ops.shade_split(
            x, dsx.ltab, dsx.static, shade["md"], shade["rr"], **kw)

    cells = (("K3", ds, config, k3(ds), cb.C_ALIVE, "bounce_shade_kernel",
              ds.ltab.numel() + ds.mtab.numel() + ds.stab.numel(),
              (cb.C_HIT, cb.C_IS_SPH, cb.C_S_IDX, cb.C_TROW + 24, cb.C_LIDX,
               cb.C_U_BSDF)),
             ("K6", ds_t, dataclasses.replace(config, textures=atlas),
              k6(ds_t), cb.S_ALIVE, "shade_split_kernel", ds_t.ltab.numel(),
              (cb.S_HIT, None, None, cb.S_MTYPE, cb.S_LIDX, cb.S_U_BSDF)))
    out = dict(card=cs.card_line(), torch=torch.__version__,
               package=os.path.dirname(os.path.abspath(
                   arendur_tpu_torch.__file__)),
               takes_live_count=takes_count)
    for name, dsx, cfgx, entry, c_alive, key, tab, cols in cells:
        rows = []
        for b, r in enumerate(fuzz.wave_shades(dsx, camera, film_cfg, cfgx,
                                               integ.KERNEL_OPS)):
            xt = r["xt"]
            n = xt.shape[1]
            live = int((xt[c_alive] > 0.5).sum())
            kw = {}
            if takes_count:
                kw["n_alive"] = torch.tensor(live, dtype=torch.int32,
                                             device=dev)
            call = cs.rotating(lambda x: entry(x, **kw), xt)  # noqa: B023
            dev_ms, queued = cs.kernel_ms(call, key)
            nbytes = (live * LIVE_BYTES[name] + (n - live) * DEAD_BYTES
                      + 4 * tab)
            rows.append(dict(bounce=b, live=live, lanes=n, device_ms=dev_ms,
                             queued_ms=queued, ms=cs.time_ms(call),
                             bound_ms=cs.bound_ms(nbytes, 0)[0]))
            if orders and live:
                c_ltype = dict(dsx.static.lcidx)["ltype"][0]
                perm = branch_order(xt, live, cols, dsx.ltab, c_ltype,
                                    dsx.stab)
                one = torch.cat([torch.zeros(live, dtype=torch.long,
                                             device=dev),
                                 torch.arange(live, n, device=dev)])
                for order, p in (("sorted_ms", perm), ("one_path_ms", one)):
                    xp = xt[:, p].contiguous()
                    rows[-1][order] = cs.kernel_ms(cs.rotating(
                        lambda x: entry(x, **kw), xp), key)[0]  # noqa: B023
        out[name] = dict(
            per_bounce=rows,
            device_ms_per_wave=sum(r["device_ms"] for r in rows),
            queued_ms_per_wave=sum(r["queued_ms"] for r in rows),
            ms_per_wave=sum(r["ms"] for r in rows),
            bound_ms_per_wave=sum(r["bound_ms"] for r in rows))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
