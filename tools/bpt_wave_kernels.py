"""Break one BPT wave's kernel time down by call, on the card.

    python tools/bpt_wave_kernels.py [--waves]

Records wave 0 of a 256x256, 16 spp, depth-8 BPT render of
examples/cornellbox/cb.json as the kernel path runs it (render/fuzz.py
bpt_wave_sets: 17 closest-hit and 44 any-hit queries, 17 BSDF samples,
161 fused evaluations), then times on the card, each by CUDA events
around calls queued while the card sleeps (chip_smoke.py queued_ms):

* each K1 / K2 query as recorded, all 65,536 lanes;
* each walk query after a walk's first again with the lanes that hit at
  every earlier step of the walk moved to the front and the live count
  set to their number: what compacting the walk would leave K1 (a walk
  that missed is dead; the count is an upper bound on the live lanes,
  since a BSDF sample also ends walks);
* K8 on each walk vertex and K9 on each of its calls, inputs rotated
  past the L2: the in-place sweep in wave order and in the BSDF's
  material-recipe order (which takes divergence within a warp away),
  and the earlier route's raw launch on the lane-major pack; the
  order's own launches once per BSDF; and the wave's K8 + K9 device
  ms with the order on neither kernel, on both, or on one of them
  (the entries take it on K8 only).  K8 runs in wave order under the
  identity order; K9, which takes no order, runs in recipe order on a
  copy of its BSDF and inputs gathered into that order (its outputs
  then land in the order's places, which the timing ignores).

With --waves it only times whole waves, for the package Python imports
(PYTHONPATH=DIR runs another checkout's, so that one call can run
parent, change, change, parent): one BPT wave of cb.json and one
composed wave of examples/cornellbox/cb_etex.json (256x256, 16 spp,
depth 8, 65,536 lanes), each three times after a warm-up: wall ms, the
hand-written kernels' launches, all device launches, busy ms and K8 /
K9 / order device ms from a torch.profiler trace (chip_smoke.py
_busy_s).

Needs one card.  Prints one JSON object, with the card's name and power
limit.
"""

import dataclasses
import importlib.util
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.append(REPO)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "bpt_wave_kernels_chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def waves(cs):
    """--waves: the BPT and the composed wave, timed whole."""
    import time
    import torch
    import arendur_tpu_torch
    from arendur_tpu_torch import scene as sc
    from arendur_tpu_torch.io import scenedesc
    from arendur_tpu_torch.kernels import build, ops
    from arendur_tpu_torch.render import bpt
    from arendur_tpu_torch.render import integrator as integ
    from arendur_tpu_torch.sampling import sampler as smp

    dev = torch.device("cuda", 0)
    build.build()
    build.load()
    n = 1 << 16
    ray_idx = torch.arange(n, device=dev)
    pid, sid = ray_idx // 16, ray_idx % 16
    pxy = torch.stack([(pid % 256).float(), (pid // 256).float()], -1)
    key = smp.make_base_key(0)
    out = dict(card=cs.card_line(), package=os.path.dirname(
        os.path.abspath(arendur_tpu_torch.__file__)))
    for name, scene_file in (("bpt", "cb.json"), ("composed", "cb_etex.json")):
        scene, camera, film_cfg, config, _ = scenedesc.parse_scene(
            os.path.join(REPO, "examples/cornellbox", scene_file),
            spp_override=16, resolution_override=(256, 256))
        config = dataclasses.replace(config, max_depth=8, wave_size=n)
        ds = sc.DeviceScene.build(scene, dev)
        if name == "bpt":
            run = lambda: bpt.trace_wave_bpt(  # noqa: E731
                ds, camera, config, film_cfg, pxy, pid, sid, key)
        else:
            run = lambda: integ.trace_wave(  # noqa: E731
                ds, camera, config, pxy, pid, sid, key)
        reps = []
        with torch.no_grad():
            run()
            for _ in range(3):
                torch.cuda.synchronize()
                ops.reset_counts()
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = {k: v for k, v in ops.counts().items() if v}
                busy, nk, own = cs._busy_s(cs.wave_profile(run))
                reps.append(dict(wall_ms=1e3 * wall, launches=launches,
                                 device_launches=nk, busy_ms=1e3 * busy,
                                 kernel_ms={k: 1e3 * v
                                            for k, v in own.items()}))
        out[name] = reps
    print(json.dumps(out))


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bpt_wave_kernels: CUDA is not available")
    cs = _chip_smoke()
    if "--waves" in sys.argv[1:]:
        return waves(cs)
    from arendur_tpu_torch import scene as sc
    from arendur_tpu_torch.bxdf import slot_shade as ssh
    from arendur_tpu_torch.io import scenedesc
    from arendur_tpu_torch.kernels import build, ops
    from arendur_tpu_torch.render import fuzz
    from arendur_tpu_torch.render import integrator as integ

    dev = torch.device("cuda", 0)
    build.build()
    build.load()
    scene, camera, film_cfg, config, _ = scenedesc.parse_scene(
        os.path.join(REPO, "examples/cornellbox/cb.json"), spp_override=16,
        resolution_override=(256, 256))
    config = dataclasses.replace(config, max_depth=8, wave_size=1 << 16)
    ds = sc.DeviceScene.build(scene, dev)
    with torch.no_grad():
        sets = fuzz.bpt_wave_sets(ds, camera, film_cfg, config,
                                  integ.KERNEL_OPS)

    def query_args(q, perm=None, n_alive=None):
        o, d, tmax = q["o"], q["d"], q["tmax"]
        if perm is not None:
            o, d, tmax = o[perm], d[perm], tmax[perm]
        return (ds.cw, ds.cbox, o, d, tmax, n_alive, q["period"],
                q["sph_tab"], q["full_phi"])

    queries, prev_hit = [], {}
    for q in sets["queries"]:
        fn = ops.closest_hit if q["kind"] == "closest" else ops.any_hit
        args = query_args(q)
        row = dict(tag=q["tag"], kind=q["kind"],
                   ms=cs.queued_ms(lambda: fn(*args)))
        walk = q["tag"].rsplit(" ", 1)[0] if "walk" in q["tag"] else None
        if walk in prev_hit:
            hit = prev_hit[walk]
            perm = torch.argsort((~hit).to(torch.int8), stable=True)
            n_live = hit.sum().to(torch.int32)
            cargs = query_args(q, perm, n_live)
            row.update(live=int(n_live),
                       compacted_ms=cs.queued_ms(lambda: fn(*cargs)))
        if walk is not None:
            hit = q["slot"] != -1
            prev_hit[walk] = hit & prev_hit[walk] if walk in prev_hit \
                else hit
        queries.append(row)

    # K8 / K9 on each call of the wave as recorded (bxdf/slot_shade.py's
    # in-place entries), inputs rotated past the L2: the sweep in wave
    # order, the sweep in the BSDF's recipe order (built beforehand), and
    # the earlier route's raw launch on the lane-major pack; per BSDF
    # the order's two launches (ops.slot_order)
    fields = [k for k, _, _ in ops.SLOT_FIELDS]

    def gathered(b, wo, x):
        """b, wo and x with their lanes gathered into b's recipe order."""
        order = ssh.lane_order(b).long()
        return (b.replace(**{k: getattr(b, k)[order] for k in fields}),
                wo[order], x[order])

    def call_ms(name, r):
        x = r["u"] if name == "k8" else r["wi"]
        packed = (ops.slot_sample_packed if name == "k8"
                  else ops.slot_eval_pdf_packed)
        types = r["types"]
        copies = cs.slot_rotation(r["b"], r["wo"], x)
        if name == "k8":
            ident = torch.arange(x.shape[0], dtype=torch.int32,
                                 device=x.device)
            wave = cs.queued_ms(cs.cycling(
                lambda b, w, x_: ops.slot_sample(b, w, x_, types, ident),
                copies))
            ordered = cs.queued_ms(cs.cycling(
                lambda b, w, x_: ops.slot_sample(b, w, x_, types,
                                                 ssh.lane_order(b)),
                copies))
        else:
            wave = cs.queued_ms(cs.cycling(
                lambda b, w, x_: ops.slot_eval_pdf(b, w, x_, types),
                copies))
            copies = [gathered(*c) for c in copies]
            ordered = cs.queued_ms(cs.cycling(
                lambda b, w, x_: ops.slot_eval_pdf(b, w, x_, types),
                copies))
        xs = ssh.pack_slots(r["b"], r["wo"], x)
        earlier = cs.queued_ms(cs.rotating(
            lambda x_: packed(x_, types, r["b"].present, r["b"].dists), xs))
        del copies, xs
        t = r["b"].type.to(torch.int64)
        key = sum(t[:, j] * 16 ** j for j in range(t.shape[1]))
        return dict(recipes=int(torch.unique(key).numel()), wave_ms=wave,
                    ordered_ms=ordered, earlier_ms=earlier)

    k8 = [dict(call=i, **call_ms("k8", r))
          for i, r in enumerate(sets["samples"])]
    k9 = [call_ms("k9", r) for r in sets["evals"]]
    order_ms = []
    for r in sets["samples"]:      # one BSDF per walk vertex
        copies = cs.slot_rotation(r["b"], r["wo"], r["u"])
        order_ms.append(cs.queued_ms(cs.cycling(
            lambda b, w, x_: ops.slot_order(b), copies)))
        del copies
    n_walk = len(sets["samples"])
    tot = lambda rows, key: sum(r[key] for r in rows)  # noqa: E731
    sums = dict(k8_wave=tot(k8, "wave_ms"), k8_ordered=tot(k8, "ordered_ms"),
                k8_earlier=tot(k8, "earlier_ms"),
                k9_wave=tot(k9, "wave_ms"), k9_ordered=tot(k9, "ordered_ms"),
                k9_earlier=tot(k9, "earlier_ms"), orders=sum(order_ms))
    # the wave's K8 + K9 device ms with the order on neither, both, or
    # one of them (the order built once per BSDF wherever it is used)
    sums["combos"] = {
        "neither": sums["k8_wave"] + sums["k9_wave"],
        "both": sums["k8_ordered"] + sums["k9_ordered"] + sums["orders"],
        "k8 only": sums["k8_ordered"] + sums["k9_wave"] + sums["orders"],
        "k9 only": sums["k8_wave"] + sums["k9_ordered"] + sums["orders"]}
    # the walks' reverse densities are the first K9 call after each
    # walk step's sample, in the walks' order (render/bpt.py)
    walk9, conn9 = k9[:n_walk], k9[n_walk:]
    mean = lambda v: sum(v) / max(len(v), 1)  # noqa: E731
    print(json.dumps(dict(
        card=cs.card_line(), queries=queries, k8=k8, order_ms=order_ms,
        k9=dict(walk=[{k: r[k] for k in ("wave_ms", "ordered_ms",
                                         "earlier_ms")} for r in walk9],
                connection_mean={k: mean([r[k] for r in conn9])
                                 for k in ("wave_ms", "ordered_ms",
                                           "earlier_ms")},
                connection_calls=len(conn9)),
        sums_ms=sums)))


if __name__ == "__main__":
    main()
