"""Hold the parts of a render that the many-light scene stresses against
the JAX package, on the same draws, on the CPU: the light CDF and the
power-weighted pick, the light samples (radiance, pdf, point,
direction), the deferred MIS weight, and the closest hits of rays aimed
at the sampled light points.  The scene is tests/torch_oracles.py's
``big_lights`` (cb.json with 1,200 small sphere lights over 48
materials).

    JAX_PLATFORMS=cpu python tools/witness_big_lights.py [--n 20000] \
        [--theta compat|area] [--repeat 3]

It prints one line for each part: the largest difference between the
packages, and where they are equal to the bit, that.  --theta picks the
sphere sampling mode on both sides (the port's THETA_UNIFORM_COMPAT, the
JAX row sampler's own theta_uniform argument).  For the light samples
on sphere lights it also takes the solid-angle pdf in float64 from each
side's own float32 point (pdf = d^2 / (area |cos|), the normal from the
sphere's center), so that a difference of the sampled points and one of
the float32 pdf's rounding are told apart; and it repeats each side's
light sample --repeat times on the same inputs in the process, and
prints a digest of each side's outputs, so that runs can be compared.
"""

import argparse
import functools
import hashlib
import os
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))


def _diff(a, b):
    d = np.abs(a - b)
    return (f"max |diff| {d.max():.3e}, max rel "
            f"{(d / np.maximum(np.abs(a), 1e-30)).max():.3e}, equal to the "
            f"bit {np.array_equal(a, b)}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=20000, help="draws")
    ap.add_argument("--theta", choices=("compat", "area"), default="compat",
                    help="sphere-light sampling mode on both sides")
    ap.add_argument("--repeat", type=int, default=3,
                    help="light samples per side on the same inputs")
    args = ap.parse_args(argv)
    n = args.n

    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    import torch_oracles as orc
    from arendur_tpu import scene as jsc
    from arendur_tpu.io import scenedesc as jsd
    from arendur_tpu.lighting import nee as jnee
    from arendur_tpu_torch import scene as tsc
    from arendur_tpu_torch.io import scenedesc as tsd
    from arendur_tpu_torch.lighting import nee as tnee
    from arendur_tpu_torch.render import cmath as cm
    from arendur_tpu_torch.shapes import sphere as tsph

    if args.theta == "area":
        tsph.THETA_UNIFORM_COMPAT = False
        jnee._sample_sphere_local_row = functools.partial(
            jnee._sample_sphere_local_row, theta_uniform=False)

    with tempfile.TemporaryDirectory() as tmp:
        path = orc.big_lights_scene(tmp)
        js = jsd.parse_scene(path)[0]
        ds = tsc.DeviceScene.build(tsd.parse_scene(path)[0], "cpu")

    def tt(a):
        return torch.tensor(a)

    jd, td = js.light_distribution, ds.light_distribution
    for f in ("func", "cdf", "func_int"):
        print(f"light distribution {f}: "
              + _diff(np.asarray(getattr(jd, f)),
                      np.asarray(getattr(td, f))))
    rng = np.random.default_rng(0)
    u = rng.random(n, dtype=np.float32)
    ji, jp = (np.asarray(x) for x in jnee.sample_one_light(js, jnp.asarray(u)))
    ti, tp = (x.numpy() for x in tnee.sample_one_light(ds, tt(u)))
    print(f"light pick: {int((ji != ti).sum())} of {n} differ; selection "
          f"pdf: " + _diff(jp, tp))

    pos = rng.uniform([-0.9, 0.1, -0.9], [0.9, 1.9, 0.9],
                      (n, 3)).astype(np.float32)
    u2 = rng.random((n, 2), dtype=np.float32)
    keys = ("radiance", "pdf", "pfrom", "wi")
    before = [a.copy() for a in (ti, pos, u2, ds.ltab.numpy())]
    runs_j = [{k: np.asarray(v) for k, v in jnee.light_sample(
        js, jnp.asarray(ti), jnp.asarray(pos), jnp.asarray(u2)).items()
        if k in keys} for _ in range(args.repeat)]
    runs_t = [{k: v.numpy() for k, v in tnee.light_sample(
        ds, tt(ti), tt(pos), tt(u2)).items() if k in keys}
        for _ in range(args.repeat)]
    jl, tl = runs_j[0], runs_t[0]
    for k in keys:
        print(f"light sample {k}: " + _diff(jl[k], tl[k]))
    for side, runs in (("JAX", runs_j), ("port", runs_t)):
        same = all(np.array_equal(r[k], runs[0][k]) for r in runs
                   for k in keys)
        digest = hashlib.sha1(b"".join(runs[0][k].tobytes()
                                       for k in keys)).hexdigest()[:12]
        lanes = [int((r["pfrom"] != runs[0]["pfrom"]).any(1).sum())
                 for r in runs[1:]]
        print(f"{side} light sample, {args.repeat} runs in this process: "
              f"equal to the bit {same} (lanes whose point differs from "
              f"the first run's: {lanes}); digest {digest}")
    print("the inputs and the port's light table unchanged by the calls: "
          + str(all(np.array_equal(a, b) for a, b in zip(
              before, (ti, pos, u2, ds.ltab.numpy())))))

    # the solid-angle pdf in float64 from each side's own float32 point,
    # on the sphere lights' lanes where the sample counts
    row = tnee._light_rows(ds, tt(ti))
    sph_l = (row.col1("ltype").numpy() == tsc.L_AREA_SPHERE) \
        & (tl["pdf"] > 0) & (jl["pdf"] > 0)
    zero = torch.zeros(n)
    center = np.stack([c.numpy() for c in cm.tp16(
        row.col16("s_o2w"), (zero, zero, zero))], -1).astype(np.float64)
    area = (row.col1("s_phimax").double() * row.col1("s_radius").double()
            * (row.col1("s_zmax").double() - row.col1("s_zmin").double())
            ).numpy()

    def pdf64(pfrom):
        p = pfrom.astype(np.float64)
        nrm = p - center
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
        w = p - pos.astype(np.float64)
        d2 = (w * w).sum(1)
        cos = np.abs((nrm * w).sum(1)) / np.sqrt(d2)
        return d2 / (area * cos), cos

    p64_j, cos_j = (a[sph_l] for a in pdf64(jl["pfrom"]))
    p64_t = pdf64(tl["pfrom"])[0][sph_l]
    p32_j, p32_t = jl["pdf"][sph_l], tl["pdf"][sph_l]

    def rel(a, b):
        return np.abs(a - b) / np.abs(b)
    worst = np.argmax(rel(p32_t, p32_j))
    print(f"sphere-light pdf on {int(sph_l.sum())} lanes: float32 port vs "
          f"JAX max rel {rel(p32_t, p32_j).max():.3e}; float64 from each "
          f"side's own point, port vs JAX max rel "
          f"{rel(p64_t, p64_j).max():.3e}; each side's float32 pdf vs the "
          f"float64 of its own point: JAX max rel "
          f"{rel(p32_j, p64_j).max():.3e}, port "
          f"{rel(p32_t, p64_t).max():.3e}; at the worst lane |cos| "
          f"{cos_j[worst]:.3e}, float32 rel {rel(p32_t, p32_j)[worst]:.3e}, "
          f"float64 rel {rel(p64_t, p64_j)[worst]:.3e}")

    # half the directions toward the sampled points, so the light pdf of
    # the MIS weight is nonzero there
    wi = rng.normal(size=(n, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)
    wi[: n // 2] = jl["wi"][: n // 2]
    pdf2 = rng.uniform(0.1, 2.0, n).astype(np.float32)
    kind2 = np.zeros(n, np.int32)
    f2 = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    args = (ti, tp, pos, wi, pdf2, kind2, f2)
    jw = np.asarray(jnee.path_mis_weight(js, *(jnp.asarray(a)
                                               for a in args)))
    tw = tnee.path_mis_weight(ds, *(tt(a) for a in args)).numpy()
    print(f"MIS weight ({int((jw != 0).sum())} nonzero): " + _diff(jw, tw))

    to = jl["pfrom"] - pos
    to = (to / np.linalg.norm(to, axis=1, keepdims=True)).astype(np.float32)
    jh = jsc.intersect(js, jnp.asarray(pos), jnp.asarray(to))
    th = tsc.intersect(ds, tt(pos), tt(to))
    jpr, tpr = np.asarray(jh.prim), th.prim.numpy()
    same = (jpr == tpr) & np.isfinite(np.asarray(jh.t))
    print(f"closest hits toward the sampled points: prim differs on "
          f"{int((jpr != tpr).sum())} of {n}; t where it agrees: "
          + _diff(np.asarray(jh.t)[same], th.t.numpy()[same]))


if __name__ == "__main__":
    main()
