"""Hold the parts of a render that the many-light scene stresses against
the JAX package, on the same draws, on the CPU: the light CDF and the
power-weighted pick, the light samples (radiance, pdf, point,
direction), the deferred MIS weight, and the closest hits of rays aimed
at the sampled light points.  The scene is tests/torch_oracles.py's
``big_lights`` (cb.json with 1,200 small sphere lights over 48
materials).

    JAX_PLATFORMS=cpu python tools/witness_big_lights.py [--n 20000]

It prints one line for each part: the largest difference between the
packages, and where they are equal to the bit, that.
"""

import argparse
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
    n = ap.parse_args(argv).n

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
    jl = jnee.light_sample(js, jnp.asarray(ti), jnp.asarray(pos),
                           jnp.asarray(u2))
    tl = tnee.light_sample(ds, tt(ti), tt(pos), tt(u2))
    for k in ("radiance", "pdf", "pfrom", "wi"):
        print(f"light sample {k}: " + _diff(np.asarray(jl[k]),
                                            tl[k].numpy()))

    # half the directions toward the sampled points, so the light pdf of
    # the MIS weight is nonzero there
    wi = rng.normal(size=(n, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)
    wi[: n // 2] = np.asarray(jl["wi"])[: n // 2]
    pdf2 = rng.uniform(0.1, 2.0, n).astype(np.float32)
    kind2 = np.zeros(n, np.int32)
    f2 = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    args = (ti, tp, pos, wi, pdf2, kind2, f2)
    jw = np.asarray(jnee.path_mis_weight(js, *(jnp.asarray(a)
                                               for a in args)))
    tw = tnee.path_mis_weight(ds, *(tt(a) for a in args)).numpy()
    print(f"MIS weight ({int((jw != 0).sum())} nonzero): " + _diff(jw, tw))

    to = np.asarray(jl["pfrom"]) - pos
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
