"""Host seconds of the scene build's BVH on this machine's CPU: the
port's native build (arendur_tpu_torch/native, accel/bvh.py build_bvh)
and its NumPy twin (build_bvh_plain) beside the JAX package's native
build, and the port's build_clusters beside the JAX package's, on
tests/test_bvh.py's random triangles (np.random.default_rng(seed)),
with every array checked equal.

    JAX_PLATFORMS=cpu python tools/bvh_build_times.py [--tris 10000 100000]
        [--seed 0] [--plain]

A CPU comparison with the JAX package (as the tests make), never run on
the card.  --plain also times the NumPy build (seconds to minutes at
10^5 triangles).  Prints one line per size and per build.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))
sys.path.insert(0, os.path.join(REPO, "tools"))

FIELDS = ("bmin", "bmax", "second", "start", "count", "axis", "order")


def timed(fn, *a):
    t0 = time.perf_counter()
    out = fn(*a)
    return out, time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tris", type=int, nargs="+", default=[10000, 100000])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--plain", action="store_true")
    a = ap.parse_args(argv)
    from arendur_tpu import native as jnative
    from arendur_tpu.accel import clusters as jclusters
    from arendur_tpu_torch.accel import bvh as tbvh
    from arendur_tpu_torch.accel import clusters as tclusters
    from test_bvh import random_tris
    from host_cpu import host_cpu
    print(f"host: {host_cpu()}")
    # the libraries built and loaded before any timing
    v = random_tris(8, seed=a.seed)
    tbvh.build_bvh(*v)
    jnative.build_bvh_native(*v)
    for n in a.tris:
        v = random_tris(n, seed=a.seed)
        nat, t_nat = timed(tbvh.build_bvh, *v)
        jn, t_jn = timed(jnative.build_bvh_native, *v)
        eq = all(np.array_equal(getattr(nat, f), jn[f]) for f in FIELDS)
        print(f"{n} triangles: BVH port native {t_nat:.4f} s, JAX native "
              f"{t_jn:.4f} s, arrays equal {eq}")
        if a.plain:
            pl, t_pl = timed(tbvh.build_bvh_plain, *v)
            eq = all(np.array_equal(getattr(nat, f), getattr(pl, f))
                     for f in FIELDS)
            print(f"{n} triangles: BVH port NumPy {t_pl:.3f} s, equal to "
                  f"the native {eq}")
        tc, t_tc = timed(tclusters.build_clusters, *v)
        jc, t_jc = timed(jclusters.build_clusters, *v)
        eq = all(np.array_equal(tc[k], jc[k])
                 for k in ("w_chunks", "cbox", "remap", "order"))
        print(f"{n} triangles: build_clusters port {t_tc:.3f} s, JAX "
              f"{t_jc:.3f} s (ratio {t_tc / t_jc:.2f}), C = "
              f"{tc['w_chunks'].shape[0]} clusters, arrays equal {eq}")


if __name__ == "__main__":
    main()
