"""The brute-force triangle test and the BVH walk of the port
(arendur_tpu_torch/shapes/triangle.py, accel/bvh.py) against the JAX
package's (arendur_tpu/shapes/triangle.py, accel/bvh.py) on random
triangles and rays (tests/test_bvh.py's setup: 64 and 1,000 triangles,
512 rays), and the port's BVH arrays against the JAX package's native
build.

Tolerance: the hit masks and the triangle index are equal on every
lane; t, b0 and b1 are equal to the bit or, where XLA contracts a
product difference into an fma, t within T_RTOL relative and b0 / b1
within B_ATOL (barycentrics lie in [0, 1], so their relative error
grows near 0)."""

import os
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from arendur_tpu.accel import bvh as jbvh
from arendur_tpu.shapes import triangle as jtri
from arendur_tpu_torch.accel import bvh as tbvh
from arendur_tpu_torch.shapes import triangle as ttri

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_bvh import random_rays, random_tris  # noqa: E402

torch.set_num_threads(2)

T_RTOL = 1e-6
B_ATOL = 1e-6
SETS = [(64, 0), (1000, 7)]       # (triangles, seed) of test_bvh.py


def _inputs(n_tris, seed, n_rays=512):
    v0, v1, v2 = random_tris(n_tris, seed=seed)
    o, d = random_rays(n_rays, seed=seed + 10)
    # a bounded tmax on a third of the rays (misses past it)
    tmax = np.full(n_rays, np.inf, np.float32)
    tmax[::3] = 6.0
    return v0, v1, v2, o, d, tmax


def _check(jres, tres):
    (jt, ji, jb0, jb1), (tt, ti, tb0, tb1) = (
        [np.asarray(x) for x in jres], [x.numpy() for x in tres])
    np.testing.assert_array_equal(ti, ji)
    hit = ji >= 0
    assert 0.0 < hit.mean() < 1.0
    np.testing.assert_allclose(tt[hit], jt[hit], rtol=T_RTOL, atol=0.0)
    np.testing.assert_allclose(tb0[hit], jb0[hit], rtol=0.0, atol=B_ATOL)
    np.testing.assert_allclose(tb1[hit], jb1[hit], rtol=0.0, atol=B_ATOL)
    # a miss keeps the ray's tmax, as the JAX scan / walk leave it
    np.testing.assert_array_equal(tt[~hit], jt[~hit])


@pytest.mark.parametrize("n_tris,seed", SETS)
def test_brute_force_matches_jax(n_tris, seed):
    v0, v1, v2, o, d, tmax = _inputs(n_tris, seed)
    J, T = jnp.asarray, torch.tensor
    jres = jtri.intersect_scene_tris(J(o), J(d), J(tmax), J(v0), J(v1),
                                     J(v2), chunk=128)
    tres = ttri.intersect_scene_tris(T(o), T(d), T(tmax), T(v0), T(v1),
                                     T(v2), chunk=128)
    _check(jres, tres)
    jocc = np.asarray(jtri.occluded_tris(J(o), J(d), J(tmax), J(v0), J(v1),
                                         J(v2), chunk=128))
    tocc = ttri.occluded_tris(T(o), T(d), T(tmax), T(v0), T(v1), T(v2),
                              chunk=128).numpy()
    np.testing.assert_array_equal(tocc, jocc)


@pytest.mark.parametrize("n_tris,seed", SETS)
def test_bvh_walk_matches_jax(n_tris, seed):
    v0, v1, v2, o, d, tmax = _inputs(n_tris, seed)
    J, T = jnp.asarray, torch.tensor
    jb = jbvh.build_bvh(v0, v1, v2)
    jres = jbvh.intersect_bvh(jb, J(v0), J(v1), J(v2), J(o), J(d), J(tmax))
    tb = tbvh.device_bvh(tbvh.build_bvh(v0, v1, v2), v0, v1, v2, "cpu")
    _check(jres, tbvh.intersect_bvh(tb, T(o), T(d), T(tmax)))


@pytest.mark.parametrize("n_tris,seed", SETS + [(1112, 3)])
def test_bvh_arrays_equal_native_build(n_tris, seed):
    """The port's NumPy build (build_bvh_plain) equals the JAX package's
    native C++ build (which its build_bvh prefers) array for array."""
    v0, v1, v2 = random_tris(n_tris, seed=seed)
    jb = jbvh.build_bvh(v0, v1, v2, native=True)
    tb = tbvh.build_bvh_plain(v0, v1, v2)
    for f in ("bmin", "bmax", "second", "start", "count", "axis", "order"):
        np.testing.assert_array_equal(getattr(tb, f), np.asarray(
            getattr(jb, f)), err_msg=f)


@pytest.mark.parametrize("check_every", [2, 5, 16])
def test_done_check_cadence_changes_no_lane(check_every):
    """Asking whether every lane is done only every k steps runs up to
    k - 1 steps past the end; those change no lane."""
    v0, v1, v2, o, d, tmax = _inputs(1000, 7)
    tb = tbvh.device_bvh(tbvh.build_bvh(v0, v1, v2), v0, v1, v2, "cpu")
    T = torch.tensor
    s1, sk = {}, {}
    ref = tbvh.intersect_bvh(tb, T(o), T(d), T(tmax), check_every=1,
                             stats=s1)
    got = tbvh.intersect_bvh(tb, T(o), T(d), T(tmax),
                             check_every=check_every, stats=sk)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert s1["steps"] <= sk["steps"] < s1["steps"] + check_every
