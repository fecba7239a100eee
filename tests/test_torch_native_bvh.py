"""The port's native BVH build (arendur_tpu_torch/native/bvh_builder.cpp,
accel/bvh.py build_bvh) against its NumPy twin (build_bvh_plain) and the
JAX package's native build (arendur_tpu/native build_bvh_native), array
for array; the cluster tables built on it against the JAX package's;
the scene load's use of it; and its failures, which raise and never
fall back to the NumPy build.

Tolerance: none.  Every array (bounds, child and leaf indices, axes,
the primitive order; the cluster weights, boxes and remap) is equal."""

import os
import sys
import threading

import numpy as np
import pytest

from arendur_tpu import native as jnative
from arendur_tpu.accel import clusters as jclusters
from arendur_tpu_torch import native
from arendur_tpu_torch.accel import bvh as tbvh
from arendur_tpu_torch.accel import clusters as tclusters
from arendur_tpu_torch.io import scenedesc

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_bvh import random_tris  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("bmin", "bmax", "second", "start", "count", "axis", "order")
SIZES = [1, 3, 4, 5, 1112, 20000]
LEAVES = [1, 4, 8]


def _degenerate(kind, n=300, seed=0):
    """Meshes the SAH cannot split: every triangle the same ("same": the
    even split of identical centroids), all in the plane z = 1.5
    ("flat": a zero extent and zero-height boxes), and different
    triangles that share their box's centroid ("centred": the even split
    with boxes that differ)."""
    rng = np.random.default_rng(seed)
    if kind == "same":
        v = rng.uniform(-1, 1, (3, 3)).astype(np.float32)
        return tuple(np.repeat(v[i:i + 1], n, 0) for i in range(3))
    if kind == "flat":
        v0, v1, v2 = random_tris(n, seed=seed)
        for v in (v0, v1, v2):
            v[:, 2] = 1.5
        return v0, v1, v2
    h = rng.uniform(0.1, 1.0, (n, 3)).astype(np.float32)
    return -h, h, np.zeros_like(h)


def _equal(a, b):
    """a (a BVH) equal to b (a BVH, or the JAX native build's dict)."""
    for f in FIELDS:
        want = b[f] if isinstance(b, dict) else getattr(b, f)
        np.testing.assert_array_equal(getattr(a, f), np.asarray(want),
                                      err_msg=f)


@pytest.mark.parametrize("max_leaf", LEAVES)
@pytest.mark.parametrize("n_tris", SIZES)
def test_native_equals_plain(n_tris, max_leaf):
    v0, v1, v2 = random_tris(n_tris, seed=n_tris)
    got = tbvh.build_bvh(v0, v1, v2, max_leaf)
    _equal(got, tbvh.build_bvh_plain(v0, v1, v2, max_leaf))
    assert got.n_nodes <= 2 * n_tris - 1


@pytest.mark.parametrize("max_leaf", LEAVES)
@pytest.mark.parametrize("kind", ["same", "flat", "centred"])
def test_degenerate_equals_plain_and_jax(kind, max_leaf):
    v0, v1, v2 = _degenerate(kind)
    got = tbvh.build_bvh(v0, v1, v2, max_leaf)
    _equal(got, tbvh.build_bvh_plain(v0, v1, v2, max_leaf))
    _equal(got, jnative.build_bvh_native(v0, v1, v2, max_leaf))


@pytest.mark.parametrize("max_leaf", LEAVES)
@pytest.mark.parametrize("n_tris", [5, 1112, 20000])
def test_native_equals_jax_native(n_tris, max_leaf):
    v0, v1, v2 = random_tris(n_tris, seed=n_tris + 1)
    _equal(tbvh.build_bvh(v0, v1, v2, max_leaf),
           jnative.build_bvh_native(v0, v1, v2, max_leaf))


def test_empty_mesh():
    """No triangle: one empty node, as the NumPy build makes it (the JAX
    native build returns None there)."""
    z = np.zeros((0, 3), np.float32)
    got = tbvh.build_bvh(z, z, z)
    _equal(got, tbvh.build_bvh_plain(z, z, z))
    assert got.n_nodes == 1 and got.order.shape == (0,)


def test_build_clusters_equals_jax():
    v0, v1, v2 = random_tris(20000, seed=0)
    got = tclusters.build_clusters(v0, v1, v2)
    ref = jclusters.build_clusters(v0, v1, v2)
    assert got["w_chunks"].shape[0] > 50
    for k in ("w_chunks", "cbox", "remap", "order"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_scene_load_runs_the_native_build(monkeypatch):
    """parse_scene of cb.json builds its clusters through the native
    build: with the NumPy build made to raise, the load still succeeds,
    and the native entry ran."""
    def refuse(*a, **k):
        raise AssertionError("the NumPy BVH build ran on a scene load")
    calls = []
    entry = native.build_bvh

    def counted(*a, **k):
        calls.append(len(a[0]))
        return entry(*a, **k)
    monkeypatch.setattr(tbvh, "build_bvh_plain", refuse)
    monkeypatch.setattr(native, "build_bvh", counted)
    scene = scenedesc.parse_scene(
        os.path.join(REPO, "examples/cornellbox/cb.json"))[0]
    assert calls == [len(scene.tri_v0)] and scene.tri_cw.shape[0] >= 1


def _fresh_build(monkeypatch, tmp_path):
    """The next build compiles into tmp_path, as in a new checkout."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))


def test_missing_compiler_raises(monkeypatch, tmp_path):
    _fresh_build(monkeypatch, tmp_path)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    v0, v1, v2 = random_tris(64)
    with pytest.raises(RuntimeError, match="no host C\\+\\+ compiler"):
        tbvh.build_bvh(v0, v1, v2)
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("fault", ["compile", "load"])
def test_failed_build_raises(monkeypatch, tmp_path, fault):
    """A compile that fails raises with the compiler's stderr; a library
    that does not load raises; neither returns the NumPy build."""
    _fresh_build(monkeypatch, tmp_path)
    if fault == "compile":
        monkeypatch.setattr(native, "CXX_FLAGS",
                            native.CXX_FLAGS + ["-fno-such-bvh-flag"])
        match = ("bvh_builder.cpp: the host C\\+\\+ build failed(.|\n)*"
                 "no-such-bvh-flag")
    else:
        def no_load(path):
            raise OSError("cannot open shared object file")
        monkeypatch.setattr(native.ctypes, "CDLL", no_load)
        match = "does not load"
    v0, v1, v2 = random_tris(64)
    with pytest.raises(RuntimeError, match=match):
        tbvh.build_bvh(v0, v1, v2)
    # no partial library is left under the final name
    if fault == "compile":
        assert not os.path.exists(native.library_path())
        assert [p for p in os.listdir(tmp_path) if p.endswith(".tmp")] == []


def test_concurrent_builds_share_one_library(monkeypatch, tmp_path):
    """Builds started at once (render_multihost's workers each load the
    library) write temporary files and rename them: every caller gets
    the one library, which loads and builds."""
    _fresh_build(monkeypatch, tmp_path)
    paths, errors = [], []

    def one():
        try:
            paths.append(native.build())
        except Exception as e:  # noqa: BLE001
            errors.append(e)
    threads = [threading.Thread(target=one) for _ in range(3)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert errors == [] and len(set(paths)) == 1
    assert os.listdir(tmp_path) == [os.path.basename(paths[0])]
    v0, v1, v2 = random_tris(100)
    _equal(tbvh.build_bvh(v0, v1, v2), tbvh.build_bvh_plain(v0, v1, v2))


def test_bad_leaf_size_raises():
    v0, v1, v2 = random_tris(8)
    with pytest.raises(ValueError, match="max_leaf"):
        tbvh.build_bvh(v0, v1, v2, max_leaf=0)
