"""Two-level acceleration for the cluster intersector: SAH-subtree
clusters (port of arendur_tpu/accel/clusters.py; ref: the reference's
BVH, src/component/bvh.rs:51-146).

The reference traverses a deep BVH with a per-ray stack — hostile to
the vector units.  Here the SAH tree is *cut* into clusters of at most
K triangles (contiguous ranges of the SAH order, so each cluster is a
tight subtree bbox), and the device test becomes:

    for each (ray-tile, cluster): slab-test the rays against the
    cluster AABB; only where a ray survives, evaluate the 16-feature
    determinant products of the cluster's K triangles
    (mxu_intersect.py math).

The packed weights use the exact chunked layout of
mxu_intersect.pack_chunks, so the plain PyTorch version runs on the
same data with no culling; the CUDA kernel
(shapes/cluster_intersect.py) adds the skip.

Clusters smaller than K are padded with zero columns (det == 0 is
rejected by the epsilon test, so padding needs no id masking); the
remap array maps reordered slots back to original triangle ids.
"""

from __future__ import annotations

import numpy as np

from arendur_tpu_torch.accel import bvh as bvhmod
from arendur_tpu_torch.shapes import mxu_intersect as mxi

DEFAULT_K = 256


def _subtree_ranges(bvh):
    """[M, 2] (lo, hi) leaf-order range per node, via reverse-DFS
    (children appear after parents in the flattened layout)."""
    m = bvh.second.shape[0]
    count = np.asarray(bvh.count)
    start = np.asarray(bvh.start)
    second = np.asarray(bvh.second)
    lo = np.zeros(m, np.int64)
    hi = np.zeros(m, np.int64)
    for i in range(m - 1, -1, -1):
        if count[i] > 0:
            lo[i] = start[i]
            hi[i] = start[i] + count[i]
        else:
            lo[i] = lo[i + 1]
            hi[i] = hi[second[i]]
    return lo, hi


def build_clusters(v0, v1, v2, K: int = DEFAULT_K, max_leaf: int = 4):
    """Returns dict(w_chunks [C,16,4K], cbox [C,8], remap [C*K] int32,
    order [T] int32) — the cluster-packed intersector tables."""
    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    t = len(v0)
    bvh = bvhmod.build_bvh(v0, v1, v2, max_leaf=max_leaf)
    order = np.asarray(bvh.order)
    lo_n, hi_n = _subtree_ranges(bvh)
    count = np.asarray(bvh.count)
    second = np.asarray(bvh.second)

    # cut the tree at subtrees of <= K prims (iterative DFS)
    cuts = []
    stack = [0]
    while stack:
        i = stack.pop()
        if hi_n[i] - lo_n[i] <= K or count[i] > 0:
            cuts.append((int(lo_n[i]), int(hi_n[i])))
        else:
            stack.append(int(second[i]))
            stack.append(i + 1)
    cuts.sort()
    # greedy-merge adjacent small cuts (ranges are contiguous in order)
    merged = []
    for lo, hi in cuts:
        if merged and hi - merged[-1][0] <= K:
            merged[-1] = (merged[-1][0], hi)
        else:
            merged.append((lo, hi))

    c = len(merged)
    v0o, v1o, v2o = v0[order], v1[order], v2[order]
    w = np.zeros((c, 16, 4 * K), np.float32)
    cbox = np.zeros((c, 8), np.float32)
    remap = np.full(c * K, -1, np.int32)
    for ci, (lo, hi) in enumerate(merged):
        n = hi - lo
        wc = mxi.build_tri_matrix(v0o[lo:hi], v1o[lo:hi], v2o[lo:hi])
        # blocked per-quantity layout (cols [0:K]=det, ... pack_chunks)
        w4 = np.zeros((16, K, 4), np.float32)
        w4[:, :n, :] = wc.reshape(16, n, 4)
        w[ci] = np.ascontiguousarray(
            w4.transpose(0, 2, 1).reshape(16, 4 * K))
        pts = np.concatenate([v0o[lo:hi], v1o[lo:hi], v2o[lo:hi]], 0)
        cbox[ci, 0:3] = pts.min(0)
        cbox[ci, 3:6] = pts.max(0)
        remap[ci * K:ci * K + n] = order[lo:hi]
    return dict(w_chunks=w, cbox=cbox, remap=remap,
                order=order.astype(np.int32))
