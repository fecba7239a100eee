"""BVH: host-side binned-SAH build (port of the NumPy builder of
arendur_tpu/accel/bvh.py; ref: src/component/bvh.rs).

32 centroid buckets on the max-extent axis, prefix/suffix area
accumulation, leaf fallback at <= max_leaf primitives, depth-first
layout with first child at i+1 and the second-child offset stored per
interior node (bvh.rs:137-146, 219-243, 377-415).  The port uses the
tree only to cut the SAH clusters (accel/clusters.py); the per-ray
stack walk is not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np

N_BUCKETS = 32
TRAVERSAL_COST = 0.125


@dataclasses.dataclass(frozen=True, eq=False)
class BVH:
    bmin: np.ndarray    # [M,3]
    bmax: np.ndarray    # [M,3]
    second: np.ndarray  # [M] int32: interior -> index of second child
    start: np.ndarray   # [M] int32: leaf -> offset into order
    count: np.ndarray   # [M] int32: leaf -> #prims (0 for interior)
    axis: np.ndarray    # [M] int32 split axis
    order: np.ndarray   # [T] int32 primitive permutation

    @property
    def n_nodes(self):
        return self.bmin.shape[0]


def build_bvh(v0, v1, v2, max_leaf: int = 4) -> BVH:
    """Binned-SAH build on the host (the NumPy builder, bit-identical
    to the JAX package's native C++ one)."""
    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    t = len(v0)
    pmin = np.minimum(np.minimum(v0, v1), v2)
    pmax = np.maximum(np.maximum(v0, v1), v2)
    centroid = 0.5 * (pmin + pmax)

    order = np.arange(t, dtype=np.int32)
    nodes = []  # dicts; 'second' patched after recursion

    def leaf_node(lo, hi):
        nodes.append(dict(
            bmin=pmin[order[lo:hi]].min(0), bmax=pmax[order[lo:hi]].max(0),
            second=0, start=lo, count=hi - lo, axis=0))

    def surface_area(mn, mx):
        d = np.maximum(mx - mn, 0.0)
        return 2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])

    def recurse(lo, hi):
        idx = order[lo:hi]
        node_id = len(nodes)
        bmin = pmin[idx].min(0)
        bmax = pmax[idx].max(0)
        n = hi - lo
        if n <= max_leaf:
            leaf_node(lo, hi)
            return node_id
        cmin = centroid[idx].min(0)
        cmax = centroid[idx].max(0)
        extent = cmax - cmin
        axis = int(np.argmax(extent))
        if extent[axis] < 1e-12:
            # identical centroids: arbitrary even split keeps leaves
            # within max_leaf
            mid = (lo + hi) // 2
            nodes.append(dict(bmin=bmin, bmax=bmax, second=0, start=0,
                              count=0, axis=axis))
            recurse(lo, mid)
            second_id = recurse(mid, hi)
            nodes[node_id]["second"] = second_id
            return node_id
        # SAH buckets (ref: bvh.rs:377-415)
        scale = N_BUCKETS / extent[axis]
        b = np.minimum(
            ((centroid[idx, axis] - cmin[axis]) * scale).astype(np.int64),
            N_BUCKETS - 1)
        counts = np.bincount(b, minlength=N_BUCKETS)
        bucket_min = np.full((N_BUCKETS, 3), np.inf, np.float32)
        bucket_max = np.full((N_BUCKETS, 3), -np.inf, np.float32)
        for k in range(N_BUCKETS):
            sel = b == k
            if sel.any():
                bucket_min[k] = pmin[idx[sel]].min(0)
                bucket_max[k] = pmax[idx[sel]].max(0)
        # prefix/suffix accumulation
        costs = np.full(N_BUCKETS - 1, np.inf, np.float32)
        left_min = np.minimum.accumulate(bucket_min, 0)
        left_max = np.maximum.accumulate(bucket_max, 0)
        right_min = np.minimum.accumulate(bucket_min[::-1], 0)[::-1]
        right_max = np.maximum.accumulate(bucket_max[::-1], 0)[::-1]
        left_count = np.cumsum(counts)
        right_count = np.cumsum(counts[::-1])[::-1]
        total_area = max(surface_area(bmin, bmax), 1e-20)
        for k in range(N_BUCKETS - 1):
            if left_count[k] == 0 or right_count[k + 1] == 0:
                continue
            costs[k] = TRAVERSAL_COST + (
                left_count[k] * surface_area(left_min[k], left_max[k])
                + right_count[k + 1]
                * surface_area(right_min[k + 1], right_max[k + 1])
            ) / total_area
        best = int(np.argmin(costs))
        if not np.isfinite(costs[best]):
            # all prims fell into one bucket: even split
            mid = (lo + hi) // 2
            nodes.append(dict(bmin=bmin, bmax=bmax, second=0, start=0,
                              count=0, axis=axis))
            recurse(lo, mid)
            second_id = recurse(mid, hi)
            nodes[node_id]["second"] = second_id
            return node_id
        sel_left = b <= best
        left_ids = idx[sel_left]
        right_ids = idx[~sel_left]
        order[lo:lo + len(left_ids)] = left_ids
        order[lo + len(left_ids):hi] = right_ids
        mid = lo + len(left_ids)
        nodes.append(dict(bmin=bmin, bmax=bmax, second=0, start=0,
                          count=0, axis=axis))
        recurse(lo, mid)
        second_id = recurse(mid, hi)
        nodes[node_id]["second"] = second_id
        return node_id

    import sys
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        if t > 0:
            recurse(0, t)
        else:
            nodes.append(dict(bmin=np.zeros(3, np.float32),
                              bmax=np.zeros(3, np.float32), second=0,
                              start=0, count=0, axis=0))
    finally:
        sys.setrecursionlimit(old_limit)

    return BVH(
        bmin=np.stack([n["bmin"] for n in nodes]),
        bmax=np.stack([n["bmax"] for n in nodes]),
        second=np.asarray([n["second"] for n in nodes], np.int32),
        start=np.asarray([n["start"] for n in nodes], np.int32),
        count=np.asarray([n["count"] for n in nodes], np.int32),
        axis=np.asarray([n["axis"] for n in nodes], np.int32),
        order=order)
