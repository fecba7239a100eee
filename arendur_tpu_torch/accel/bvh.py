"""BVH: host-side binned-SAH build (port of arendur_tpu/accel/bvh.py and
arendur_tpu/native; ref: src/component/bvh.rs).

32 centroid buckets on the max-extent axis, prefix/suffix area
accumulation, leaf fallback at <= max_leaf primitives, depth-first
layout with first child at i+1 and the second-child offset stored per
interior node (bvh.rs:137-146, 219-243, 377-415).  ``build_bvh`` runs
the native C++ build (native/bvh_builder.cpp); ``build_bvh_plain`` is
its NumPy twin, which the tests hold it against.  The tree cuts the
SAH clusters (accel/clusters.py) and is the world intersector of
``--intersector bvh``.

The walk (``intersect_bvh``) is the SoA wavefront form of the
reference's explicit stack walk (bvh.rs:97-128): every ray carries its
own node cursor and a stack of STACK_DEPTH entries, and each step moves
every lane by one node (near child first by the ray's sign on the
node's split axis, the far child pushed), testing a leaf's primitives
with the watertight test of shapes/triangle.py.  The JAX package runs
it in XLA, with no Pallas kernel; here it is plain PyTorch on any
device.  Finished lanes are no-ops in a step, so the loop asks whether
every lane is done (a host sync on the card) only every few steps.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from arendur_tpu_torch import native

N_BUCKETS = 32
TRAVERSAL_COST = 0.125
STACK_DEPTH = 48


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
    """Binned-SAH build on the host by the native C++ builder
    (native/bvh_builder.cpp), array for array what build_bvh_plain
    builds.  Raises where the builder cannot be built or loaded."""
    if len(v0) == 0:
        return _empty_bvh()
    return BVH(**native.build_bvh(v0, v1, v2, max_leaf))


def _empty_bvh() -> BVH:
    """The tree of no triangle: one empty node of zero bounds."""
    z3, z1 = np.zeros((1, 3), np.float32), np.zeros(1, np.int32)
    return BVH(bmin=z3, bmax=z3.copy(), second=z1, start=z1.copy(),
               count=z1.copy(), axis=z1.copy(), order=np.zeros(0, np.int32))


def build_bvh_plain(v0, v1, v2, max_leaf: int = 4) -> BVH:
    """The NumPy build: the plain version of build_bvh, for the tests
    and the checks that hold the native build against it (never on a
    scene load).  Bit-identical to the JAX package's NumPy builder."""
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
        # [..., 3] boxes: float32 areas, each product rounded
        d = np.maximum(mx - mn, 0.0)
        return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
                      + d[..., 2] * d[..., 0])

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
        # each bucket's bounds: min / max over its run of the primitives
        # grouped by bucket
        full = np.flatnonzero(counts)
        runs = (np.cumsum(counts) - counts)[full]
        grouped = idx[np.argsort(b, kind="stable")]
        bucket_min[full] = np.minimum.reduceat(pmin[grouped], runs, 0)
        bucket_max[full] = np.maximum.reduceat(pmax[grouped], runs, 0)
        # prefix/suffix accumulation
        left_min = np.minimum.accumulate(bucket_min, 0)
        left_max = np.maximum.accumulate(bucket_max, 0)
        right_min = np.minimum.accumulate(bucket_min[::-1], 0)[::-1]
        right_max = np.maximum.accumulate(bucket_max[::-1], 0)[::-1]
        left_count = np.cumsum(counts)
        right_count = np.cumsum(counts[::-1])[::-1]
        total_area = max(surface_area(bmin, bmax), 1e-20)
        # count (int64) times area (float32) sums in float64; the cost
        # array is float32, inf where a side is empty
        split_ok = (left_count[:-1] > 0) & (right_count[1:] > 0)
        with np.errstate(over="ignore"):
            costs = np.where(split_ok, TRAVERSAL_COST + (
                left_count[:-1] * surface_area(left_min[:-1], left_max[:-1])
                + right_count[1:]
                * surface_area(right_min[1:], right_max[1:])
            ) / total_area, np.inf).astype(np.float32)
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

    if t == 0:
        return _empty_bvh()
    import sys
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        recurse(0, t)
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


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceBVH:
    """A BVH's tables on one device, packed for the walk's gathers."""
    node_f: torch.Tensor    # [M,6] bmin, bmax
    node_i: torch.Tensor    # [M,4] int64 second, start, count, axis
    order: torch.Tensor     # [T] int64 primitive permutation
    tris: torch.Tensor      # [T,9] v0 v1 v2 in BVH (leaf) order

    @property
    def n_nodes(self):
        return self.node_f.shape[0]


def device_bvh(bvh: BVH, v0, v1, v2, device) -> DeviceBVH:
    """The tables of bvh over the original-order triangles v0, v1, v2
    [T,3] on `device`."""
    order = np.asarray(bvh.order, np.int64)
    tris = np.concatenate([np.asarray(v, np.float32)[order]
                           for v in (v0, v1, v2)], 1)
    t = lambda a, dt: torch.as_tensor(  # noqa: E731
        np.ascontiguousarray(a), dtype=dt, device=device)
    return DeviceBVH(
        node_f=t(np.concatenate([bvh.bmin, bvh.bmax], 1), torch.float32),
        node_i=t(np.stack([bvh.second, bvh.start, bvh.count, bvh.axis], 1),
                 torch.int64),
        order=t(order, torch.int64), tris=t(tris.reshape(-1, 9),
                                            torch.float32))


def _slab_test(bmin, bmax, o, inv_d, tmax):
    """Cached-ray AABB test (ref: bbox.rs:549-592), conservative
    1 + 2 gamma3 scaling."""
    g3 = 3.0 * 2.0 ** -24 / (1.0 - 3.0 * 2.0 ** -24)
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    tnear = torch.minimum(t0, t1)
    tfar = torch.maximum(t0, t1) * (1.0 + 2.0 * g3)
    tn = tnear.amax(-1)
    tf = tfar.amin(-1)
    return (tn <= tf) & (tf > 0.0) & (tn < tmax)


def intersect_bvh(bvh: DeviceBVH, o, d, tmax, max_leaf: int = 4,
                  check_every: int = 8, stats: dict = None):
    """Closest hit of N rays o, d [N,3] within tmax [N] by per-ray stack
    traversal: (t [N] (tmax on a miss), tri_idx [N] int64 original
    triangle id or -1, b0, b1), as shapes/triangle.intersect_scene_tris
    returns them.  A leaf's primitives are tested in order, each bounded
    by the closest t so far, and a hit replaces the best only at a
    strictly smaller t (so coplanar ties resolve as in the JAX walk).

    check_every: steps between the tests whether every lane is done
    (the extra steps of a finished wave change no lane).  stats, if
    given, receives "steps", the steps run."""
    from arendur_tpu_torch.shapes import triangle as tri
    n, dev = o.shape[0], o.device
    tiny = torch.where(d < 0, -1e-20, 1e-20)
    inv_d = 1.0 / torch.where(d.abs() < 1e-20, tiny, d)
    perm, shear = tri.ray_shear(d)
    perm4 = perm[:, None, :].expand(n, max_leaf, 3)
    o4, shear4 = o[:, None, :], shear[:, None, :]
    last = max(bvh.tris.shape[0] - 1, 0)
    ks = torch.arange(max_leaf, device=dev)

    node = torch.zeros(n, dtype=torch.int64, device=dev)
    sp = torch.zeros(n, dtype=torch.int64, device=dev)
    stack = torch.zeros(n, STACK_DEPTH, dtype=torch.int64, device=dev)
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    best_t = tmax.to(torch.float32).clone()
    best_i = torch.full((n,), -1, dtype=torch.int64, device=dev)
    best_b0 = torch.zeros(n, device=dev)
    best_b1 = torch.zeros(n, device=dev)
    steps = 0
    while not (steps % check_every == 0 and bool(done.all())):
        steps += 1
        nf, ni = bvh.node_f[node], bvh.node_i[node]
        second, start, count, axis = ni.unbind(1)
        active = ~done
        box_hit = _slab_test(nf[:, 0:3], nf[:, 3:6], o, inv_d, best_t) \
            & active
        is_leaf = count > 0

        # leaf: its primitives, each bounded by the closest t so far
        pid = torch.clamp(start[:, None] + ks, 0, last)
        take = (box_hit & is_leaf)[:, None] & (ks < count[:, None])
        rows = bvh.tris[pid]
        pts = [tri._shear_pts(rows[..., 3 * j:3 * j + 3] - o4, perm4, shear4)
               for j in range(3)]
        accept, tsc, det, t, b0, b1 = tri._core_parts(*pts[0], *pts[1],
                                                      *pts[2])
        accept = accept & take
        prim = bvh.order[pid]
        for k in range(max_leaf):
            upd = accept[:, k] & tri._in_range(tsc[:, k], det[:, k], best_t) \
                & (t[:, k] < best_t)
            best_t = torch.where(upd, t[:, k], best_t)
            best_i = torch.where(upd, prim[:, k], best_i)
            best_b0 = torch.where(upd, b0[:, k], best_b0)
            best_b1 = torch.where(upd, b1[:, k], best_b1)

        # interior: the near child next, the far child pushed
        dir_neg = d.gather(1, axis[:, None])[:, 0] < 0.0
        near = torch.where(dir_neg, second, node + 1)
        far = torch.where(dir_neg, node + 1, second)
        descend = box_hit & ~is_leaf
        can_push = descend & (sp < STACK_DEPTH)
        top = torch.clamp(sp, 0, STACK_DEPTH - 1)[:, None]
        stack.scatter_(1, top, torch.where(can_push[:, None], far[:, None],
                                           stack.gather(1, top)))
        sp = torch.where(can_push, sp + 1, sp)
        pop_needed = active & ~descend
        can_pop = pop_needed & (sp > 0)
        sp_after = torch.where(can_pop, sp - 1, sp)
        popped = stack.gather(
            1, torch.clamp(sp_after, 0, STACK_DEPTH - 1)[:, None])[:, 0]
        node = torch.where(descend, near, torch.where(can_pop, popped, node))
        done = done | (pop_needed & (sp == 0))
        sp = sp_after
    if stats is not None:
        stats["steps"] = steps
    return best_t, best_i, best_b0, best_b1
