"""Cluster closest-hit and shadow any-hit (port of
arendur_tpu/shapes/pallas_intersect.py).

``intersect_clusters`` / ``occluded_clusters`` take the JAX entry
points' arguments and dispatch on the rays' device: CUDA tensors
launch the hand-written kernels (kernels/intersect.cu, replacing the
Pallas kernels ``_closest_kernel`` and ``_anyhit_kernel``), CPU tensors
run the plain PyTorch versions ``intersect_clusters_reference`` /
``occluded_clusters_reference`` (the determinant products of
shapes/mxu_intersect.py over every cluster, without culling: the
kernels' slab cull is conservative and changes no result).

With a sphere table ``sph_tab`` [S,24] (``sphere.kernel_table`` rows)
the analytic spheres are tested in the same call, as the Pallas kernels
do under ARENDUR_SPHERES=kernel (their ``_sphere_best`` branch): a
sphere hit seeds the closest hit's best t with the code -(2+s) and the
triangles replace it only when strictly closer (the sphere wins ties);
for the any hit a sphere hit blocks the ray.  ``full_phi`` skips the
phi clip (every sphere full, ``SphereSoA.phi_full``).  A table of any
size is taken: the kernels stage it into shared memory and test it in
consecutive chunks of at most 512 rows, a block's shared memory the
same whatever S (kernels/intersect.cu SPH_CHUNK), as the Pallas
kernels' ``_sphere_best`` unrolls over any count.  A sphere table with batched instancing (``period > 0``) is
refused.  Cluster tables of
no cluster (C = 0: a scene whose world pool is empty) leave the spheres
alone to test.

``intersect_instanced`` / ``occluded_instanced`` are the instanced
entries: N world rays against one instanced mesh's cluster tables and
its instance table ``itab`` [I, 20] (``scene.instance_table``: each
instance's w2o rows and padded world box).  They return one result per
world ray, the nearest instance's (t, local slot, instance) or the any
hit ORed over the instances and the world's ``blocked``, and write no
[I * N] array: CUDA tensors launch kernels/intersect.cu's instanced
kernels, CPU tensors run ``intersect_instanced_reference`` /
``occluded_instanced_reference`` (the plain K1 / K2 on each instance's
N local rays in turn, without culling).

Results are detached: ray geometry carries no gradient (the JAX
package's stop_gradient at scene.py:743-744, 1078-1080).  ``n_alive``
is a device scalar (the integrator's compaction count): rays at
positions >= n_alive are misses (closest hit) or unblocked (any hit),
and test no sphere either (the Pallas kernels run ``_sphere_best``
before their ``n_alive`` test and can report a sphere code there;
nothing downstream reads a dead lane).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from arendur_tpu_torch.shapes import mxu_intersect as mxi
from arendur_tpu_torch.shapes import sphere as sph


# rows of one determinant product in the plain versions: a larger query
# (an instanced mesh's [I * N] lanes) runs in blocks of this many rays,
# so that the [rows, 4K] products stay small; every ray's result is its
# own row's
ROW_BLOCK = 1 << 16


def _blocked(fn, o, d, tmax):
    """fn(o, d, tmax) over row blocks of ROW_BLOCK rays, concatenated."""
    if o.shape[0] <= ROW_BLOCK:
        return fn(o, d, tmax)
    parts = [fn(o[i:i + ROW_BLOCK], d[i:i + ROW_BLOCK],
                tmax[i:i + ROW_BLOCK])
             for i in range(0, o.shape[0], ROW_BLOCK)]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(p) for p in zip(*parts))
    return torch.cat(parts)


def _live(n: int, n_alive, period: int, device) -> Optional[torch.Tensor]:
    if n_alive is None:
        return None
    i = torch.arange(n, device=device)
    if period:
        i = i % period
    return i < n_alive


def _no_instanced_spheres(sph_tab, period: int):
    if sph_tab is not None and sph_tab.shape[0] and period:
        raise ValueError("a sphere table with batched instancing "
                         "(period > 0) is not supported")


def intersect_clusters_reference(w_clusters, cbox, o, d, tmax,
                                 n_alive=None, period: int = 0,
                                 sph_tab=None, full_phi: bool = False):
    """Plain version of the closest-hit kernel: (t [N], slot [N]
    int32), slot = cluster*K + lane, -(2+s) = sphere s, -1 = miss with
    t = tmax."""
    _no_instanced_spheres(sph_tab, period)
    k = w_clusters.shape[-1] // 4
    o, d, tmax = o.detach(), d.detach(), tmax.detach()
    t, slot = _blocked(lambda o_, d_, t_: mxi.intersect_mxu(
        w_clusters, o_, d_, t_, w_clusters.shape[0] * k, chunk=k)[:2],
        o, d, tmax)
    if sph_tab is not None:
        t_s, code = sph.sphere_best(sph_tab, o, d, tmax, full_phi)
        tri = (slot >= 0) & (t < t_s)
        t = torch.where(tri, t, t_s)
        slot = torch.where(tri, slot, code)
    live = _live(o.shape[0], n_alive, period, o.device)
    if live is not None:
        slot = torch.where(live, slot, -1)
    t = torch.where(slot == -1, tmax, t)
    return t, slot


def occluded_clusters_reference(w_clusters, cbox, o, d, tmax,
                                n_alive=None, period: int = 0,
                                sph_tab=None, full_phi: bool = False):
    """Plain version of the any-hit kernel: blocked [N] bool."""
    _no_instanced_spheres(sph_tab, period)
    k = w_clusters.shape[-1] // 4
    o, d, tmax = o.detach(), d.detach(), tmax.detach()
    blocked = _blocked(lambda o_, d_, t_: mxi.occluded_mxu(
        w_clusters, o_, d_, t_, w_clusters.shape[0] * k, chunk=k), o, d, tmax)
    if sph_tab is not None:
        blocked = blocked | (sph.sphere_best(sph_tab, o, d, tmax,
                                             full_phi)[1] != -1)
    live = _live(o.shape[0], n_alive, period, o.device)
    if live is not None:
        blocked = blocked & live
    return blocked


def intersect_clusters(w_clusters, cbox, o, d, tmax, n_alive=None,
                       period: int = 0, sph_tab=None, full_phi: bool = False):
    """Closest hit of N rays against the cluster tables and the spheres
    of sph_tab: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if o.is_cuda:
        from arendur_tpu_torch.kernels import ops
        return ops.closest_hit(w_clusters, cbox, o.detach().contiguous(),
                               d.detach().contiguous(),
                               tmax.detach().contiguous(), n_alive, period,
                               sph_tab, full_phi)
    return intersect_clusters_reference(w_clusters, cbox, o, d, tmax,
                                        n_alive, period, sph_tab, full_phi)


def occluded_clusters(w_clusters, cbox, o, d, tmax, n_alive=None,
                      period: int = 0, sph_tab=None, full_phi: bool = False):
    """Any hit within (teps, tmax), the spheres of sph_tab included: the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if o.is_cuda:
        from arendur_tpu_torch.kernels import ops
        return ops.any_hit(w_clusters, cbox, o.detach().contiguous(),
                           d.detach().contiguous(),
                           tmax.detach().contiguous(), n_alive, period,
                           sph_tab, full_phi)
    return occluded_clusters_reference(w_clusters, cbox, o, d, tmax,
                                       n_alive, period, sph_tab, full_phi)


# ---------------------------------------------------------------------------
# the instanced entries: N world rays against one instanced mesh
# ---------------------------------------------------------------------------

ITAB_COLS = 20   # an instance table row (kernels/intersect.cuh ITAB_COLS)
ITAB_BOX = 12    # its padded world box: min xyz, max xyz
SLAB_WIDEN = float(np.float32(1.0 + 2.0 * (3.0 * 2.0 ** -24
                                           / (1.0 - 3.0 * 2.0 ** -24))))


def instance_frame(itab_row, o, d):
    """World rays o, d [..., 3] in one instance's frame (itab_row [...,
    20], broadcast against them): x m[k] + y m[3+k] + z m[6+k] (+ m[9+k]
    for the origin), scene.affine's order; the kernels round each
    product and sum alike, so the local rays are equal to the bit."""
    m = itab_row
    x, y, z = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    ol = torch.stack([x * m[..., k] + y * m[..., 3 + k] + z * m[..., 6 + k]
                      + m[..., 9 + k] for k in range(3)], -1)
    dl = torch.stack([dx * m[..., k] + dy * m[..., 3 + k]
                      + dz * m[..., 6 + k] for k in range(3)], -1)
    return ol, dl


def slab_test(box, o, d, bound):
    """Whether the ray segments o + t d [N, 3] meet the boxes box [...,
    6] (min xyz, max xyz; broadcast against the rays) within (0, bound):
    the kernels' slab test (intersect.cuh slab_hit), op for op."""
    inv = torch.where(d.abs() < 1e-30,
                      torch.where(d < 0, -1e30, 1e30), 1.0 / d)
    tn = tf = None
    for ax in range(3):
        t0 = (box[..., ax] - o[..., ax]) * inv[..., ax]
        t1 = (box[..., 3 + ax] - o[..., ax]) * inv[..., ax]
        lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
        tn = lo if tn is None else torch.maximum(tn, lo)
        tf = hi if tf is None else torch.minimum(tf, hi)
    tf = tf * SLAB_WIDEN
    return (tn <= tf) & (tf > 0.0) & (tn < bound)


def instance_box_mask(itab, o, d, bound):
    """[I, N]: whether ray n enters instance i's padded world box before
    bound[n] (the instanced kernels' whole-instance cull, here against
    the fixed bound rather than the running one)."""
    return slab_test(itab[:, None, ITAB_BOX:ITAB_BOX + 6], o[None],
                     d[None], bound[None])


def intersect_instanced_reference(w_clusters, cbox, itab, o, d, bound,
                                  n_alive=None):
    """Plain version of the instanced closest hit: (t [N], the bound on
    a miss; local slot [N] int32, -1 on a miss; instance [N] int32, 0
    on a miss).  Each instance's N local rays go through the plain K1
    bounded by `bound`; the least t wins, the lowest instance at equal
    t (torch.argmin's rule over the [I, N] results)."""
    o, d, bound = o.detach(), d.detach(), bound.detach()
    t = bound.clone()
    slot = torch.full_like(bound, -1, dtype=torch.int32)
    inst = torch.zeros_like(slot)
    for i in range(itab.shape[0]):
        ol, dl = instance_frame(itab[i], o, d)
        t_i, s_i = intersect_clusters_reference(w_clusters, cbox, ol, dl,
                                                bound, n_alive)
        better = (s_i >= 0) & (t_i < t)
        t = torch.where(better, t_i, t)
        slot = torch.where(better, s_i, slot)
        inst = torch.where(better, i, inst)
    return t, slot, inst


def occluded_instanced_reference(w_clusters, cbox, itab, o, d, tmax,
                                 n_alive=None, blocked=None):
    """Plain version of the instanced any hit: blocked [N] bool, the
    plain K2 over each instance's N local rays ORed together and with
    the world's `blocked` [N]; rays past n_alive are not blocked."""
    o, d, tmax = o.detach(), d.detach(), tmax.detach()
    out = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device) \
        if blocked is None else blocked.clone()
    for i in range(itab.shape[0]):
        ol, dl = instance_frame(itab[i], o, d)
        out = out | occluded_clusters_reference(w_clusters, cbox, ol, dl,
                                                tmax, n_alive)
    live = _live(o.shape[0], n_alive, 0, o.device)
    return out if live is None else out & live


def intersect_instanced(w_clusters, cbox, itab, o, d, bound, n_alive=None):
    """The nearest instanced hit of N world rays within `bound`: (t,
    local slot, instance), one per ray; the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if o.is_cuda:
        from arendur_tpu_torch.kernels import ops
        return ops.closest_hit_instanced(
            w_clusters, cbox, itab, o.detach().contiguous(),
            d.detach().contiguous(), bound.detach().contiguous(), n_alive)
    return intersect_instanced_reference(w_clusters, cbox, itab, o, d,
                                         bound, n_alive)


def occluded_instanced(w_clusters, cbox, itab, o, d, tmax, n_alive=None,
                       blocked=None):
    """Any instanced hit within tmax, ORed with the world's `blocked`;
    the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if o.is_cuda:
        from arendur_tpu_torch.kernels import ops
        return ops.any_hit_instanced(
            w_clusters, cbox, itab, o.detach().contiguous(),
            d.detach().contiguous(), tmax.detach().contiguous(), n_alive,
            blocked)
    return occluded_instanced_reference(w_clusters, cbox, itab, o, d, tmax,
                                        n_alive, blocked)
