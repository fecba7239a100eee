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
phi clip (every sphere full, ``SphereSoA.phi_full``).  A sphere table
with batched instancing (``period > 0``) is refused.  Cluster tables of
no cluster (C = 0: a scene whose world pool is empty) leave the spheres
alone to test.

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
