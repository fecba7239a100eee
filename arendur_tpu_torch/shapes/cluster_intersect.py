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

Results are detached: ray geometry carries no gradient (the JAX
package's stop_gradient at scene.py:743-744, 1078-1080).  ``n_alive``
is a device scalar (the integrator's compaction count): rays at
positions >= n_alive are misses (closest hit) or unblocked (any hit).
The in-kernel sphere test of the Pallas kernels (ARENDUR_SPHERES=kernel,
off by default) is not ported; spheres are intersected outside.
"""

from __future__ import annotations

from typing import Optional

import torch

from arendur_tpu_torch.shapes import mxu_intersect as mxi


def _live(n: int, n_alive, period: int, device) -> Optional[torch.Tensor]:
    if n_alive is None:
        return None
    i = torch.arange(n, device=device)
    if period:
        i = i % period
    return i < n_alive


def intersect_clusters_reference(w_clusters, cbox, o, d, tmax,
                                 n_alive=None, period: int = 0):
    """Plain version of the closest-hit kernel: (t [N], slot [N]
    int32), slot = cluster*K + lane, -1 = miss with t = tmax."""
    k = w_clusters.shape[-1] // 4
    o, d, tmax = o.detach(), d.detach(), tmax.detach()
    t, slot, _, _ = mxi.intersect_mxu(w_clusters, o, d, tmax,
                                      w_clusters.shape[0] * k, chunk=k)
    live = _live(o.shape[0], n_alive, period, o.device)
    if live is not None:
        slot = torch.where(live, slot, -1)
    t = torch.where(slot == -1, tmax, t)
    return t, slot


def occluded_clusters_reference(w_clusters, cbox, o, d, tmax,
                                n_alive=None, period: int = 0):
    """Plain version of the any-hit kernel: blocked [N] bool."""
    k = w_clusters.shape[-1] // 4
    blocked = mxi.occluded_mxu(w_clusters, o.detach(), d.detach(),
                               tmax.detach(), w_clusters.shape[0] * k,
                               chunk=k)
    live = _live(o.shape[0], n_alive, period, o.device)
    if live is not None:
        blocked = blocked & live
    return blocked


def intersect_clusters(w_clusters, cbox, o, d, tmax, n_alive=None,
                       period: int = 0):
    """Closest hit of N rays against the cluster tables: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if o.is_cuda:
        from arendur_tpu_torch.kernels import ops
        return ops.closest_hit(w_clusters, cbox, o.detach().contiguous(),
                               d.detach().contiguous(),
                               tmax.detach().contiguous(), n_alive, period)
    return intersect_clusters_reference(w_clusters, cbox, o, d, tmax,
                                        n_alive, period)


def occluded_clusters(w_clusters, cbox, o, d, tmax, n_alive=None,
                      period: int = 0):
    """Any hit within (teps, tmax): the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if o.is_cuda:
        from arendur_tpu_torch.kernels import ops
        return ops.any_hit(w_clusters, cbox, o.detach().contiguous(),
                           d.detach().contiguous(),
                           tmax.detach().contiguous(), n_alive, period)
    return occluded_clusters_reference(w_clusters, cbox, o, d, tmax,
                                       n_alive, period)
