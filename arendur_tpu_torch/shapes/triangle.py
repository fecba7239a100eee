"""Watertight ray-triangle intersection, wavefront-batched (port of
arendur_tpu/shapes/triangle.py; ref: src/shape/triangle.rs:397-484,
src/geometry/ray.rs:171-236).

The shearing-transform test: permute the dominant ray axis to z
(cyclic, as ray.rs's Permulation), shear so the ray is +z, then 2-D
edge functions with conservative error bounds (eb_term, ref:
src/geometry/float.rs:33).  ``intersect_scene_tris`` and
``occluded_tris`` are the brute-force path of ``--intersector naive``:
they loop over chunks of triangles, one [N, chunk] test at a time, and
keep a running closest hit per ray, so no [N, T] array is ever built.
The JAX package runs them in XLA with no Pallas kernel; here they are
plain PyTorch on any device.  The BVH walk (accel/bvh.py) tests its
leaves with the same core, so both accept the same hits.
"""

from __future__ import annotations

import torch

# Higham's u for f32 (ref: float.rs machine_epsilon)
_MACHINE_EPS = 2.0 ** -24


def eb_term(n: float) -> float:
    """gamma_n = n u / (1 - n u)  (ref: float.rs:33)."""
    nu = n * _MACHINE_EPS
    return nu / (1.0 - nu)


def ray_shear(d):
    """Per-ray shear cache: (perm [N,3] int64 gather indices, shear
    [N,3]); perm maps world components into the sheared frame (the
    dominant axis to z) by cyclic rotation."""
    ax = d.abs()
    kz = torch.where((ax[..., 0] > ax[..., 1]) & (ax[..., 0] > ax[..., 2]),
                     0, torch.where(ax[..., 1] > ax[..., 2], 1, 2))
    perm = torch.stack([(kz + 1) % 3, (kz + 2) % 3, kz], -1)
    dz = d.gather(-1, perm)
    shear = torch.stack([-dz[..., 0] / dz[..., 2], -dz[..., 1] / dz[..., 2],
                         1.0 / dz[..., 2]], -1)
    return perm, shear


def _core_parts(p0x, p0y, p0z, p1x, p1y, p1z, p2x, p2y, p2z):
    """Everything of the edge-function test that does not read tmax:
    (accept, tscaled, det, t, b0, b1).  Edge values within a relative
    epsilon of 0 count as on the edge, so a ray through a shared edge
    hits both triangles rather than falling through a crack (the JAX
    package's rule, which also covers XLA's contraction of a b - c d
    into an fma)."""
    e0 = p1x * p2y - p1y * p2x
    e1 = p2x * p0y - p2y * p0x
    e2 = p0x * p1y - p0y * p1x
    maxab = torch.maximum(
        torch.maximum((p1x * p2y).abs() + (p1y * p2x).abs(),
                      (p2x * p0y).abs() + (p2y * p0x).abs()),
        (p0x * p1y).abs() + (p0y * p1x).abs())
    eps_e = maxab * 2.0 ** -22
    same_sign = ((e0 >= -eps_e) & (e1 >= -eps_e) & (e2 >= -eps_e)) | \
                ((e0 <= eps_e) & (e1 <= eps_e) & (e2 <= eps_e))
    det = e0 + e1 + e2
    nonzero = det != 0.0
    tscaled = e0 * p0z + e1 * p1z + e2 * p2z
    inv_det = 1.0 / torch.where(nonzero, det, 1.0)
    b0 = e0 * inv_det
    b1 = e1 * inv_det
    t = tscaled * inv_det

    # conservative epsilon rejection (ref: triangle.rs:431-451)
    maxxt = torch.maximum(torch.maximum(p0x.abs(), p1x.abs()), p2x.abs())
    maxyt = torch.maximum(torch.maximum(p0y.abs(), p1y.abs()), p2y.abs())
    maxzt = torch.maximum(torch.maximum(p0z.abs(), p1z.abs()), p2z.abs())
    maxe = torch.maximum(torch.maximum(e0.abs(), e1.abs()), e2.abs())
    deltax = maxxt * eb_term(5.0)
    deltay = maxyt * eb_term(5.0)
    deltaz = maxzt * eb_term(3.0)
    delta_err = 2.0 * (eb_term(2.0) * maxxt * maxyt
                       + deltay * maxxt + deltax * maxyt)
    delta_t = 3.0 * (eb_term(3.0) * maxe * maxzt + delta_err * maxzt
                     + deltaz * maxe) * inv_det.abs()
    accept = same_sign & nonzero & (t > delta_t)
    return accept, tscaled, det, t, b0, b1


def _in_range(tscaled, det, tmax):
    """0 < t <= tmax in the scaled form (no division)."""
    return torch.where(det < 0.0, (tscaled < 0.0) & (tscaled >= tmax * det),
                       (tscaled > 0.0) & (tscaled <= tmax * det))


def _watertight_core(p0x, p0y, p0z, p1x, p1y, p1z, p2x, p2y, p2z, tmax):
    """Edge-function accept test on sheared points, any shape (the
    [N, C] batch and the BVH's lane-wise leaf test share it, so their
    accepts are identical): (hit, t, b0, b1)."""
    accept, tscaled, det, t, b0, b1 = _core_parts(p0x, p0y, p0z, p1x, p1y,
                                                  p1z, p2x, p2y, p2z)
    return accept & _in_range(tscaled, det, tmax), t, b0, b1


def _shear_pts(p, perm, shear):
    """Corners relative to the ray origin, p [..., 3], in the sheared
    frame: (px, py, pz); perm has p's shape, shear broadcasts."""
    p = p.gather(-1, perm)
    pz = p[..., 2]
    return (p[..., 0] + shear[..., 0] * pz, p[..., 1] + shear[..., 1] * pz,
            pz * shear[..., 2])


def intersect_batch(o, d, tmax, perm, shear, v0, v1, v2):
    """N rays against C triangles -> (hit, t, b0, b1), each [N, C].
    o, d [N,3]; tmax [N]; perm / shear from ray_shear; v0, v1, v2
    [C,3]."""
    pm = perm[:, None, :].expand(o.shape[0], v0.shape[0], 3)
    sh = shear[:, None, :]
    pts = [_shear_pts(v[None, :, :] - o[:, None, :], pm, sh)
           for v in (v0, v1, v2)]
    return _watertight_core(*pts[0], *pts[1], *pts[2], tmax[:, None])


def intersect_watertight_lanewise(o, d, tmax, perm, shear, v0, v1, v2):
    """Ray i against triangle i with the test of intersect_batch (the
    BVH leaf test).  o, d, v* [N,3]; tmax [N]."""
    pts = [_shear_pts(v - o, perm, shear) for v in (v0, v1, v2)]
    return _watertight_core(*pts[0], *pts[1], *pts[2], tmax)


def _chunks(v0, v1, v2, chunk: int):
    """(base id, v0, v1, v2) per chunk of at most `chunk` triangles."""
    for base in range(0, v0.shape[0], chunk):
        yield (base, v0[base:base + chunk], v1[base:base + chunk],
               v2[base:base + chunk])


def intersect_scene_tris(o, d, tmax, v0, v1, v2, chunk: int = 512):
    """Closest hit of N rays against all T triangles: (t [N], tri_idx
    [N] int64, -1 on a miss, b0, b1).  One [N, chunk] test per chunk of
    triangles, each bounded by the running closest t; within a chunk the
    first of equal t wins, and a later chunk replaces the hit only at a
    strictly smaller t (the JAX package's scan; the wavefront form of
    the reference's Naive traversal, component/naive.rs)."""
    n = o.shape[0]
    perm, shear = ray_shear(d)
    best_t = tmax.to(torch.float32).clone()
    best_i = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    best_b0 = torch.zeros(n, device=o.device)
    best_b1 = torch.zeros(n, device=o.device)
    for base, c0, c1, c2 in _chunks(v0, v1, v2, chunk):
        hit, t, b0, b1 = intersect_batch(o, d, best_t, perm, shear, c0, c1,
                                         c2)
        t_masked = torch.where(hit, t, float("inf"))
        tj, j = t_masked.min(-1)
        better = tj < best_t
        best_t = torch.where(better, tj, best_t)
        best_i = torch.where(better, base + j, best_i)
        best_b0 = torch.where(better, b0.gather(1, j[:, None])[:, 0],
                              best_b0)
        best_b1 = torch.where(better, b1.gather(1, j[:, None])[:, 0],
                              best_b1)
    return best_t, best_i, best_b0, best_b1


def occluded_tris(o, d, tmax, v0, v1, v2, chunk: int = 512):
    """Any hit for shadow rays: True where some triangle blocks the
    segment [0, tmax] (ref: LightSample::occluded, lighting/mod.rs:125)."""
    perm, shear = ray_shear(d)
    blocked = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    for _, c0, c1, c2 in _chunks(v0, v1, v2, chunk):
        hit, _, _, _ = intersect_batch(o, d, tmax, perm, shear, c0, c1, c2)
        blocked = blocked | hit.any(-1)
    return blocked
