"""Analytic (possibly partial) spheres (port of
arendur_tpu/shapes/sphere.py; ref: src/shape/sphere.rs:193-317).

Spheres live in their local frame with baked object<->world matrices.
The tables are host-side NumPy; the intersection runs on tensors, in
the intersect kernels K1 / K2 (shapes/cluster_intersect.py) and in the
plain version of their sphere branch, ``sphere_best``.
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch

from arendur_tpu_torch.render import cmath as cm

PI = math.pi

# The reference samples spheres uniformly in (theta, phi) while
# reporting pdf = 1/area (sphere.rs:304-317), a biased area sampler
# (the JAX package's comment: a plane under a small sphere light
# receives 5/3 the correct radiance; tests/test_torch_sphere_area.py
# measures a point's NEE irradiance at r/d = 1/4 as 1.6039x the exact
# with the sphere's pole toward it, 0.7281x across it).
# The golden images embed that bias (tests/test_golden.py), so the
# reference-faithful mode is the default, as in the JAX package;
# ARENDUR_SPHERE_THETA=area, read once at import, selects correct
# area-uniform sampling (z uniform over [zmin, zmax]) in the plain
# samplers and in the bounce-shade kernels (their ShadeCfg's
# theta_compat word).  Readers go through this module attribute, so a
# test may set it.
THETA_UNIFORM_COMPAT = os.environ.get("ARENDUR_SPHERE_THETA",
                                      "compat") != "area"


@dataclasses.dataclass(frozen=True, eq=False)
class SphereSoA:
    """S spheres with baked transforms (NumPy leaves)."""
    o2w: np.ndarray       # [S, 4, 4]
    w2o: np.ndarray       # [S, 4, 4]
    radius: np.ndarray    # [S]
    zmin: np.ndarray      # [S]
    zmax: np.ndarray      # [S]
    thetamin: np.ndarray  # [S]
    thetamax: np.ndarray  # [S]
    phimax: np.ndarray    # [S]
    mat_id: np.ndarray    # [S] int32
    light_id: np.ndarray  # [S] int32, -1 if not emissive
    phi_full: bool = False

    @property
    def count(self):
        return self.radius.shape[0]


def shade_table(spheres: SphereSoA) -> np.ndarray:
    """[S,24] packed rows for the bounce shade's sphere branch:
    o2w(16) radius thetamin thetamax phimax mat light pad(2)."""
    o2w = np.asarray(spheres.o2w, np.float32).reshape(-1, 16)
    return np.concatenate([
        o2w,
        np.asarray(spheres.radius, np.float32)[:, None],
        np.asarray(spheres.thetamin, np.float32)[:, None],
        np.asarray(spheres.thetamax, np.float32)[:, None],
        np.asarray(spheres.phimax, np.float32)[:, None],
        np.asarray(spheres.mat_id).astype(np.float32)[:, None],
        np.asarray(spheres.light_id).astype(np.float32)[:, None],
        np.zeros((o2w.shape[0], 2), np.float32)], axis=1)


def make_sphere_params(radius, zmin, zmax, phimax):
    """Clamp + derived angles (ref: sphere.rs:133-156)."""
    radius = float(radius)
    zmin = max(float(zmin), -radius)
    zmax = min(float(zmax), radius)
    phimax = min(max(float(phimax), 0.0), 2.0 * np.pi)
    thetamin = float(np.arccos(np.clip(zmin / radius, -1, 1)))
    thetamax = float(np.arccos(np.clip(zmax / radius, -1, 1)))
    return radius, zmin, zmax, thetamin, thetamax, phimax


def kernel_table(spheres: SphereSoA) -> np.ndarray:
    """[S,24] packed rows for the intersect kernels K1 / K2 (twin:
    sphere.kernel_table): w2o(16) radius zmin zmax phimax pad(4)."""
    w2o = np.asarray(spheres.w2o, np.float32).reshape(-1, 16)
    return np.concatenate([
        w2o,
        np.asarray(spheres.radius, np.float32)[:, None],
        np.asarray(spheres.zmin, np.float32)[:, None],
        np.asarray(spheres.zmax, np.float32)[:, None],
        np.asarray(spheres.phimax, np.float32)[:, None],
        np.zeros((w2o.shape[0], 4), np.float32)], axis=1)


# Local-frame sphere math over component tuples (x, y, z) of [N]
# tensors, in the operation order of the kernels' intersect_local_sphere
# (kernels/cbounce_body.cuh), which K1 / K2 and the bounce shade run.

def _sqrt(x):
    """Correctly rounded square root.  PyTorch's CPU kernel can miss it
    by an ulp (a vectorised approximation), and on a ray started on a
    sphere that ulp decides hit or miss; CUDA's sqrt and the kernels'
    sqrtf round correctly.  On the CPU the root goes through float64
    (exact for an f32 argument)."""
    if x.is_cuda:
        return torch.sqrt(x)
    return torch.sqrt(x.double()).to(x.dtype)


def refine_p_local(o, d, t, radius):
    """Local hit point refined onto the surface (sphere.rs:233-238)."""
    p = cm.vadd(o, cm.vscale(d, t))
    plen = _sqrt(cm._max(cm.vlength2(p), 0.0))
    p = cm.vscale(p, radius / cm._max(plen, 1e-20))
    degenerate = (p[0] == 0.0) & (p[1] == 0.0)
    px = cm.W(degenerate, 1e-5 * radius, p[0])
    return (px, p[1], p[2])


def intersect_local(o, d, tmax, radius, zmin, zmax, phimax,
                    skip_phi_clip: bool = False):
    """Rays (local frame) vs one sphere: (hit, t, p_local).  Reference
    quadratic (sphere.rs:193-221) then clip (rejecting, not retrying the
    far root, as sphere.rs:231-245 does); skip_phi_clip drops the phi
    test, valid for full-phi spheres."""
    a = cm._max(cm.vdot(d, d), 1e-20)
    b = 2.0 * cm.vdot(d, o)
    c = cm.vdot(o, o) - radius * radius
    delta = b * b - 4.0 * a * c
    has_root = delta >= 0.0
    sq = _sqrt(cm._max(delta, 1e-30))
    inv2a = 1.0 / (2.0 * a)
    d1 = sq * inv2a
    d0 = -b * inv2a
    t0 = d0 - d1
    t1 = d0 + d1
    t = cm.W(t0 > 0.0, t0, t1)
    ok = has_root & ~((t0 > tmax) | (t1 < 0.0)) \
        & ~((t0 <= 0.0) & (t1 > tmax))
    p = refine_p_local(o, d, t, radius)
    clipped = (p[2] < zmin) | (p[2] > zmax)
    if not skip_phi_clip:
        phi = cm.atan2_poly(p[1], p[0])
        phi = cm.W(phi < 0.0, phi + 2.0 * PI, phi)
        clipped = clipped | (phi > phimax)
    return ok & ~clipped, t, p


# spheres one step of the plain sphere test takes, as [N, SPHERE_CHUNK]
# tensors (a loop over single spheres launched ~60 ops a sphere: ~4 s a
# query at 2,502 spheres on an H100)
SPHERE_CHUNK = 64


def sphere_best(ktab, o, d, tmax, full_phi: bool = False):
    """Closest sphere hit of N world rays against the kernel-table rows
    ktab [S,24] (twin: pallas_intersect._sphere_best, the plain version
    of K1 / K2's sphere branch): (best t [N], code [N] int32), code
    -(2+s) for a hit on sphere s, -1 for none, best = tmax there.  The
    ray goes to each sphere's frame with the point multiplied by 1 / w
    (not divided, unlike geometry.transform.transform_point).  The
    spheres are taken SPHERE_CHUNK at a time as [N, chunk] tensors,
    each element through the same operations as one sphere's test; the
    chunks in ascending order with a strict t < best, and in a chunk
    the least t at its lowest index: the first sphere in ascending
    order wins a tie, as the one-sphere-at-a-time loop of the
    kernels."""
    oc = tuple(x[:, None] for x in o.unbind(-1))
    dc = tuple(x[:, None] for x in d.unbind(-1))
    best = tmax
    code = torch.full(tmax.shape, -1, dtype=torch.int32, device=o.device)
    slots = torch.arange(SPHERE_CHUNK, device=o.device)
    for s0 in range(0, ktab.shape[0], SPHERE_CHUNK):
        m = tuple(c[None] for c in ktab[s0:s0 + SPHERE_CHUNK].unbind(-1))
        hit, t, _ = intersect_local(cm.tp16(m, oc), cm.tv16(m, dc),
                                    tmax[:, None], m[16], m[17], m[18],
                                    m[19], skip_phi_clip=full_phi)
        t = torch.where(hit & (t < best[:, None]), t, float("inf"))
        t_min = t.amin(1)
        first = torch.where(t == t_min[:, None], slots[:t.shape[1]],
                            SPHERE_CHUNK).amin(1)
        better = t_min < best
        best = torch.where(better, t_min, best)
        code = torch.where(better, (-2 - s0 - first).to(torch.int32), code)
    return best, code


def hit_p_local(ktab, code, o, d, t):
    """The local hit point of rays o, d [N,3] at t [N] on the sphere each
    code [N] names (-(2+s); other lanes read sphere 0 at t = 0), rebuilt
    by the refinement the kernels' accept ran (twin: the p_local of
    scene.intersect / intersect_raw under ARENDUR_SPHERES=kernel):
    (p_local [N,3], s_idx [N] int64)."""
    sph_hit = code <= -2
    s_idx = torch.clamp(-2 - code.long(), min=0)
    row = ktab[s_idx].unbind(-1)
    ol, dl = cm.tp16(row, o.unbind(-1)), cm.tv16(row, d.unbind(-1))
    p = refine_p_local(ol, dl, torch.where(sph_hit, t, 0.0), row[16])
    return torch.stack(p, -1), s_idx
