"""Analytic (possibly partial) spheres (port of
arendur_tpu/shapes/sphere.py; ref: src/shape/sphere.rs:193-317).

Spheres live in their local frame with baked object<->world matrices.
The tables are host-side NumPy; the intersection runs on tensors.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from arendur_tpu_torch.geometry import transform as tf
from arendur_tpu_torch.render import cmath as cm

PI = math.pi

# The reference samples spheres uniformly in (theta, phi) while
# reporting pdf = 1/area (sphere.rs:304-317), a biased area sampler.
# The golden images embed that bias (tests/test_golden.py), so the
# port keeps the reference-faithful mode, as the JAX package does by
# default.
THETA_UNIFORM_COMPAT = True


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


def refine_p_local(o, d, t, radius):
    """Local hit point refined onto the surface (sphere.rs:233-238).
    o, d [N,3]; t [N]; radius a float or [N]."""
    p = o + t[..., None] * d
    r_col = torch.broadcast_to(torch.as_tensor(radius, dtype=t.dtype,
                                               device=t.device),
                               t.shape)[..., None]
    plen = torch.sqrt((p * p).sum(-1, keepdim=True))
    p = p * (r_col / torch.clamp(plen, min=1e-20))
    degenerate = (p[..., 0] == 0.0) & (p[..., 1] == 0.0)
    px = torch.where(degenerate, 1e-5 * r_col[..., 0], p[..., 0])
    return torch.stack([px, p[..., 1], p[..., 2]], dim=-1)


def _intersect_local(o, d, tmax, radius, zmin, zmax, phimax,
                     skip_phi_clip: bool = False):
    """Rays (local frame) vs one sphere: (hit [N], t [N], p [N,3]).
    Reference quadratic (sphere.rs:193-221) then clip (rejecting, not
    retrying the far root, as sphere.rs:231-245 does)."""
    a = torch.clamp((d * d).sum(-1), min=1e-20)
    b = 2.0 * (d * o).sum(-1)
    c = (o * o).sum(-1) - radius * radius
    delta = b * b - 4.0 * a * c
    has_root = delta >= 0.0
    sq = torch.sqrt(torch.clamp(delta, min=1e-30))
    inv2a = 1.0 / (2.0 * a)
    d1 = sq * inv2a
    d0 = -b * inv2a
    t0 = d0 - d1
    t1 = d0 + d1
    t = torch.where(t0 > 0.0, t0, t1)
    ok = has_root & ~((t0 > tmax) | (t1 < 0.0)) \
        & ~((t0 <= 0.0) & (t1 > tmax))
    p = refine_p_local(o, d, t, radius)
    clipped = (p[..., 2] < zmin) | (p[..., 2] > zmax)
    if not skip_phi_clip:
        phi = cm.atan2_poly(p[..., 1], p[..., 0])
        phi = torch.where(phi < 0.0, phi + 2.0 * PI, phi)
        clipped = clipped | (phi > phimax)
    return ok & ~clipped, t, p


def intersect_spheres(spheres: "DeviceSpheres", o, d, tmax):
    """N rays vs all S spheres -> closest hit: dict(hit, t,
    sphere_idx, p_local)."""
    hits, ts, pls = [], [], []
    for s in range(spheres.count):
        w2o = spheres.w2o[s]
        ol = tf.transform_point(w2o, o)
        dl = tf.transform_vector(w2o, d)
        hit, t, pl = _intersect_local(
            ol, dl, tmax, spheres.radius[s], spheres.zmin[s],
            spheres.zmax[s], spheres.phimax[s])
        hits.append(hit)
        ts.append(t)
        pls.append(pl)
    hits = torch.stack(hits)
    t_masked = torch.where(hits, torch.stack(ts), float("inf"))
    s_idx = torch.argmin(t_masked, dim=0)
    n = o.shape[0]
    lanes = torch.arange(n, device=o.device)
    best_t = t_masked[s_idx, lanes]
    hit_any = torch.isfinite(best_t)
    p_local = torch.stack(pls)[s_idx, lanes]
    return {
        "hit": hit_any,
        "t": torch.where(hit_any, best_t, float("inf")),
        "sphere_idx": torch.where(hit_any, s_idx.to(torch.int32), -1),
        "p_local": p_local,
    }


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceSpheres:
    """The sphere fields the intersection reads, as tensors."""
    w2o: torch.Tensor      # [S,4,4]
    radius: torch.Tensor   # [S]
    zmin: torch.Tensor
    zmax: torch.Tensor
    phimax: torch.Tensor
    light_id: torch.Tensor  # [S] int64

    @property
    def count(self):
        return self.radius.shape[0]

    @staticmethod
    def from_soa(spheres: SphereSoA, device) -> "DeviceSpheres":
        t = lambda a, dt=torch.float32: torch.as_tensor(
            np.asarray(a), dtype=dt, device=device)
        return DeviceSpheres(
            w2o=t(spheres.w2o), radius=t(spheres.radius),
            zmin=t(spheres.zmin), zmax=t(spheres.zmax),
            phimax=t(spheres.phimax),
            light_id=t(spheres.light_id, torch.int64))
