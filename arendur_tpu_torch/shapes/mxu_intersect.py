"""Determinant-product ray-triangle intersection (port of
arendur_tpu/shapes/mxu_intersect.py).

For a triangle (v0, e1=v1-v0, e2=v2-v0) and a ray (o, d), the four
Moller determinants det, t*det, u*det and v*det are linear in the
16-feature ray vector F = [o(3), d(3), vec(o (x) d)(9), 1], so N rays
against T triangles is one [N,16] @ [16, 4T] product followed by a
masked min-reduction.  The weight matrix is built once on the host.

``intersect_mxu`` / ``occluded_mxu`` here are the plain PyTorch
versions the hand-written cluster kernels (shapes/cluster_intersect.py)
are held against.
"""

from __future__ import annotations

import numpy as np
import torch

DEFAULT_CHUNK = 2048


def build_tri_matrix(v0, v1, v2) -> np.ndarray:
    """W [16, 4T], interleaved (det, tdet, udet, vdet) per triangle.
    Feature layout: F = [o0,o1,o2, d0,d1,d2, o0d0,o0d1,o0d2, o1d0,...,
    o2d2, 1]."""
    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    t = len(v0)
    e1 = v1 - v0
    e2 = v2 - v0
    n = np.cross(e1, e2)
    w = np.zeros((16, 4 * t), np.float32)

    def eps_mat(e):
        """x . (y x e) = eps_{ijk} x_i y_j e_k as x_i y_j coefficients."""
        m = np.zeros((t, 3, 3), np.float32)
        for (i, j, k, s) in ((0, 1, 2, 1), (1, 2, 0, 1), (2, 0, 1, 1),
                             (0, 2, 1, -1), (2, 1, 0, -1), (1, 0, 2, -1)):
            m[:, i, j] += s * e[:, k]
        return m

    # det = -d . n
    w[3:6, 0::4] = -n.T
    # tdet = o . n - v0 . n
    w[0:3, 1::4] = n.T
    w[15, 1::4] = -np.sum(v0 * n, -1)
    # udet = eps(o, d; e2) - d . (e2 x v0)
    m_u = eps_mat(e2)
    w[6:15, 2::4] = m_u.reshape(t, 9).T
    w[3:6, 2::4] = -np.cross(e2, v0).T
    # vdet = eps(d, o; e1) - d . (v0 x e1)
    m_v = np.transpose(eps_mat(e1), (0, 2, 1))
    w[6:15, 3::4] = m_v.reshape(t, 9).T
    w[3:6, 3::4] = np.cross(e1, v0).T
    return w


def pack_chunks(v0, v1, v2, chunk: int = DEFAULT_CHUNK) -> np.ndarray:
    """Blocked per-chunk weights [n_chunks, 16, 4*chunk]: cols
    [0:C]=det, [C:2C]=tdet, [2C:3C]=udet, [3C:4C]=vdet."""
    t = len(v0)
    w = build_tri_matrix(v0, v1, v2)
    pad_t = (-t) % chunk
    if pad_t:
        w = np.concatenate(
            [w, np.zeros((16, 4 * pad_t), np.float32)], axis=1)
    n_chunks = (t + pad_t) // chunk
    w = w.reshape(16, n_chunks, chunk, 4).transpose(1, 0, 3, 2)
    return np.ascontiguousarray(w.reshape(n_chunks, 16, 4 * chunk))


def ray_features(o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """[N,16] feature vector per ray."""
    outer = (o[:, :, None] * d[:, None, :]).reshape(-1, 9)
    ones = torch.ones(o.shape[0], 1, dtype=o.dtype, device=o.device)
    return torch.cat([o, d, outer, ones], dim=-1)


def ray_teps(o: torch.Tensor) -> torch.Tensor:
    """Per-ray self-hit guard epsilon scaled with |o| (scale-robust
    form of the reference's conservative bound, triangle.rs:431-451)."""
    return 1e-5 * (1.0 + torch.abs(o).amax(dim=-1))


def _accept(det, tdet, udet, vdet, tmax, teps):
    """Masked accept + t from the four determinants, tested in
    determinant space (the cluster kernels' exact op sequence)."""
    s = torch.where(det >= 0.0, 1.0, -1.0)
    a = det * s
    ok = a > 1e-12
    us = udet * s
    vs = vdet * s
    ta = a * 1e-6
    okb = (us >= -ta) & (vs >= -ta) & (us + vs <= a + ta)
    inv = 1.0 / torch.where(ok, a, 1.0)
    t = (tdet * s) * inv
    hit = ok & okb & (t > teps[:, None]) & (t < tmax[:, None])
    return hit, t, us * inv, vs * inv


def intersect_mxu(w_chunks: torch.Tensor, o, d, tmax, t_count: int,
                  chunk: int = DEFAULT_CHUNK):
    """Closest hit of N rays vs T triangles, chunk by chunk.  Returns
    (t, idx, b0, b1) with b0 = 1-u-v, b1 = u."""
    n = o.shape[0]
    feats = ray_features(o, d)
    teps = ray_teps(o)
    best_t = tmax.to(torch.float32).clone()
    best_i = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    best_b0 = torch.zeros(n, device=o.device)
    best_b1 = torch.zeros(n, device=o.device)
    rows = torch.arange(n, device=o.device)
    for ci in range(w_chunks.shape[0]):
        quad = feats @ w_chunks[ci]
        hit, t, u, v = _accept(
            quad[:, 0 * chunk:1 * chunk], quad[:, 1 * chunk:2 * chunk],
            quad[:, 2 * chunk:3 * chunk], quad[:, 3 * chunk:4 * chunk],
            best_t, teps)
        ids = ci * chunk + torch.arange(chunk, dtype=torch.int32,
                                        device=o.device)
        valid = hit & (ids[None, :] < t_count)
        t_masked = torch.where(valid, t, float("inf"))
        j = torch.argmin(t_masked, dim=-1)
        tj = t_masked[rows, j]
        uj = u[rows, j]
        vj = v[rows, j]
        better = tj < best_t
        best_t = torch.where(better, tj, best_t)
        best_i = torch.where(better, ids[j], best_i)
        best_b0 = torch.where(better, 1.0 - uj - vj, best_b0)
        best_b1 = torch.where(better, uj, best_b1)
    return best_t, best_i, best_b0, best_b1


def occluded_mxu(w_chunks: torch.Tensor, o, d, tmax, t_count: int,
                 chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """Any-hit via the same products."""
    feats = ray_features(o, d)
    teps = ray_teps(o)
    blocked = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    for ci in range(w_chunks.shape[0]):
        quad = feats @ w_chunks[ci]
        hit, _, _, _ = _accept(
            quad[:, 0 * chunk:1 * chunk], quad[:, 1 * chunk:2 * chunk],
            quad[:, 2 * chunk:3 * chunk], quad[:, 3 * chunk:4 * chunk],
            tmax, teps)
        ids = ci * chunk + torch.arange(chunk, dtype=torch.int32,
                                        device=o.device)
        blocked = blocked | (hit & (ids[None, :] < t_count)).any(-1)
    return blocked
