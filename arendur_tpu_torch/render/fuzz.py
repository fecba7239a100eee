"""Inputs for parity checks of the bounce shade.

``all_branches_scene`` fills a SceneBuilder (of this package or of the
JAX package: both have the same interface) with a scene whose tables
reach every branch of the bounce body: point, spot, distant,
area-triangle and partial (phimax < 2 pi) area-sphere lights, and
matte (Lambertian and Oren-Nayar), plastic, glass and translucent
materials.  The Cornell box reaches only area spheres and matte /
plastic / glass.

``fuzz_bounce_inputs`` draws semantically plausible random rows of the
[N, IN_COLS] bounce input (the generator of the JAX package's
tests/test_cbounce.py, for the same table shapes).
"""

from __future__ import annotations

import numpy as np

IN_COLS = 58


def all_branches_scene(builder):
    m_lam = builder.add_material(mtype=0, kd=(0.6, 0.5, 0.4))
    m_on = builder.add_material(mtype=0, kd=(0.3, 0.6, 0.5), sigma=20.0)
    m_pl = builder.add_material(mtype=1, kd=(0.5, 0.3, 0.2),
                                ks=(0.4, 0.4, 0.4), roughness=0.3)
    m_gl = builder.add_material(mtype=2, kd=(0.7, 0.7, 0.8),
                                ks=(0.9, 0.9, 0.9), roughness=0.2,
                                eta=1.5)
    m_gs = builder.add_material(mtype=2, ks=(1.0, 1.0, 1.0), eta=1.33)
    m_tl = builder.add_material(mtype=3, kd=(0.4, 0.6, 0.3),
                                ks=(0.3, 0.3, 0.3), roughness=0.4,
                                dissolve=0.5)
    floor = np.array([[-3, 0, -3], [3, 0, -3], [3, 0, 3], [-3, 0, 3]],
                     np.float32)
    builder.add_mesh(floor, [[0, 1, 2], [0, 2, 3]], m_lam)
    wall = np.array([[-3, 0, -3], [3, 0, -3], [3, 3, -3], [-3, 3, -3]],
                    np.float32)
    builder.add_mesh(wall, [[0, 1, 2], [0, 2, 3]], m_on)
    builder.add_mesh(np.array([[-1, 2.5, 0], [1, 2.5, 0], [0, 2.5, 1]],
                              np.float32), [[0, 2, 1]], m_lam,
                     emission=(4.0, 3.5, 3.0))
    place = lambda x, y, z: np.array(
        [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0], [x, y, z, 1]],
        np.float32)
    builder.add_sphere(0.6, -0.6, 0.6, 2.0 * np.pi, m_pl,
                       transform=place(-1.5, 0.6, 0.5))
    builder.add_sphere(0.5, -0.5, 0.5, 2.0 * np.pi, m_gl,
                       transform=place(0.0, 0.5, 1.0))
    builder.add_sphere(0.4, -0.4, 0.4, 2.0 * np.pi, m_gs,
                       transform=place(1.2, 0.4, -0.5))
    builder.add_sphere(0.5, -0.5, 0.5, 2.0 * np.pi, m_tl,
                       transform=place(1.5, 0.5, 1.2))
    builder.add_sphere(0.3, -0.2, 0.3, 4.0, m_lam,
                       transform=place(-0.5, 2.2, -1.0),
                       emission=(6.0, 5.0, 4.0))
    builder.add_point_light((0.5, 2.8, 1.5), (3.0, 3.0, 3.0))
    builder.add_spot_light((-2.0, 2.8, 2.0), (0.5, -1.0, -0.5),
                           (8.0, 7.0, 6.0), 0.7, 0.9)
    builder.add_distant_light((0.3, 1.0, 0.2), (0.8, 0.8, 0.9))
    return builder.build()


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(
        np.float32)


def fuzz_bounce_inputs(ltab, mtab, stab, seed: int = 0, n: int = 2048):
    """[n, IN_COLS] float32 random bounce-input rows for the tables."""
    rng = np.random.default_rng(seed)
    n_m = int(np.asarray(mtab).shape[0])
    n_s = int(np.asarray(stab).shape[0])
    n_l = int(np.asarray(ltab).shape[0])
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = _unit(rng, n)
    t = rng.uniform(0.1, 3.0, n).astype(np.float32)
    hit = (rng.uniform(size=n) < 0.9).astype(np.float32)
    is_sph = (rng.uniform(size=n) < 0.3).astype(np.float32)
    s_idx = rng.integers(0, n_s, n).astype(np.float32)
    radius = np.asarray(stab)[s_idx.astype(int), 16]
    p_local = _unit(rng, n) * radius[:, None]
    v0 = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    v1 = v0 + _unit(rng, n) * 0.7
    v2 = v0 + _unit(rng, n) * 0.7
    nrm = np.stack([_unit(rng, n)] * 3, 1).reshape(n, 9)
    uvs = rng.uniform(0, 1, (n, 6)).astype(np.float32)
    tmat = rng.integers(0, n_m, n).astype(np.float32)
    tlight = np.where(rng.uniform(size=n) < 0.15,
                      rng.integers(0, n_l, n), -1).astype(np.float32)
    trow = np.concatenate(
        [v0, v1, v2, nrm, uvs, tmat[:, None], tlight[:, None]], 1)
    beta = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    L = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    spec = (rng.uniform(size=n) < 0.3).astype(np.float32)
    sel_prev = rng.integers(0, n_l, n).astype(np.float32)
    wb_prev = rng.uniform(0, 1, n).astype(np.float32)
    nee_prev = (rng.uniform(size=n) < 0.5).astype(np.float32)
    alive = (rng.uniform(size=n) < 0.95).astype(np.float32)
    lidx = rng.integers(0, n_l, n).astype(np.float32)
    selpdf = rng.uniform(0.2, 1.0, n).astype(np.float32)
    u_l = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    u_b = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    u_rr = rng.uniform(0, 1, n).astype(np.float32)
    bounce = rng.integers(0, 8, n).astype(np.float32)
    x = np.concatenate([
        o, d, t[:, None], hit[:, None], is_sph[:, None],
        s_idx[:, None], p_local, trow, beta, L, spec[:, None],
        sel_prev[:, None], wb_prev[:, None], nee_prev[:, None],
        alive[:, None], lidx[:, None], selpdf[:, None], u_l, u_b,
        u_rr[:, None], bounce[:, None]], 1).astype(np.float32)
    if x.shape[1] != IN_COLS:
        raise AssertionError(x.shape)
    return x
