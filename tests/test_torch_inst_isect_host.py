"""The instanced entries of the cluster closest-hit / any-hit kernels
(K1 / K2 over one instanced mesh, kernels/intersect.cu instanced_kernel)
on the CPU: their per-ray loop built for the host by a host C++
compiler, no nvcc (kernels/intersect_host.cpp run_inst, through
kernels/host_isect.py run_instanced), the new plain versions
(shapes/cluster_intersect.py intersect_instanced_reference /
occluded_instanced_reference) and the earlier route (one plain K1 / K2
over the [I * N] lanes with period N, then torch.argmin over the
instances, as the JAX package's scene.py does) agree on every lane: t,
local slot and instance, blocked.  The sets: the Cornell fuzz rays of
tests/test_torch_isect_host.py taken through three instances, two
coincident instances (the lower one wins every tie), camera rays over a
3 x 3 grid of instances, rays that graze an instance's world box, lanes
past n_alive, and shadow rays the world already blocks.  The padded
world box (scene.instance_table) admits every (ray, instance) pair that
holds a hit or a block.  Skips where no host compiler is found.
"""

import os

import numpy as np
import pytest
import torch

from arendur_tpu_torch import scene as sc
from arendur_tpu_torch.io import scenedesc
from arendur_tpu_torch.kernels import host_isect
from arendur_tpu_torch.render import fuzz
from arendur_tpu_torch.shapes import cluster_intersect as ci

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CB = os.path.join(REPO, "examples/cornellbox/cb.json")
N = 1024
DEAD = 100          # rays past n_alive


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    lib = host_isect.build(str(tmp_path_factory.mktemp("inst_isect")))
    if lib is None:
        pytest.skip("no host C++ compiler (g++) to build K1 / K2's loop")
    return lib


@pytest.fixture(scope="module")
def cornell():
    scene, *_ = scenedesc.parse_scene(CB)
    ds = sc.DeviceScene.build(scene, "cpu")
    v = np.concatenate([scene.tri_v0, scene.tri_v1, scene.tri_v2])
    rays = [torch.tensor(a) for a in fuzz.sphere_rays(
        scene.spheres, v.min(0), v.max(0), N, 8)]
    return ds, v, rays


def _translate(x, y, z):
    m = np.eye(4, dtype=np.float32)
    m[3, :3] = (x, y, z)
    return m


def _rotate_z(a):
    m = np.eye(4, dtype=np.float32)
    c, s = np.cos(a), np.sin(a)
    m[:2, :2] = ((c, s), (-s, c))
    return m


def _three():
    """w2o of three instances (test_instanced_launch_matches_plain's)."""
    m = np.repeat(np.eye(4, dtype=np.float32)[None], 3, 0)
    m[1, :3, :3] = ((0.8, 0.6, 0.0), (-0.6, 0.8, 0.0), (0.0, 0.0, 1.0))
    m[1:, 3, :3] = ((0.3, -0.2, 0.1), (-0.4, 0.0, 0.5))
    return m


def _grid(span):
    """w2o of a 3 x 3 grid of instances, span apart, the middle one
    turned a little."""
    o2w = [_translate(span * (k % 3 - 1), span * (k // 3 - 1), 0.0)
           for k in range(9)]
    o2w[4] = _rotate_z(0.3) @ o2w[4]
    return np.stack([np.linalg.inv(m) for m in o2w]).astype(np.float32)


def _old_lanes(itab, o, d):
    ol, dl = ci.instance_frame(itab[:, None], o[None], d[None])
    return ol.reshape(-1, 3), dl.reshape(-1, 3)


def old_closest(ds, itab, o, d, bound, n_alive, lib=None):
    """The earlier route: one K1 over the [I * N] lanes (period N), the
    plain version's, or the kernels' loop built for the host with lib,
    then the nearest instance by torch.argmin (the first at equal t):
    (t, the bound on a miss; slot; instance, 0 on a miss) and the [I, N]
    slots."""
    ni, n = itab.shape[0], o.shape[0]
    ol, dl = _old_lanes(itab, o, d)
    if lib is None:
        t_f, s_f = ci.intersect_clusters_reference(
            ds.cw, ds.cbox, ol, dl, bound.repeat(ni), n_alive, period=n)
    else:
        t_f, s_f, _ = (torch.tensor(x) for x in host_isect.run(
            lib, False, ds.cw, ds.cbox, ol, dl, bound.repeat(ni), n_alive,
            period=n))
    t_im = torch.where(s_f >= 0, t_f, float("inf")).reshape(ni, n)
    best = torch.argmin(t_im, 0)
    t = t_im.gather(0, best[None])[0]
    slot = s_f.reshape(ni, n).gather(0, best[None])[0]
    return (torch.where(slot >= 0, t, bound), slot, best.to(torch.int32),
            s_f.reshape(ni, n))


def old_occluded(ds, itab, o, d, tmax, n_alive, lib=None):
    """The earlier route's any hit: [I, N] blocked flags."""
    ni, n = itab.shape[0], o.shape[0]
    ol, dl = _old_lanes(itab, o, d)
    if lib is None:
        b_f = ci.occluded_clusters_reference(
            ds.cw, ds.cbox, ol, dl, tmax.repeat(ni), n_alive, period=n)
    else:
        b_f = torch.tensor(host_isect.run(
            lib, True, ds.cw, ds.cbox, ol, dl, tmax.repeat(ni), n_alive,
            period=n)[1])
    return b_f.reshape(ni, n)


def _equal(got, want):
    """(t, slot, instance) triples equal on every lane."""
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def check(lib, ds, w2o, o, d, bound, n_alive=None, blocked=None):
    """The host loop equal to the earlier route through the world
    kernels' loop, and the plain version to the earlier route through
    the plain K1 / K2, on every lane; the host loop equal to the plain
    version on every lane where the world kernels' loop is (the cluster
    slab test can drop a hit on a cluster box's boundary, in both
    routes alike: returns those lanes).  The padded world boxes admit
    every pair with a hit or a block.  Returns (t, slot, inst, blocked,
    ibox) of the host loop and the lanes where the cluster tests drop a
    hit or a block."""
    itab = torch.tensor(sc.instance_table(ds.cbox.numpy(), w2o))
    na = None if n_alive is None else torch.tensor(n_alive)
    n = o.shape[0]
    live = torch.arange(n) < (n if n_alive is None else n_alive)
    world = torch.zeros(n, dtype=torch.bool) if blocked is None else blocked
    t_h, s_h, i_h, (ibox, _) = host_isect.run_instanced(
        lib, False, ds.cw, ds.cbox, itab, o, d, bound, n_alive)
    _, b_h, _, _ = host_isect.run_instanced(
        lib, True, ds.cw, ds.cbox, itab, o, d, bound, n_alive, blocked)
    t_p, s_p, i_p = ci.intersect_instanced_reference(
        ds.cw, ds.cbox, itab, o, d, bound, na)
    b_p = ci.occluded_instanced_reference(ds.cw, ds.cbox, itab, o, d, bound,
                                          na, blocked)
    old_p = old_closest(ds, itab, o, d, bound, na)
    old_h = old_closest(ds, itab, o, d, bound, n_alive, lib)
    bf_p = old_occluded(ds, itab, o, d, bound, na)
    bf_h = old_occluded(ds, itab, o, d, bound, n_alive, lib)
    _equal((t_h, s_h, i_h), old_h[:3])
    _equal((t_p, s_p, i_p), old_p[:3])
    np.testing.assert_array_equal(b_h, (bf_h.any(0) | (live & world)))
    np.testing.assert_array_equal(b_p, (bf_p.any(0) | (live & world)))
    edge = (old_h[1] != old_p[1]) | (bf_h.any(0) != bf_p.any(0))
    keep = ~edge.numpy()
    _equal((t_h[keep], s_h[keep], i_h[keep], b_h[keep]),
           (t_p[keep], s_p[keep], i_p[keep], b_p[keep]))
    # the cull: every (instance, ray) pair with a hit within the bound, or
    # a block within tmax, enters the padded world box before it
    admit = ci.instance_box_mask(itab, o, d, bound)
    assert not ((old_p[3] >= 0) & ~admit).any()
    assert not (bf_p & ~admit).any()
    # the host loop admitted each ray's winning instance
    hit = s_h >= 0
    assert ibox[np.nonzero(hit)[0], i_h[hit]].all()
    return t_h, s_h, i_h, b_h, ibox, edge


def test_cornell_rays_three_instances(host_lib, cornell):
    """The Cornell fuzz rays through three instances (one turned, two
    moved), a live count, half the lanes unbounded."""
    ds, _, (o, d, tmax) = cornell
    t, s, inst, b, _, edge = check(host_lib, ds, _three(), o, d, tmax,
                                   N - DEAD)
    assert not edge.any()
    assert (s[N - DEAD:] == -1).all() and not b[N - DEAD:].any()
    assert (inst[N - DEAD:] == 0).all()
    assert (t[N - DEAD:] == tmax[N - DEAD:].numpy()).all()
    assert (s >= 0).mean() > 0.3 and len(np.unique(inst[s >= 0])) == 3


def test_coincident_instances_lowest_wins(host_lib, cornell):
    """Instances 1 and 2 coincide (instance 0 lies far away): every hit
    ties between them, and instance 1 takes it."""
    ds, _, (o, d, tmax) = cornell
    w2o = np.stack([_translate(40.0, 0.0, 0.0), np.eye(4, dtype=np.float32),
                    np.eye(4, dtype=np.float32)])
    _, s, inst, _, ibox, edge = check(host_lib, ds, w2o, o, d, tmax)
    assert not edge.any()
    hit = s >= 0
    assert hit.mean() > 0.2 and (inst[hit] == 1).all()
    # the far instance's box admits none of the rays inside the box
    assert not ibox[:, 0].any()


def test_grid_camera_rays(host_lib, cornell):
    """Camera rays from well outside a 3 x 3 grid of instances, toward
    points spread over the grid: most meet one instance's box, and its
    neighbours' boxes cull the rest."""
    ds, v, _ = cornell
    lo, hi = v.min(0), v.max(0)
    span = 1.5 * float((hi - lo).max())
    rng = np.random.default_rng(5)
    eye = np.array([0.5 * (lo[0] + hi[0]), 0.5 * (lo[1] + hi[1]),
                    hi[2] + 4.0 * span])
    target = rng.uniform(lo - span, hi + span, (N, 3))
    target[:, 2] = rng.uniform(lo[2], hi[2], N)
    o = torch.tensor(np.repeat(eye[None], N, 0), dtype=torch.float32)
    d = torch.tensor(target - eye, dtype=torch.float32)
    d = d / d.norm(dim=-1, keepdim=True)
    tmax = torch.full((N,), float("inf"))
    _, s, inst, b, ibox, edge = check(host_lib, ds, _grid(span), o, d,
                                      tmax, N - DEAD)
    assert not edge.any()
    assert (s >= 0).mean() > 0.1 and len(np.unique(inst[s >= 0])) == 9
    assert ibox.sum(1).mean() < 3.0


def test_grazing_world_boxes(host_lib, cornell):
    """Rays aimed at points on the faces, edges and corners of an
    instance's world box (the exact union of its clusters, turned and
    moved), 1e-6 of its size inside or outside, from outside the box,
    and rays at 1e-3 to its faces; shadow rays ending at those
    points."""
    ds, v, _ = cornell
    w2o = _grid(1.5 * float((v.max(0) - v.min(0)).max()))[3:6]
    lo = ds.cbox[:, 0:3].min(0).values.double().numpy()
    hi = ds.cbox[:, 3:6].max(0).values.double().numpy()
    rng = np.random.default_rng(11)
    k = N // 2
    # points on the local box's surface: a random face, or pinned to an
    # edge or a corner, nudged in or out
    p = rng.uniform(lo, hi, (k, 3))
    axes = rng.integers(0, 3, (k, 3))
    pins = rng.integers(1, 4, k)
    for r in range(k):
        for a in axes[r, :pins[r]]:
            p[r, a] = (lo[a], hi[a])[rng.integers(0, 2)]
    p += rng.choice([-1e-6, 0.0, 1e-6], (k, 1)) * (hi - lo)
    inst = rng.integers(0, 3, k)
    m = w2o.astype(np.float64)
    world = np.einsum("nj,njk->nk", p - m[inst, 3, :3],
                      np.linalg.inv(m[inst, :3, :3]))
    dirs = rng.normal(size=(k, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    o_aim = world - 3.0 * (hi - lo).max() * dirs
    # along a face: from outside the box's extent, at 1e-3 to the face
    # (a ray that lies in a cluster box's face plane can lose a hit on
    # the box's edge to K1 / K2's slab test itself, the world launches'
    # as much as the instanced ones')
    d_face = rng.normal(size=(k, 3))
    face = rng.integers(0, 3, k)
    d_face[np.arange(k), face] = 0.0
    d_face /= np.linalg.norm(d_face, axis=-1, keepdims=True)
    d_face[np.arange(k), face] = rng.choice([-1e-3, 1e-3], k)
    # a face's direction in the world: through the linear part of o2w
    d_face = np.einsum("nj,njk->nk", d_face,
                       np.linalg.inv(m[inst, :3, :3]))
    d_face /= np.linalg.norm(d_face, axis=-1, keepdims=True)
    o_face = world - 2.0 * (hi - lo).max() * d_face
    o = torch.tensor(np.concatenate([o_aim, o_face]), dtype=torch.float32)
    d = torch.tensor(np.concatenate([dirs, d_face]), dtype=torch.float32)
    dist = np.linalg.norm(np.concatenate([world - o_aim, world - o_face]),
                          axis=-1)
    # half unbounded, half ending at the point (the shadow ray's segment)
    tmax = torch.tensor(np.where(np.arange(N) % 2 == 0, np.inf, dist),
                        dtype=torch.float32)
    _, s, _, b, _, edge = check(host_lib, ds, w2o, o, d, tmax)
    assert (s >= 0).mean() > 0.25 and b.mean() > 0.1
    # a few rays meet an edge of the box on its boundary, where the
    # cluster slab test drops the hit
    assert edge.sum() <= 4


def test_world_blocked_shadow_rays(host_lib, cornell):
    """Shadow rays the world's K2 already blocked stay blocked and test
    nothing; past n_alive nothing is blocked, whatever the world's flags
    say."""
    ds, _, (o, d, tmax) = cornell
    rng = np.random.default_rng(3)
    world = torch.tensor(rng.uniform(size=N) < 0.3)
    _, _, _, b, _, edge = check(host_lib, ds, _three(), o, d, tmax,
                                N - DEAD, blocked=world)
    assert not edge.any()
    assert b[:N - DEAD][world[:N - DEAD].numpy()].all()
    assert not b[N - DEAD:].any()
    # the any hit's need: nothing for a ray the world blocked
    itab = torch.tensor(sc.instance_table(ds.cbox.numpy(), _three()))
    _, _, _, (ibox, need) = host_isect.run_instanced(
        host_lib, True, ds.cw, ds.cbox, itab, o, d, tmax, N - DEAD, world)
    assert not ibox[world.numpy()].any() and not need[world.numpy()].any()


def test_instance_table_boxes(cornell):
    """DeviceScene.build's instance rows: w2o's affine part, and a world
    box that holds every vertex of every instance, padded."""
    ds, v, _ = cornell
    o2w = np.stack([np.linalg.inv(m) for m in _grid(4.0)])
    itab = sc.instance_table(ds.cbox.numpy(), _grid(4.0))
    np.testing.assert_array_equal(itab[:, :12],
                                  _grid(4.0)[:, :, :3].reshape(-1, 12))
    world = np.einsum("nj,ijk->ink", v.astype(np.float64),
                      o2w[:, :3, :3]) + o2w[:, None, 3, :3]
    assert (itab[:, None, 12:15] < world).all()
    assert (itab[:, None, 15:18] > world).all()
    assert (itab[:, 18:] == 0).all()
    # a singular instance is never culled
    flat = _grid(4.0)[:1].copy()
    flat[0, :3, 2] = 0.0
    assert (np.abs(sc.instance_table(ds.cbox.numpy(), flat)[0, 12:18])
            == 1e30).all()
