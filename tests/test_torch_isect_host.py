"""The per-thread loop of the cluster closest-hit / any-hit kernels K1 /
K2 on the CPU: kernels/intersect_host.cpp builds the sphere pass, the
per-ray slab test, the four-triangle float4 groups over R rays and the
accept with its deferred division (kernels/intersect.cuh) with a host
C++ compiler, no nvcc (kernels/host_isect.py).  Its t, slots and
blocked flags equal the plain versions' (shapes/cluster_intersect.py)
on every lane of fuzz.sphere_rays on the Cornell box, with and without
the sphere table, at 1, 2 and 4 rays a thread, and of a crafted tie set
whose arithmetic is exact: a triangle duplicated within a cluster and
across two, a quad split along a diagonal within one cluster and across
two, with rays on the shared edge and vertex, a sphere and a triangle at
equal t, two spheres at equal t, tmax at and past the hit, rays past
n_alive, and the set twice over with period > 0 and no spheres.  The
tie set's winners are also asserted, and the set goes through the
Pallas kernels in interpret mode once.  Skips where no host compiler
is found.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arendur_tpu.shapes import pallas_intersect as pli
from arendur_tpu_torch import scene as sc
from arendur_tpu_torch.io import scenedesc
from arendur_tpu_torch.kernels import host_isect
from arendur_tpu_torch.render import fuzz
from arendur_tpu_torch.shapes import cluster_intersect as ci

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CB = os.path.join(REPO, "examples/cornellbox/cb.json")
N_FUZZ = 4096
DEAD = 300          # fuzz rays past n_alive
T_RTOL = 1e-5       # t of the random tie-set rays against XLA's


@pytest.fixture(scope="module")
def host_fn(tmp_path_factory):
    fn = host_isect.build(str(tmp_path_factory.mktemp("isect")))
    if fn is None:
        pytest.skip("no host C++ compiler (g++) to build K1 / K2's loop")
    return fn


def check(fn, w, cbox, o, d, tmax, n_alive, period=0, sph_tab=None,
          full_phi=False, rays_per_thread=2):
    """The host build against the plain versions, every lane to the bit:
    returns (t, slot, blocked) of the host build."""
    args = (w, cbox, o, d, tmax)
    kw = dict(period=period, sph_tab=sph_tab, full_phi=full_phi)
    na = torch.tensor(n_alive)
    t_p, s_p = ci.intersect_clusters_reference(*args, na, **kw)
    b_p = ci.occluded_clusters_reference(*args, na, **kw)
    t, s, _ = host_isect.run(fn, False, *args, n_alive, **kw,
                             rays_per_thread=rays_per_thread)
    _, b, _ = host_isect.run(fn, True, *args, n_alive, **kw,
                             rays_per_thread=rays_per_thread)
    np.testing.assert_array_equal(s, s_p.numpy())
    np.testing.assert_array_equal(t, t_p.numpy())
    np.testing.assert_array_equal(b, b_p.numpy())
    return t, s, b


@pytest.fixture(scope="module")
def cornell():
    scene, *_ = scenedesc.parse_scene(CB)
    ds = sc.DeviceScene.build(scene, "cpu")
    v = np.concatenate([scene.tri_v0, scene.tri_v1, scene.tri_v2])
    rays = [torch.tensor(a) for a in fuzz.sphere_rays(
        scene.spheres, v.min(0), v.max(0), N_FUZZ, 8)]
    return ds, rays


@pytest.mark.parametrize("table", ["none", "phi clip", "full_phi"])
def test_sphere_rays_match_plain(host_fn, cornell, table):
    ds, (o, d, tmax) = cornell
    kw = {} if table == "none" else dict(sph_tab=ds.ktab,
                                         full_phi=table == "full_phi")
    t, s, b = check(host_fn, ds.cw, ds.cbox, o, d, tmax, N_FUZZ - DEAD, **kw)
    assert (s[N_FUZZ - DEAD:] == -1).all() and not b[N_FUZZ - DEAD:].any()
    assert (s >= 0).mean() > 0.2 and 0.1 < b.mean() < 0.9
    if table != "none":
        assert (s <= -2).sum() > 100


@pytest.mark.parametrize("rays_per_thread", [1, 4])
def test_rays_per_thread_change_nothing(host_fn, cornell, rays_per_thread):
    ds, (o, d, tmax) = cornell
    check(host_fn, ds.cw, ds.cbox, o, d, tmax, N_FUZZ - DEAD,
          sph_tab=ds.ktab, rays_per_thread=rays_per_thread)


def test_need_counts_the_clusters_entered(host_fn, cornell):
    """need: the full K / 64 chunks for each cluster a closest-hit ray
    enters, none for the others; the any hit's at most as many and none
    past the ray's blocking."""
    ds, (o, d, tmax) = cornell
    per = ds.cw.shape[2] // 4 // host_isect.CHUNK
    _, s, need = host_isect.run(host_fn, False, ds.cw, ds.cbox, o, d, tmax)
    assert set(np.unique(need)) <= {0, per}
    assert (need[s >= 0].max(1) == per).all()
    _, b, need_b = host_isect.run(host_fn, True, ds.cw, ds.cbox, o, d, tmax)
    assert need_b.max() <= per and (need_b[b].sum(1) > 0).all()
    assert need_b.sum() < (need_b > 0).sum() * per


def _expect(s, want):
    for i, x in enumerate(want):
        if x is not None:
            assert s[i] == x, (i, s[i], x)


def test_tie_set_matches_plain(host_fn):
    w, cbox, ktab, o, d, tmax, na, want, want_ns = fuzz.tie_set()
    tt = lambda x: torch.tensor(x)  # noqa: E731
    args = (tt(w), tt(cbox), tt(o), tt(d), tt(tmax))
    for rpt in (1, 2, 4):
        t, s, b = check(host_fn, *args, na, sph_tab=tt(ktab),
                        rays_per_thread=rpt)
        _expect(s, want)
        hit = np.array([x not in (None, -1) for x in want])
        assert b[hit].all() and not b[np.array(want) == -1].any()
        assert (t[s == -1] == tmax[s == -1]).all()
        _, s_ns, _ = check(host_fn, *args, na, rays_per_thread=rpt)
        _expect(s_ns, want_ns)
    # the set twice over, batched instancing: n_alive within each block
    n = o.shape[0]
    two = (args[0], args[1]) + tuple(tt(np.concatenate([x, x]))
                                     for x in (o, d, tmax))
    _, s2, b2 = check(host_fn, *two, na, period=n)
    _expect(s2[:n], want_ns)
    _expect(s2[n:], want_ns)
    assert not b2[na:n].any() and not b2[n + na:].any()


def test_tie_set_matches_pallas_interpret(host_fn):
    """The Pallas kernels (interpret mode) on the tie set with its sphere
    table: the same slots and blocked flags on every live lane as the
    host build, the same t on the crafted rays (exact arithmetic) and
    within T_RTOL on the random ones (XLA contracts their multiply-adds).
    Past n_alive the Pallas kernels may report a sphere (they test the
    spheres before n_alive; shapes/cluster_intersect.py)."""
    w, cbox, ktab, o, d, tmax, na, want, _ = fuzz.tie_set()
    assert o.shape[0] <= 512
    jargs = tuple(jnp.asarray(x) for x in (w, cbox, o, d, tmax))
    kw = dict(n_alive=jnp.int32(na), sph_tab=jnp.asarray(ktab),
              interpret=True)
    t_j, s_j = (np.asarray(x) for x in pli.intersect_clusters(*jargs, **kw))
    b_j = np.asarray(pli.occluded_clusters(*jargs, **kw))
    t, s, _ = host_isect.run(host_fn, False, w, cbox, o, d, tmax, na,
                             sph_tab=ktab)
    _, b, _ = host_isect.run(host_fn, True, w, cbox, o, d, tmax, na,
                             sph_tab=ktab)
    np.testing.assert_array_equal(s[:na], s_j[:na])
    np.testing.assert_array_equal(b[:na], b_j[:na])
    crafted = np.array([x is not None for x in want[:na]])
    np.testing.assert_array_equal(t[:na][crafted], t_j[:na][crafted])
    np.testing.assert_allclose(t[:na], t_j[:na], rtol=T_RTOL)
    _expect(s, want)


def test_refused_arguments(host_fn, cornell):
    ds, (o, d, tmax) = cornell
    with pytest.raises(ValueError):
        host_isect.run(host_fn, False, ds.cw, ds.cbox, o[:256], d[:256],
                       tmax[:256], period=128, sph_tab=ds.ktab)
    with pytest.raises(ValueError):
        host_isect.run(host_fn, True, ds.cw[:, :, :4 * 32], ds.cbox,
                       o[:256], d[:256], tmax[:256])


@pytest.mark.parametrize("table", ["none", "phi clip", "full_phi"])
def test_no_cluster_matches_plain(host_fn, cornell, table):
    """No cluster (C = 0: a scene whose world pool is empty): the sphere
    pass alone, every lane equal to the plain versions (sphere_best)."""
    ds, (o, d, tmax) = cornell
    tab = None if table == "none" else ds.ktab
    w0, c0 = ds.cw[:0].contiguous(), ds.cbox[:0].contiguous()
    for rpt in (1, 2):
        t, s, b = check(host_fn, w0, c0, o, d, tmax, N_FUZZ - DEAD,
                        sph_tab=tab, full_phi=table == "full_phi",
                        rays_per_thread=rpt)
        assert (s >= 0).sum() == 0
        if tab is None:
            assert (s == -1).all() and not b.any()
        else:
            assert (s[:N_FUZZ - DEAD] <= -2).sum() > N_FUZZ // 8


def test_instanced_launch_matches_plain(host_fn, cornell):
    """One instanced mesh's [I * N] lanes (period N) over the Cornell
    tables: the rays taken into three instances' frames, every lane equal
    to the plain versions, the live count applied per instance."""
    ds, (o, d, tmax) = cornell
    n = 1024
    m = torch.eye(4).repeat(3, 1, 1)
    m[1, :3, :3] = torch.tensor([[0.8, 0.6, 0.0], [-0.6, 0.8, 0.0],
                                 [0.0, 0.0, 1.0]])
    m[1:, 3, :3] = torch.tensor([[0.3, -0.2, 0.1], [-0.4, 0.0, 0.5]])
    ol = torch.stack(sc.affine(m[:, None], o[:n].unbind(-1)), -1)
    dl = torch.stack(sc.affine(m[:, None], d[:n].unbind(-1), point=False),
                     -1)
    t, s, b = check(host_fn, ds.cw, ds.cbox, ol.reshape(-1, 3).contiguous(),
                    dl.reshape(-1, 3).contiguous(), tmax[:n].repeat(3),
                    n - DEAD, period=n)
    live = (np.arange(3 * n) % n) < n - DEAD
    assert (s[~live] == -1).all() and not b[~live].any()
    assert (s[live] >= 0).mean() > 0.3
