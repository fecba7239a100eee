"""The last of the JAX package's single-device API in the port, each
against its JAX twin on numpy-seeded inputs:

* sampling/distribution.py: sample_continuous, build_distribution_2d,
  sample_continuous_2d, pdf_2d (and the checks of
  tests/test_sampling.py's TestDistribution2D);
* texturing/texture.py: texture_distribution_2d on atlases built by
  both packages' AtlasBuilder, transformed_mapping_3d;
* bxdf/slots.py: the two sweeps bsdf_evaluate / bsdf_pdf (through K9's
  dispatcher, the plain fused sweep on the CPU) against JAX's two
  separate sweeps, and the albedo estimators rho_hd / rho_hh (through
  K8's dispatcher) against JAX's, on render/fuzz.py's slot inputs (the
  five material recipes of tests/test_pallas_shade.py, and grazing wo on
  glass), and the Lambertian albedo check of tests/test_sampling.py;
* sampling/warps.py: the hemisphere, disk and triangle warps and the
  two MIS heuristics;
* utils.py: the named phases of a render.

Tolerances, with my CPU run's residuals: the distributions' x, y and
pdfs within 1e-6 relative (equal: the same float32 ops); the texture
distribution's arrays equal; the mapping 1e-6 (a float32 matmul,
2.4e-7); the warps 1e-6 (6.0e-8); bsdf_evaluate's f and bsdf_pdf, the
fused sweep against JAX's separate ones, within SWEEP_RTOL / SWEEP_ATOL
(1.1e-6 relative, on grazing glass where f = F / |cos| reaches 3.3e3
too; kinds equal); rho_hd / rho_hh within RHO_RTOL (9.3e-5 relative on
the grazing glass lanes' f / pdf, 4.4e-6 elsewhere)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from arendur_tpu import materials as jm
from arendur_tpu.bxdf import slots as jsl
from arendur_tpu.sampling import distribution as jdist
from arendur_tpu.sampling import warps as jwarps
from arendur_tpu.texturing import texture as jtex
from arendur_tpu_torch import materials as tm
from arendur_tpu_torch import sampling as tsampling
from arendur_tpu_torch import scene as tsc
from arendur_tpu_torch import utils
from arendur_tpu_torch.bxdf import slots as tsl
from arendur_tpu_torch.bxdf.types import ALL, ALL_NON_SPECULAR
from arendur_tpu_torch.parallel import distributed as tdist
from arendur_tpu_torch.parallel import mesh as tmesh
from arendur_tpu_torch.render import fuzz
from arendur_tpu_torch.render import integrator as tint
from arendur_tpu_torch.sampling import distribution as tdst
from arendur_tpu_torch.sampling import warps as twarps
from arendur_tpu_torch.texturing import texture as ttex

torch.set_num_threads(2)

DIST_RTOL = 1e-6
MAP_ATOL = 1e-6
WARP_ATOL = 1e-6
SWEEP_RTOL, SWEEP_ATOL = 1e-5, 1e-6
RHO_RTOL, RHO_ATOL = 3e-4, 1e-6
N = 1024

F2 = np.asarray([[1.0, 0.0, 3.0, 0.0],
                 [0.0, 2.0, 0.0, 2.0],
                 [4.0, 0.0, 0.0, 0.0]], np.float32)


def _u(n, seed, d=2):
    return np.random.default_rng(seed).random((n, d)).astype(np.float32)


# --------------------------------------------------------------------------
# distributions
# --------------------------------------------------------------------------

@pytest.mark.parametrize("func", [[1.0, 3.0], [0.0, 0.0, 0.0],
                                  [0.5, 0.0, 2.0, 1.0, 0.25]])
def test_sample_continuous_matches_jax(func):
    u = _u(4096, 1, 1)[:, 0]
    x, pdf, idx = tdst.sample_continuous(tdst.build_distribution_1d(func),
                                         torch.tensor(u))
    jx, jpdf, jidx = jdist.sample_continuous(
        jdist.build_distribution_1d(func), jnp.asarray(u))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=DIST_RTOL)
    np.testing.assert_allclose(pdf.numpy(), np.asarray(jpdf), rtol=DIST_RTOL)


@pytest.mark.parametrize("f", [F2, np.zeros((2, 2), np.float32),
                               np.asarray([[0.0, 0.0], [1.0, 5.0]],
                                          np.float32)])
def test_distribution_2d_matches_jax(f):
    d, jd = tdst.build_distribution_2d(f), jdist.build_distribution_2d(f)
    for k in ("cond_func", "cond_cdf", "cond_int"):
        np.testing.assert_array_equal(getattr(d, k), np.asarray(getattr(jd,
                                                                        k)))
    np.testing.assert_array_equal(d.marginal.cdf,
                                  np.asarray(jd.marginal.cdf))
    u = _u(4096, 3)
    xy, pdf = tdst.sample_continuous_2d(d, torch.tensor(u))
    jxy, jpdf = jdist.sample_continuous_2d(jd, jnp.asarray(u))
    assert xy.shape == (4096, 2) and pdf.shape == (4096,)
    assert torch.isfinite(xy).all() and torch.isfinite(pdf).all()
    np.testing.assert_allclose(xy.numpy(), np.asarray(jxy), rtol=DIST_RTOL,
                               atol=1e-7)
    np.testing.assert_allclose(pdf.numpy(), np.asarray(jpdf), rtol=DIST_RTOL)
    p2 = tdst.pdf_2d(d, xy)
    np.testing.assert_allclose(p2.numpy(),
                               np.asarray(jdist.pdf_2d(jd, jnp.asarray(
                                   xy.numpy()))), rtol=DIST_RTOL)


def test_distribution_2d_density():
    """tests/test_sampling.py's check: cell frequencies track f, pdf_2d
    agrees with the sampling pdf."""
    d = tdst.build_distribution_2d(F2)
    xy, pdf = tdst.sample_continuous_2d(d, torch.tensor(_u(20000, 3)))
    xy, pdf = xy.numpy(), pdf.numpy()
    assert (pdf > 0).all()
    xi = np.clip((xy[:, 0] * 4).astype(int), 0, 3)
    yi = np.clip((xy[:, 1] * 3).astype(int), 0, 2)
    counts = np.zeros_like(F2)
    np.add.at(counts, (yi, xi), 1.0)
    np.testing.assert_allclose(counts / counts.sum(), F2 / F2.sum(),
                               atol=0.02)
    np.testing.assert_allclose(tdst.pdf_2d(d, torch.tensor(xy)).numpy(), pdf,
                               rtol=1e-4)


# --------------------------------------------------------------------------
# texture distribution and mapping
# --------------------------------------------------------------------------

def _atlases():
    rng = np.random.default_rng(4)
    imgs = [rng.uniform(0.0, 1.0, (5, 7, 3)).astype(np.float32),
            np.zeros((2, 2, 3), np.float32)]
    imgs[1][0, 1] = 3.0     # three-quarters of the mass in one texel
    imgs[1][1, 0] = 1.0
    tb, jb = ttex.AtlasBuilder(), jtex.AtlasBuilder()
    for img in imgs:
        tb.add_image(img)
        jb.add_image(img)
    return tb.build(), jb.build()


@pytest.mark.parametrize("tex_id", [0, 1])
def test_texture_distribution_2d_matches_jax(tex_id):
    atlas, jatlas = _atlases()
    d = ttex.texture_distribution_2d(atlas, tex_id)
    jd = jtex.texture_distribution_2d(jatlas, tex_id)
    for k in ("cond_func", "cond_cdf", "cond_int"):
        np.testing.assert_array_equal(getattr(d, k), np.asarray(getattr(jd,
                                                                        k)))
    u = np.stack(np.meshgrid(np.linspace(0.01, 0.99, 40),
                             np.linspace(0.01, 0.99, 40)),
                 -1).reshape(-1, 2).astype(np.float32)
    xy, pdf = tdst.sample_continuous_2d(d, torch.tensor(u))
    jxy, jpdf = jdist.sample_continuous_2d(jd, jnp.asarray(u))
    np.testing.assert_allclose(xy.numpy(), np.asarray(jxy), rtol=DIST_RTOL,
                               atol=1e-7)
    np.testing.assert_allclose(pdf.numpy(), np.asarray(jpdf), rtol=DIST_RTOL)
    assert (pdf > 0.0).all()
    if tex_id == 1:
        xy = xy.numpy()
        hot = np.mean((xy[:, 0] > 0.5) & (xy[:, 1] < 0.5))
        np.testing.assert_allclose(hot, 0.75, atol=0.05)


def test_texture_distribution_2d_weight_fn():
    atlas, jatlas = _atlases()
    f = lambda rgb: rgb[0] + 2.0 * rgb[2]   # noqa: E731
    d = ttex.texture_distribution_2d(atlas, 0, f)
    jd = jtex.texture_distribution_2d(jatlas, 0, f)
    np.testing.assert_array_equal(d.cond_func, np.asarray(jd.cond_func))


def test_transformed_mapping_3d_matches_jax():
    rng = np.random.default_rng(6)
    m = rng.normal(size=(4, 4)).astype(np.float32)
    pos, dx, dy = (rng.normal(size=(64, 3)).astype(np.float32)
                   for _ in range(3))
    t = lambda a: torch.tensor(a)   # noqa: E731
    got = ttex.transformed_mapping_3d(m, t(pos), t(dx), t(dy))
    ref = jtex.transformed_mapping_3d(m, jnp.asarray(pos), jnp.asarray(dx),
                                      jnp.asarray(dy))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=MAP_ATOL)
    p, tx, ty = ttex.transformed_mapping_3d(m, t(pos))
    assert tx is None and ty is None
    # a translation moves points, not vectors (tests/test_texturing.py)
    m = np.eye(4, dtype=np.float32)
    m[3, :3] = (1.0, 2.0, 3.0)
    m[0, 0] = 2.0
    p, tx, _ = ttex.transformed_mapping_3d(
        m, torch.tensor([[1.0, 1.0, 1.0]]), torch.tensor([[1.0, 0.0, 0.0]]))
    np.testing.assert_allclose(p.numpy()[0], [3.0, 3.0, 4.0])
    np.testing.assert_allclose(tx.numpy()[0], [2.0, 0.0, 0.0])


# --------------------------------------------------------------------------
# the two sweeps and the albedo estimators
# --------------------------------------------------------------------------

CASES = {"recipes": dict(), "grazing": dict(grazing=True,
                                            rows=fuzz.SLOT_ROWS[3:4])}


def _both(case, seed=0):
    inp = fuzz.fuzz_slot_inputs(N, seed, **CASES[case])
    table = jm.make_material_table(inp["rows"])
    ns = jnp.asarray(inp["ns"])
    jb = jm.compute_scattering(table, jnp.asarray(inp["mat_id"]), ns, ns,
                               jnp.asarray(inp["dpdu"]))
    b, wo, u, wi = fuzz.fuzz_slots(inp)
    return inp, jb, b, wo, wi


@pytest.mark.parametrize("case,types", [("recipes", ALL),
                                        ("recipes", ALL_NON_SPECULAR),
                                        ("grazing", ALL)])
def test_two_sweeps_match_jax(case, types):
    inp, jb, b, wo, wi = _both(case)
    jwo, jwi = jnp.asarray(inp["wo"]), jnp.asarray(inp["wi"])
    f, kinds = tsl.bsdf_evaluate(b, wo, wi, types)
    pdf = tsl.bsdf_pdf(b, wo, wi, types)
    jf, jkinds = jsl.bsdf_evaluate(jb, jwo, jwi, types)
    jpdf = np.asarray(jsl.bsdf_pdf(jb, jwo, jwi, types))
    jf = np.asarray(jf)
    assert f.shape == (N, 3) and kinds.dtype == torch.int32
    np.testing.assert_array_equal(kinds.numpy(), np.asarray(jkinds))
    np.testing.assert_allclose(pdf.numpy(), jpdf, rtol=SWEEP_RTOL,
                               atol=SWEEP_ATOL)
    np.testing.assert_allclose(f.numpy(), jf, rtol=SWEEP_RTOL,
                               atol=SWEEP_ATOL)


@pytest.mark.parametrize("case", list(CASES))
def test_rho_matches_jax(case):
    inp, jb, b, wo, _ = _both(case)
    rng = np.random.default_rng(5)
    s, s1, s2 = (rng.random((3, N, 2)).astype(np.float32) for _ in range(3))
    rho = tsl.rho_hd(b, wo, torch.tensor(s))
    jrho = np.asarray(jsl.rho_hd(jb, jnp.asarray(inp["wo"]), jnp.asarray(s)))
    assert torch.isfinite(rho).all()
    np.testing.assert_allclose(rho.numpy(), jrho, rtol=RHO_RTOL,
                               atol=RHO_ATOL)
    hh = tsl.rho_hh(b, torch.tensor(s1), torch.tensor(s2))
    jhh = np.asarray(jsl.rho_hh(jb, jnp.asarray(s1), jnp.asarray(s2)))
    np.testing.assert_allclose(hh.numpy(), jhh, rtol=RHO_RTOL, atol=RHO_ATOL)


def test_lambertian_rho_equals_reflectance():
    """tests/test_sampling.py's TestRho: a Lambertian kd's albedo."""
    rng = np.random.default_rng(5)
    n = 8
    table = tm.make_material_table([dict(mtype=tm.M_MATTE,
                                         kd=(0.25, 0.5, 0.75))])
    ns = torch.tensor([[0.0, 0.0, 1.0]] * n)
    b = tm.compute_scattering(table, torch.tensor(tm.param_table(table)),
                              torch.zeros(n, dtype=torch.int32), ns, ns,
                              torch.tensor([[1.0, 0.0, 0.0]] * n))
    wow = torch.tensor([[0.3, 0.1, 0.9]] * n)
    s = torch.tensor(rng.random((64, n, 2)).astype(np.float32))
    np.testing.assert_allclose(tsl.rho_hd(b, wow, s).numpy().mean(0),
                               [0.25, 0.5, 0.75], atol=0.02)
    s1 = torch.tensor(rng.random((64, n, 2)).astype(np.float32))
    s2 = torch.tensor(rng.random((64, n, 2)).astype(np.float32))
    np.testing.assert_allclose(tsl.rho_hh(b, s1, s2).numpy().mean(0),
                               [0.25, 0.5, 0.75], atol=0.05)


# --------------------------------------------------------------------------
# warps
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["sample_uniform_hemisphere",
                                  "sample_uniform_disk",
                                  "sample_uniform_triangle"])
def test_warps_match_jax(name):
    u = _u(2048, 7)
    got = getattr(twarps, name)(torch.tensor(u)).numpy()
    ref = np.asarray(getattr(jwarps, name)(jnp.asarray(u)))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=WARP_ATOL)
    assert getattr(tsampling, name) is getattr(twarps, name)


@pytest.mark.parametrize("name", ["power_heuristic", "balance_heuristic"])
def test_heuristics_match_jax(name):
    rng = np.random.default_rng(8)
    pf, pg = (rng.uniform(0.0, 4.0, 512).astype(np.float32)
              for _ in range(2))
    pf[:8] = 0.0
    pg[:4] = 0.0                      # 0/0 lanes stay finite
    got = getattr(twarps, name)(1, torch.tensor(pf), 2, torch.tensor(pg))
    ref = np.asarray(getattr(jwarps, name)(1, jnp.asarray(pf), 2,
                                           jnp.asarray(pg)))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6)
    assert getattr(tsampling, name) is getattr(twarps, name)


def test_pdf_uniform_hemisphere():
    assert twarps.pdf_uniform_hemisphere() == pytest.approx(
        jwarps.pdf_uniform_hemisphere(), rel=1e-12)


# --------------------------------------------------------------------------
# named phases
# --------------------------------------------------------------------------

def _tiny():
    scene, camera, film_cfg, config = tdist._tiny_setup()
    return tsc.DeviceScene.build(scene, "cpu"), camera, film_cfg, config


@pytest.mark.parametrize("sync", [False, True])
def test_phase_totals_after_render(sync):
    """The JAX package's phases around a render's waves and its
    finalize (integrator.py:670,687; tests/test_aux.py)."""
    ds, camera, film_cfg, config = _tiny()
    utils.reset_phase_totals(sync=sync)
    try:
        img = tint.render(ds, camera, film_cfg, config)
        totals = utils.phase_totals()
        assert totals["pt rendering"] > 0.0 and "pt add sample" in totals
        assert torch.isfinite(img).all()
        # the sharded render adds the film's all-reduce
        tmesh.render_sharded(ds, camera, film_cfg, config,
                             tmesh.make_ray_mesh(device="cpu"))
        after = utils.phase_totals()
        assert after["pt rendering"] > totals["pt rendering"]
        assert "film all-reduce" in after
        utils.reset_phase_totals()
        assert utils.phase_totals() == {}
    finally:
        utils.reset_phase_totals()


def test_profile_phase_accumulates():
    utils.reset_phase_totals()
    for _ in range(3):
        with utils.profile_phase("outer"):
            with utils.profile_phase("inner"):
                pass
    totals = utils.phase_totals()
    assert set(totals) == {"outer", "inner"}
    assert totals["outer"] >= totals["inner"] >= 0.0
    utils.reset_phase_totals()
