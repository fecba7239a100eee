"""The hand-written kernels against their plain PyTorch versions on a
CUDA card.  Every test here needs the card and skips without one.  The
file imports no JAX, so it runs on a machine with the card alone:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_gpu.py
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from arendur_tpu_torch import scene as sc
from arendur_tpu_torch.io import scenedesc
from arendur_tpu_torch.kernels import ops
from arendur_tpu_torch.render import cbounce as cb
from arendur_tpu_torch.render import fuzz
from arendur_tpu_torch.render import integrator as integ
from arendur_tpu_torch.shapes import cluster_intersect as ci

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CB = os.path.join(REPO, "examples/cornellbox/cb.json")
N = 8192
SLOT_GATE = 0.999      # share of lanes whose slots / flags agree
T_RTOL = 1e-5          # t where the slots agree (FMA vs cuBLAS order)
ELEM_GATE = 0.999      # K3: share of elements within RTOL / ATOL
RTOL, ATOL = 1e-4, 1e-5
PLAIN_ATOL = 3e-3      # render: kernel path vs plain path, per pixel
K4_RTOL, K4_ATOL = 1e-3, 1e-5   # K4: summation order differs
K4_TAB_GATE = 1e-3     # K4: ||d - d_plain|| / ||d_plain||, table cotangents
GRAD_GATE = 1e-3       # train step: ||g - g_plain|| / ||g_plain||
GRAD_LR = 1e3          # a step large enough that (p - p_new) / lr keeps
                       # the gradient to f32 precision


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels run only there)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def cornell(card):
    scene, camera, film, config, _ = scenedesc.parse_scene(
        CB, spp_override=4, resolution_override=(24, 16))
    return sc.DeviceScene.build(scene, card), camera, film, config


def _rays(card, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.uniform([-1.9, -1.4, 2.1], [1.9, 2.4, 5.9], (N, 3))
    d = rng.normal(size=(N, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = rng.uniform(0.05, 6.0, N)
    f = lambda a: torch.tensor(a, dtype=torch.float32, device=card)
    return f(o), f(d), f(tmax)


@pytest.mark.gpu
@pytest.mark.parametrize("n_alive", [None, N - 1000])
def test_closest_hit_kernel_matches_plain(card, cornell, n_alive):
    ds = cornell[0]
    o, d, _ = _rays(card)
    tinf = torch.full((N,), float("inf"), device=card)
    na = None if n_alive is None else torch.tensor(n_alive, device=card)
    before = ops.CLOSEST_HIT.launches
    t, s = ci.intersect_clusters(ds.cw, ds.cbox, o, d, tinf, na)
    assert ops.CLOSEST_HIT.launches == before + 1
    t_p, s_p = ci.intersect_clusters_reference(ds.cw, ds.cbox, o, d, tinf,
                                               na)
    agree = s == s_p
    assert agree.float().mean().item() >= SLOT_GATE
    hit = agree & (s >= 0)
    torch.testing.assert_close(t[hit], t_p[hit], rtol=T_RTOL, atol=0.0)
    if n_alive is not None:
        assert (s[n_alive:] == -1).all()


@pytest.mark.gpu
@pytest.mark.parametrize("n_alive", [None, N - 1000])
def test_any_hit_kernel_matches_plain(card, cornell, n_alive):
    ds = cornell[0]
    o, d, tmax = _rays(card, 1)
    na = None if n_alive is None else torch.tensor(n_alive, device=card)
    b = ci.occluded_clusters(ds.cw, ds.cbox, o, d, tmax, na)
    b_p = ci.occluded_clusters_reference(ds.cw, ds.cbox, o, d, tmax, na)
    assert (b == b_p).float().mean().item() >= SLOT_GATE
    assert 0.05 < b.float().mean().item() < 0.95


def _sphere_rays(card, which, seed):
    """A scene with spheres on the card and fuzz.sphere_rays against it
    (camera-like, secondary, aimed, surface-started, inside, grazing)."""
    scene = (scenedesc.parse_scene(CB)[0] if which == "cornell"
             else fuzz.all_branches_scene(sc.SceneBuilder()))
    v = np.concatenate([scene.tri_v0, scene.tri_v1, scene.tri_v2])
    rays = fuzz.sphere_rays(scene.spheres, v.min(0), v.max(0), N, seed)
    return (sc.DeviceScene.build(scene, card),) + tuple(
        torch.tensor(a, device=card) for a in rays)


@pytest.mark.gpu
@pytest.mark.parametrize("full_phi", [False, True])
@pytest.mark.parametrize("which", ["cornell", "all-branches"])
def test_sphere_branch_kernels_match_plain(card, which, full_phi):
    """K1 / K2 with a sphere table: the sphere arithmetic is the plain
    version's op for op (-fmad=false), so every live lane whose code is
    a sphere on either side agrees, bar a sphere / triangle tie within
    T_RTOL (the triangle t of the FMA dots and of the matmul differ by
    ulps); sphere t equal; dead lanes miss."""
    ds, o, d, tmax = _sphere_rays(card, which, 4)
    na = torch.tensor(N - 1000, device=card)
    live = torch.arange(N, device=card) < N - 1000
    args = (ds.cw, ds.cbox, o, d, tmax, na)
    kw = dict(sph_tab=ds.ktab, full_phi=full_phi)
    before = ops.CLOSEST_HIT_SPHERES.launches, ops.ANY_HIT_SPHERES.launches
    t, s = ci.intersect_clusters(*args, **kw)
    b = ci.occluded_clusters(*args, **kw)
    assert (ops.CLOSEST_HIT_SPHERES.launches, ops.ANY_HIT_SPHERES.launches) \
        == (before[0] + 1, before[1] + 1)
    t_p, s_p = ci.intersect_clusters_reference(*args, **kw)
    b_p = ci.occluded_clusters_reference(*args, **kw)
    sph = live & ((s <= -2) | (s_p <= -2))
    tie = (t - t_p).abs() <= T_RTOL * t_p.abs()
    assert (sph & (s != s_p) & ~tie).sum().item() == 0
    both = live & (s == s_p) & (s <= -2)
    assert both.sum().item() > N // 8
    assert torch.equal(t[both], t_p[both])
    assert (s == s_p)[live].float().mean().item() >= SLOT_GATE
    assert (b == b_p)[live].float().mean().item() >= SLOT_GATE
    assert (s[~live] == -1).all() and not b[~live].any()


@pytest.mark.gpu
def test_intersect_tie_set_on_card(card):
    """K1 / K2 on render/fuzz.py's tie set: slots and blocked flags equal
    the plain versions' on every lane, the winners of the crafted ties
    (lowest slot, sphere over triangle, lowest sphere), misses past
    n_alive."""
    w, cbox, ktab, o, d, tmax, na, want, _ = fuzz.tie_set()
    on = lambda x: torch.tensor(x, device=card)  # noqa: E731
    args = (on(w), on(cbox), on(o), on(d), on(tmax), on(na))
    kw = dict(sph_tab=on(ktab))
    t_p, s_p = ci.intersect_clusters_reference(*args, **kw)
    b_p = ci.occluded_clusters_reference(*args, **kw)
    t, s = ops.closest_hit(*args, **kw)
    b = ops.any_hit(*args, **kw)
    assert torch.equal(s, s_p) and torch.equal(b, b_p)
    crafted = [i for i, x in enumerate(want) if x is not None]
    assert [int(s[i]) for i in crafted] == [want[i] for i in crafted]
    assert torch.equal(t[crafted], t_p[crafted])


@pytest.mark.gpu
def test_sphere_table_limits(card):
    """A table with batched instancing is refused; one of 2,251 rows
    (past the 2,250 the kernels once held in shared memory whole: five
    chunks of at most 512) launches in a block of the same shared memory
    and matches the plain version."""
    ds, o, d, tmax = _sphere_rays(card, "cornell", 5)
    with pytest.raises(ValueError, match="instancing"):
        ops.any_hit(ds.cw, ds.cbox, o, d, tmax, period=256,
                    sph_tab=ds.ktab)
    # copies of the scene's two spheres in turn, of which the first two
    # win every tie, across the chunks
    big = ds.ktab.repeat(1126, 1)[:2251].contiguous()
    t, s = ops.closest_hit(ds.cw, ds.cbox, o, d, tmax, sph_tab=big)
    b = ops.any_hit(ds.cw, ds.cbox, o, d, tmax, sph_tab=big)
    t_p, s_p = ci.intersect_clusters_reference(ds.cw, ds.cbox, o, d, tmax,
                                               sph_tab=big)
    b_p = ci.occluded_clusters_reference(ds.cw, ds.cbox, o, d, tmax,
                                         sph_tab=big)
    assert (s == s_p).float().mean().item() >= SLOT_GATE
    assert (b == b_p).float().mean().item() >= SLOT_GATE
    assert ((s == -2) | (s == -3)).any() and not (s < -3).any()
    # the lanes that hit a sphere, their sphere and t exactly as plain
    on_sph = s <= -2
    assert torch.equal(on_sph, s_p <= -2)
    assert torch.equal(s[on_sph], s_p[on_sph])
    assert torch.equal(t[on_sph], t_p[on_sph])
    agree = s == s_p
    assert torch.allclose(t[agree], t_p[agree], rtol=T_RTOL)


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["cornell", "all-branches"])
def test_bounce_shade_kernel_matches_plain(card, cornell, which):
    ds = cornell[0] if which == "cornell" else sc.DeviceScene.build(
        fuzz.all_branches_scene(sc.SceneBuilder()), card)
    tabs = (ds.ltab, ds.mtab, ds.stab)
    x = torch.tensor(fuzz.fuzz_bounce_inputs(
        *(t.cpu().numpy() for t in tabs), seed=3, n=N).T.copy(),
        device=card)
    out = cb.bounce_shade_t(x, *tabs, ds.static, 4, 0.05)
    ref = cb.cbody_reference(x, *tabs, ds.static, 4, 0.05)
    close = torch.isclose(out, ref, rtol=RTOL, atol=ATOL) \
        | (torch.isnan(out) & torch.isnan(ref))
    assert close.float().mean().item() >= ELEM_GATE
    for j in (12, 13, 16, 24):
        assert (out[j] == ref[j]).float().mean().item() >= SLOT_GATE


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["cornell", "all-branches"])
def test_bounce_shade_backward_kernel_matches_plain(card, cornell, which,
                                                    monkeypatch):
    """K4 (the CUDA backward) against autograd over the plain body, and
    the backward never reaches the plain body."""
    ds = cornell[0] if which == "cornell" else sc.DeviceScene.build(
        fuzz.all_branches_scene(sc.SceneBuilder()), card)
    tabs = (ds.ltab, ds.mtab, ds.stab)
    x = torch.tensor(fuzz.fuzz_bounce_inputs(
        *(t.cpu().numpy() for t in tabs), seed=4, n=N).T.copy(),
        device=card)
    ct = torch.tensor(np.random.default_rng(5).normal(
        size=(cb.OUT_COLS, N)).astype(np.float32), device=card)
    ref = cb.cbody_vjp_reference(x, *tabs, ct, ds.static, 4, 0.05)

    def plain_body(*args, **kw):
        raise AssertionError("the CUDA backward ran the plain body")

    for name in ("cbody", "cbody_reference", "cbody_vjp_reference"):
        monkeypatch.setattr(cb, name, plain_body)
    ins = [t.clone().requires_grad_(True) for t in (x,) + tabs]
    before = ops.BOUNCE_SHADE_BWD.launches
    out = cb.bounce_shade_t(*ins, ds.static, 4, 0.05)
    got = torch.autograd.grad(out, ins, ct)
    assert ops.BOUNCE_SHADE_BWD.launches == before + 1
    close = torch.isclose(got[0], ref[0], rtol=K4_RTOL, atol=K4_ATOL)
    assert close.float().mean().item() >= ELEM_GATE
    for g, r in zip(got[1:], ref[1:]):
        assert torch.isfinite(g).all()
        assert ((g - r).norm() / r.norm()).item() <= K4_TAB_GATE
    again = ops.bounce_shade_bwd(x, *tabs, ct, ds.static, 4, 0.05)
    for g, a in zip(got[1:], again[1:]):
        assert torch.equal(g, a)


@pytest.mark.gpu
def test_bounce_shade_backward_kernel_on_train_step_bounces(card, cornell):
    """K4 on the inputs and cotangents of every bounce of one kernel-path
    train step (depth 8), where most lanes of the later bounces take the
    pass-through: against autograd over the plain body on the lanes it
    tapes, dx equal to the pass-through on the others, and its count of
    taped lanes against the plain twin's (bwd_needs_body)."""
    ds, camera, film, config = cornell
    config = dataclasses.replace(config, max_depth=8)
    w, h = film.resolution
    n = w * h * config.spp
    target = torch.full((w * h, 3), 0.1, device=card)
    bounces = fuzz.train_step_bounces(ds, camera, film, config,
                                      integ.KERNEL_OPS, target,
                                      torch.arange(n, device=card))
    assert len(bounces) == 8
    args = (ds.static, config.min_depth, config.rr_threshold)
    skipped = 0
    for r in bounces:
        x, ct = r["xt"], r["ct"]
        tabs = (r["ltab"], r["mtab"], r["stab"])
        stats = {}
        got = ops.bounce_shade_bwd(x, *tabs, ct, *args, stats=stats)
        ref = cb.cbody_vjp_reference(x, *tabs, ct, *args)
        need = cb.bwd_needs_body(x, ct, r["stab"])
        assert int(stats["nodes"][2]) == int(need.sum())
        assert int(stats["nodes"][0]) <= ops.TAPE_CAP
        # the lanes let through: dx exactly the pass-through; the share
        # gate on the entries of the lanes taped alone
        assert torch.equal(got[0][:, ~need],
                           cb.bwd_pass_through(ct[:, ~need]))
        close = torch.isclose(got[0][:, need], ref[0][:, need],
                              rtol=K4_RTOL, atol=K4_ATOL)
        assert close.float().mean().item() >= ELEM_GATE
        for g, q in zip(got[1:], ref[1:]):
            assert torch.isfinite(g).all()
            rel = ((g - q).norm() / q.norm().clamp(min=1e-30)).item()
            assert rel <= K4_TAB_GATE
        skipped += int((~need).sum())
    assert skipped > 0


@pytest.mark.gpu
def test_render_kernel_path_matches_plain_path(card, cornell):
    ds, camera, film, config = cornell
    config = dataclasses.replace(config, max_depth=4)
    ops.reset_counts()
    img_k = integ.render(ds, camera, film, config)
    launches = ops.counts()
    img_p = integ.render(ds, camera, film, config, ops=integ.PLAIN_OPS)
    forward = ("closest_hit", "any_hit", "bounce_shade")
    assert min(launches[k] for k in forward) >= 1, launches
    assert torch.isfinite(img_k).all() and img_k.max() > 0.05
    torch.testing.assert_close(img_k, img_p, rtol=0.0, atol=PLAIN_ATOL)


@pytest.mark.gpu
def test_train_step_kernel_path_matches_plain_path(card, cornell):
    from arendur_tpu_torch.parallel import mesh
    ds, camera, film, config = cornell
    config = dataclasses.replace(config, max_depth=4)
    m = ds.materials
    params = {k: torch.tensor(v, device=card) for k, v in
              (("kd", m.kd), ("ks", m.ks), ("roughness", m.roughness))}
    w, h = film.resolution
    idx = torch.arange(w * h * config.spp, device=card)
    target = torch.full((w * h, 3), 0.1, device=card)
    grads = {}
    for name, wops in (("kernels", integ.KERNEL_OPS),
                       ("plain", integ.PLAIN_OPS)):
        new, loss = mesh.train_step_fn(ds, camera, film, config, lr=GRAD_LR,
                                       ops=wops)(dict(params), target, idx)
        assert torch.isfinite(loss)
        grads[name] = {k: (params[k] - new[k]) / GRAD_LR for k in new}
    for k in params:
        g, gp = grads["kernels"][k], grads["plain"][k]
        assert torch.isfinite(g).all() and torch.isfinite(gp).all()
        assert ((g - gp).norm() / gp.norm()).item() <= GRAD_GATE, k


def _split_inputs(ds, atlas, seed):
    """K5 and K6 inputs from fuzz rows (render/fuzz.py)."""
    xh, xs, _ = fuzz.fuzz_split_inputs(ds.ltab, ds.mtab, ds.stab, seed=seed,
                                       n=N, atlas=atlas)
    return xh, xs


def _textured_cornell(card):
    scene, camera, film, config, _ = scenedesc.parse_scene(
        CB, spp_override=4, resolution_override=(24, 16))
    scene, atlas = fuzz.checker_textured(scene, card)
    return sc.DeviceScene.build(scene, card), camera, film, \
        dataclasses.replace(config, textures=atlas)


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["textured cornell", "all-branches"])
def test_hit_and_split_shade_kernels_match_plain(card, which):
    if which == "all-branches":
        ds, atlas = sc.DeviceScene.build(
            fuzz.all_branches_scene(sc.SceneBuilder()), card), None
    else:
        ds, _, _, config = _textured_cornell(card)
        atlas = config.textures
    xh, xs = _split_inputs(ds, atlas, 6)
    before = (ops.HIT_SHADE.launches, ops.SHADE_SPLIT.launches)
    h = cb.hit_shade_t(xh, ds.stab)
    out = cb.shade_split_t(xs, ds.ltab, ds.static, 4, 0.05)
    assert (ops.HIT_SHADE.launches, ops.SHADE_SPLIT.launches) == (
        before[0] + 1, before[1] + 1)
    for got, ref, flags in (
            (h, cb.cbody_hit_reference(xh, ds.stab), (24, 25)),
            (out, cb.cbody_shade_reference(xs, ds.ltab, ds.static, 4, 0.05),
             (12, 13, 16, 24))):
        close = torch.isclose(got, ref, rtol=RTOL, atol=ATOL) \
            | (torch.isnan(got) & torch.isnan(ref))
        assert close.float().mean().item() >= ELEM_GATE
        for j in flags:
            assert (got[j] == ref[j]).float().mean().item() >= SLOT_GATE


@pytest.mark.gpu
def test_split_shade_backward_is_the_plain_vjp(card):
    """K6's autograd backward is autograd over the plain shade body."""
    ds, _, _, config = _textured_cornell(card)
    xh, xs = _split_inputs(ds, config.textures, 7)
    ct = torch.tensor(np.random.default_rng(8).normal(
        size=(cb.OUT_COLS, N)).astype(np.float32), device=card)
    ins = [xs.clone().requires_grad_(True),
           ds.ltab.clone().requires_grad_(True)]
    got = torch.autograd.grad(cb.shade_split_t(*ins, ds.static, 4, 0.05),
                              ins, ct)
    ref = cb.cbody_shade_vjp_reference(xs, ds.ltab, ct, ds.static, 4, 0.05)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.gpu
def test_textured_render_kernel_path_matches_plain_path(card):
    ds, camera, film, config = _textured_cornell(card)
    config = dataclasses.replace(config, max_depth=4)
    ops.reset_counts()
    img_k = integ.render(ds, camera, film, config)
    launches = ops.counts()
    img_p = integ.render(ds, camera, film, config, ops=integ.PLAIN_OPS)
    textured = ("closest_hit", "any_hit", "hit_shade", "shade_split")
    assert min(launches[k] for k in textured) >= 1, launches
    assert launches["bounce_shade"] == 0, launches
    assert torch.isfinite(img_k).all() and img_k.max() > 0.05
    torch.testing.assert_close(img_k, img_p, rtol=0.0, atol=PLAIN_ATOL)


@pytest.mark.gpu
def test_wrappers_reject_cpu_tensors(card):
    with pytest.raises(ValueError):
        ops.closest_hit(torch.zeros(1, 16, 1024), torch.zeros(1, 8),
                        torch.zeros(4, 3), torch.zeros(4, 3),
                        torch.zeros(4))
    with pytest.raises(ValueError):
        ops.hit_shade(torch.zeros(cb.HIT_IN_COLS, 4), torch.zeros(1, 24))
    b, wo, u, wi = fuzz.fuzz_slots(fuzz.fuzz_slot_inputs(4, 0))
    order = torch.arange(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        ops.slot_sample(b, wo, u, 31, order)
    with pytest.raises(ValueError):
        ops.slot_eval_pdf(b, wo, wi, 31)
    with pytest.raises(ValueError):
        ops.slot_order(b)
    bc, woc, uc, _ = fuzz.fuzz_slots(fuzz.fuzz_slot_inputs(4, 0), card)
    orderc = order.to(card)
    with pytest.raises(ValueError):      # wo on the CPU, the BSDF on the card
        ops.slot_sample(bc, wo, uc, 31, orderc)
    with pytest.raises(ValueError):      # int64 slot types
        ops.slot_sample(bc.replace(type=bc.type.long()), woc, uc, 31, orderc)
    with pytest.raises(ValueError):      # the order on the CPU
        ops.slot_sample(bc, woc, uc, 31, order)


SLOT_CASES = {"recipes": dict(), "grazing": dict(grazing=True,
                                                 rows=fuzz.SLOT_ROWS[3:4]),
              "presence": dict(rows=fuzz.SLOT_ROWS[0:1])}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(SLOT_CASES))
@pytest.mark.parametrize("types", [31, 15])   # ALL, ALL_NON_SPECULAR
def test_slot_kernels_match_plain(card, case, types):
    """K8 and K9 against slots.bsdf_sample / bsdf_eval_pdf on the card:
    elements within RTOL / ATOL, sampled kinds equal."""
    from arendur_tpu_torch.bxdf import slot_shade as ssh
    from arendur_tpu_torch.bxdf import slots as sl
    b, wo, u, wi = fuzz.fuzz_slots(fuzz.fuzz_slot_inputs(
        N, 9, **SLOT_CASES[case]), card)
    before = (ops.SLOT_SAMPLE.launches, ops.SLOT_EVAL_PDF.launches)
    got = ssh.bsdf_sample(b, wo, u, types) + ssh.bsdf_eval_pdf(b, wo, wi,
                                                               types)
    assert (ops.SLOT_SAMPLE.launches, ops.SLOT_EVAL_PDF.launches) == (
        before[0] + 1, before[1] + 1)
    ref = sl.bsdf_sample(b, wo, u, types) + sl.bsdf_eval_pdf(b, wo, wi,
                                                             types)
    assert torch.equal(got[3], ref[3])
    for g, r in zip(got[:3] + got[4:], ref[:3] + ref[4:]):
        close = torch.isclose(g, r, rtol=RTOL, atol=ATOL)
        assert close.float().mean().item() >= ELEM_GATE


def _bit_equal(a, b):
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


@pytest.mark.gpu
def test_slot_kernels_in_recipe_order_equal_plain(card):
    """K8 and K9 on a shuffled 65,536-lane mix of the five recipes: the
    BSDF's recipe order (built on the card by K8's first call) equals
    its plain twin, and every element equals the plain versions to the
    bit through the entries (K8 with a fresh order and with the order
    kept for the BSDF, K9 in wave order) and through K8's launch in the
    recipe order and in the identity order."""
    from arendur_tpu_torch.bxdf import slot_shade as ssh
    from arendur_tpu_torch.bxdf import slots as sl
    n = 1 << 16
    inp = fuzz.fuzz_slot_inputs(n, 21)
    inp["mat_id"] = np.random.RandomState(22).permutation(
        np.arange(n, dtype=np.int32) % len(fuzz.SLOT_ROWS))
    b, wo, u, wi = fuzz.fuzz_slots(inp, card)
    ref = sl.bsdf_sample(b, wo, u) + sl.bsdf_eval_pdf(b, wo, wi)
    before = ops.SLOT_ORDER.launches
    fresh = b.replace()
    got = ssh.bsdf_sample(fresh, wo, u) + ssh.bsdf_eval_pdf(fresh, wo, wi)
    again = ssh.bsdf_sample(fresh, wo, u) + ssh.bsdf_eval_pdf(fresh, wo, wi)
    assert ops.SLOT_ORDER.launches == before + 1
    order = ssh.ORDERS[fresh]
    assert torch.equal(order, ssh.lane_order_reference(b).to(card))
    identity = torch.arange(n, dtype=torch.int32, device=card)
    ordered = ops.slot_sample(b, wo, u, 31, order) \
        + ops.slot_eval_pdf(b, wo, wi, 31)
    wave = ops.slot_sample(b, wo, u, 31, identity)
    for outs in (got, again, ordered, wave):
        for g, r in zip(outs, ref):
            assert g.dtype == r.dtype and _bit_equal(g, r)


@pytest.mark.gpu
def test_slot_kernel_backward_is_the_plain_vjp(card):
    """The backward of K8 / K9 is autograd over their plain versions:
    the f and pdf cotangents flow, the sampled direction does not."""
    from arendur_tpu_torch.bxdf import slot_shade as ssh
    from arendur_tpu_torch.bxdf import slots as sl
    b, wo, u, wi = fuzz.fuzz_slots(fuzz.fuzz_slot_inputs(N, 10), card)
    rng = np.random.default_rng(11)
    ct = [torch.tensor(rng.normal(size=s).astype(np.float32), device=card)
          for s in ((N, 3), (N,))]
    for kern, plain, x in (
            (lambda bb, w: ssh.bsdf_sample(bb, w, u)[0::2],
             lambda bb, w: sl.bsdf_sample(bb, w, u)[0::2], u),
            (lambda bb, w: ssh.bsdf_eval_pdf(bb, w, wi),
             lambda bb, w: sl.bsdf_eval_pdf(bb, w, wi), wi)):
        grads = []
        for fn in (kern, plain):
            c0 = b.c0.clone().requires_grad_(True)
            w = wo.clone().requires_grad_(True)
            grads.append(torch.autograd.grad(fn(b.replace(c0=c0), w),
                                             (c0, w), ct))
        for g, r in zip(*grads):
            torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-6)
    assert not ssh.bsdf_sample(b.replace(c0=b.c0.requires_grad_(True)),
                               wo, u)[1].requires_grad


@pytest.mark.gpu
def test_composed_render_kernel_path_matches_plain_path(card):
    """cb_etex.json (emission-textured sphere lights) through K1, K2,
    K8 and K9 against the plain path; cb.json forced composed against
    its fused render."""
    scene, camera, film, config, _ = scenedesc.parse_scene(
        os.path.join(REPO, "examples/cornellbox/cb_etex.json"),
        spp_override=4, resolution_override=(24, 16))
    ds = sc.DeviceScene.build(scene, card)
    config = dataclasses.replace(config, max_depth=4)
    ops.reset_counts()
    img_k = integ.render(ds, camera, film, config)
    launches = ops.counts()
    img_p = integ.render(ds, camera, film, config, ops=integ.PLAIN_OPS)
    composed = ("closest_hit", "any_hit", "slot_sample", "slot_eval_pdf")
    assert min(launches[k] for k in composed) >= 1, launches
    assert launches["bounce_shade"] == launches["shade_split"] == 0
    assert torch.isfinite(img_k).all() and img_k.max() > 0.0
    torch.testing.assert_close(img_k, img_p, rtol=0.0, atol=PLAIN_ATOL)
    ds_cb, camera, film, config = _cornell_depth4(card)
    fused = integ.render(ds_cb, camera, film, config)
    forced = integ.render(ds_cb, camera, film, config, composed=True)
    torch.testing.assert_close(forced, fused, rtol=0.0, atol=2e-3)


def _cornell_depth4(card):
    scene, camera, film, config, _ = scenedesc.parse_scene(
        CB, spp_override=4, resolution_override=(24, 16))
    return (sc.DeviceScene.build(scene, card), camera, film,
            dataclasses.replace(config, max_depth=4))


@pytest.mark.gpu
def test_bounce_shade_kernel_serves_wide_tables(card):
    """K3 on a Cornell box with 45 material rows (the tables K7 serves
    on the TPU): against its plain version on fuzz lanes, and the
    render equal to the 9-row render."""
    scene, camera, film, config, _ = scenedesc.parse_scene(
        CB, spp_override=4, resolution_override=(24, 16))
    wide = sc.DeviceScene.build(fuzz.spread_materials(scene), card)
    assert wide.mtab.shape[0] == 45
    tabs = (wide.ltab, wide.mtab, wide.stab)
    x = torch.tensor(fuzz.fuzz_bounce_inputs(
        *(t.cpu().numpy() for t in tabs), seed=12, n=N).T.copy(),
        device=card)
    out = cb.bounce_shade_t(x, *tabs, wide.static, 4, 0.05)
    ref = cb.cbody_reference(x, *tabs, wide.static, 4, 0.05)
    close = torch.isclose(out, ref, rtol=RTOL, atol=ATOL) \
        | (torch.isnan(out) & torch.isnan(ref))
    assert close.float().mean().item() >= ELEM_GATE
    config = dataclasses.replace(config, max_depth=4)
    narrow = sc.DeviceScene.build(scene, card)
    torch.testing.assert_close(integ.render(wide, camera, film, config),
                               integ.render(narrow, camera, film, config),
                               rtol=0.0, atol=0.0)


@pytest.mark.gpu
@pytest.mark.parametrize("full_phi", [False, True])
def test_no_cluster_kernels_match_plain(card, full_phi):
    """K1 / K2 with no cluster (C = 0: an empty world pool) and a sphere
    table: the sphere branch alone, every live lane's code and blocked
    flag against the plain versions, no descriptor encoded."""
    ds, o, d, tmax = _sphere_rays(card, "cornell", 9)
    w0, c0 = ds.cw[:0].contiguous(), ds.cbox[:0].contiguous()
    na = torch.tensor(N - 1000, device=card)
    kw = dict(sph_tab=ds.ktab, full_phi=full_phi)
    encodes = ops.isect_encodes()
    t, s = ci.intersect_clusters(w0, c0, o, d, tmax, na, **kw)
    b = ci.occluded_clusters(w0, c0, o, d, tmax, na, **kw)
    assert ops.isect_encodes() == encodes
    t_p, s_p = ci.intersect_clusters_reference(w0, c0, o, d, tmax, na, **kw)
    b_p = ci.occluded_clusters_reference(w0, c0, o, d, tmax, na, **kw)
    assert torch.equal(s, s_p) and torch.equal(b, b_p)
    torch.testing.assert_close(t, t_p, rtol=T_RTOL, atol=0.0)
    assert (s[:N - 1000] <= -2).sum() > N // 8


@pytest.mark.gpu
@pytest.mark.parametrize("n_alive", [None, 3000])
def test_instanced_entries_match_plain_and_period_route(card, n_alive):
    """cb_inst.json's instanced mesh (100 instances): the instanced K1 /
    K2, one launch each over 4,096 world rays started across the grid
    (half of them bounded), the any hit from random world flags, against
    their plain versions (slots, instances and flags on >= SLOT_GATE of
    the lanes, t within T_RTOL where they agree) and against the earlier
    route (the [I * N]-lane launches with period N, then the nearest
    instance), which shares their cluster tests, on every lane to the
    bit."""
    scene, *_ = scenedesc.parse_scene(
        os.path.join(REPO, "examples/cornellbox/cb_inst.json"))
    ds = sc.DeviceScene.build(scene, card)
    im = ds.inst[0]
    n, ni = 4096, im.n_instances
    rng = np.random.default_rng(7)
    lo = im.itab[:, 12:15].amin(0).cpu().numpy()
    hi = im.itab[:, 15:18].amax(0).cpu().numpy()
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    f = lambda a: torch.tensor(a, dtype=torch.float32, device=card)  # noqa
    o, d = f(rng.uniform(lo, hi, (n, 3))), f(d)
    tmax = f(np.where(np.arange(n) % 2 == 0, np.inf,
                      rng.uniform(0.1, 20.0, n)))
    world = torch.tensor(rng.uniform(size=n) < 0.3, device=card)
    na = None if n_alive is None else torch.tensor(n_alive, device=card)
    live = torch.arange(n, device=card) < (n if n_alive is None
                                           else n_alive)
    tabs = (im.cw, im.cbox, im.itab)
    before = (ops.CLOSEST_HIT_INSTANCED.launches,
              ops.ANY_HIT_INSTANCED.launches)
    t, s, i = ci.intersect_instanced(*tabs, o, d, tmax, na)
    b = ci.occluded_instanced(*tabs, o, d, tmax, na, world)
    assert (ops.CLOSEST_HIT_INSTANCED.launches,
            ops.ANY_HIT_INSTANCED.launches) == (before[0] + 1,
                                                before[1] + 1)
    t_p, s_p, i_p = ci.intersect_instanced_reference(*tabs, o, d, tmax, na)
    b_p = ci.occluded_instanced_reference(*tabs, o, d, tmax, na, world)
    agree = (s == s_p) & (i == i_p)
    assert agree.float().mean().item() >= SLOT_GATE
    hit = agree & (s >= 0)
    torch.testing.assert_close(t[hit], t_p[hit], rtol=T_RTOL, atol=0.0)
    assert (b == b_p).float().mean().item() >= SLOT_GATE
    assert (s[~live] == -1).all() and not b[~live].any()
    assert (s >= 0).float().mean().item() > 0.3
    # the earlier route, every lane
    ol, dl = sc.instance_rays(im, o, d)
    t_f, s_f = ci.intersect_clusters(im.cw, im.cbox, ol, dl,
                                     tmax.repeat(ni), na, period=n)
    t_im = torch.where(s_f >= 0, t_f, float("inf")).reshape(ni, n)
    first = torch.argmin(t_im, 0)
    assert torch.equal(s_f.reshape(ni, n).gather(0, first[None])[0], s)
    assert torch.equal(first.int(), i)
    assert torch.equal(torch.where(s >= 0, t_im.gather(0, first[None])[0],
                                   tmax), t)
    b_f = ci.occluded_clusters(im.cw, im.cbox, ol, dl, tmax.repeat(ni), na,
                               period=n).reshape(ni, n).any(0)
    assert torch.equal(b_f | (world & live), b)


@pytest.mark.gpu
def test_instanced_render_kernel_path_matches_plain_path(card):
    """cb_inst.json (100 instances of the Cornell box, 200 spheres, an
    empty world pool) at 24x16, 2 spp, depth 3: the kernel path, whose
    instanced queries launch the instanced K1 / K2, against the plain
    path."""
    scene, camera, film, config, _ = scenedesc.parse_scene(
        os.path.join(REPO, "examples/cornellbox/cb_inst.json"),
        spp_override=2, resolution_override=(24, 16))
    ds = sc.DeviceScene.build(scene, card)
    config = dataclasses.replace(config, max_depth=3)
    ops.reset_counts()
    img_k = integ.render(ds, camera, film, config)
    launches = ops.counts()
    img_p = integ.render(ds, camera, film, config, ops=integ.PLAIN_OPS)
    for k in ("closest_hit_instanced", "any_hit_instanced", "bounce_shade"):
        assert launches[k] >= 1, launches
    assert torch.isfinite(img_k).all() and img_k.max() > 0.05
    torch.testing.assert_close(img_k, img_p, rtol=0.0, atol=PLAIN_ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("renderer", ["bpt", "whitted"])
def test_bpt_and_whitted_kernel_path_matches_plain_path(card, renderer):
    """cb.json at 16x12, 4 spp (BPT at depth 3) through K1, K2, K8 and K9
    (Whitted: K1, K2 and K9) against the plain path; no bounce shade
    launches."""
    from arendur_tpu_torch.render import bpt, whitted
    scene, camera, film, config, _ = scenedesc.parse_scene(
        CB, spp_override=4, resolution_override=(16, 12))
    ds = sc.DeviceScene.build(scene, card)
    config = dataclasses.replace(config, max_depth=3)
    render = bpt.render_bpt if renderer == "bpt" else whitted.render_whitted
    ops.reset_counts()
    img_k = render(ds, camera, film, config)
    launches = ops.counts()
    img_p = render(ds, camera, film, config, ops=integ.PLAIN_OPS)
    used = ("closest_hit", "any_hit", "closest_hit_spheres",
            "any_hit_spheres", "slot_eval_pdf") \
        + (("slot_sample",) if renderer == "bpt" else ())
    assert min(launches[k] for k in used) >= 1, launches
    assert launches["bounce_shade"] == launches["hit_shade"] \
        == launches["shade_split"] == 0
    assert torch.isfinite(img_k).all() and img_k.max() > 0.0
    torch.testing.assert_close(img_k, img_p, rtol=0.0, atol=PLAIN_ATOL)


@pytest.mark.gpu
def test_bpt_wave_sets_kernels_match_plain(card):
    """One BPT wave's own K1 / K2 queries (the light walk's
    sphere-started first query among them), BSDF samples and fused
    evaluations (render/fuzz.py bpt_wave_sets) at 4,096 lanes, depth 4:
    K1 / K2 against their plain versions (SLOT_GATE), K8 / K9 equal to
    theirs to the bit."""
    from arendur_tpu_torch.bxdf import slots as sl
    scene, camera, film, config, _ = scenedesc.parse_scene(
        CB, spp_override=4, resolution_override=(32, 32))
    ds = sc.DeviceScene.build(scene, card)
    config = dataclasses.replace(config, max_depth=4, wave_size=4096)
    sets = fuzz.bpt_wave_sets(ds, camera, film, config, integ.KERNEL_OPS)
    assert any(q["tag"] == "light walk 0" for q in sets["queries"])
    for q in sets["queries"]:
        args = (ds.cw, ds.cbox, q["o"], q["d"], q["tmax"], q["n_alive"],
                q["period"], q["sph_tab"], q["full_phi"])
        if q["kind"] == "closest":
            _, s_p = ci.intersect_clusters_reference(*args)
            agree = (q["slot"] == s_p).float().mean().item()
        else:
            agree = (q["blocked"] == ci.occluded_clusters_reference(*args)) \
                .float().mean().item()
        assert agree >= SLOT_GATE, (q["tag"], agree)
    same = lambda a, b: bool(((a == b) | (a.isnan() & b.isnan()))  # noqa
                             .all())
    for rec in sets["samples"]:
        ref = sl.bsdf_sample(rec["b"], rec["wo"], rec["u"], rec["types"])
        assert all(same(a.float(), b.float())
                   for a, b in zip(rec["out"], ref))
    for rec in sets["evals"]:
        ref = sl.bsdf_eval_pdf(rec["b"], rec["wo"], rec["wi"], rec["types"])
        assert all(same(a, b) for a, b in zip(rec["out"], ref))


@pytest.mark.gpu
@pytest.mark.parametrize("intersector", ["bvh", "naive"])
def test_world_intersectors_on_the_card(card, cornell, intersector):
    """The BVH walk and the brute force (plain PyTorch on the card) give
    on CUDA tensors what they give on the CPU, and agree with K1 on the
    triangle (past K1's self-hit guard) and within T_RTOL in t."""
    scene = scenedesc.parse_scene(CB, spp_override=4,
                                  resolution_override=(24, 16),
                                  intersector=intersector)[0]
    ds_x = sc.DeviceScene.build(scene, card)
    ds_c = sc.DeviceScene.build(scene, "cpu")
    o, d, tmax = _rays(card)
    t, idx, b0, b1 = sc.world_closest(ds_x, o, d, tmax)
    t_c, idx_c, b0_c, b1_c = sc.world_closest(ds_c, o.cpu(), d.cpu(),
                                              tmax.cpu())
    assert torch.equal(idx.cpu(), idx_c)
    hit = idx_c >= 0
    torch.testing.assert_close(t.cpu()[hit], t_c[hit], rtol=1e-6, atol=0.0)
    torch.testing.assert_close(b0.cpu()[hit], b0_c[hit], rtol=0.0,
                               atol=1e-6)
    k1_t, slot = ops.closest_hit(cornell[0].cw, cornell[0].cbox, o, d, tmax)
    k1_idx = torch.where(slot >= 0, cornell[0].remap[slot.clamp(min=0)
                                                     .long()], -1)
    teps = 1e-5 * (1.0 + o.abs().amax(-1))
    same = (k1_idx == idx) | (t <= teps)
    assert same.float().mean().item() >= SLOT_GATE
    both = (k1_idx == idx) & (idx >= 0)
    rel = (t - k1_t).abs() / k1_t.abs().clamp(min=1.0)
    assert rel[both].max().item() <= T_RTOL
    blocked = sc.world_occluded(ds_x, o, d, tmax)
    assert torch.equal(blocked.cpu(), sc.world_occluded(
        ds_c, o.cpu(), d.cpu(), tmax.cpu()))


@pytest.mark.gpu
def test_composed_train_step_kernels_match_plain(card):
    """One train step on cb_etex.json (the composed bounce: K1, K2, K8,
    K9) through the kernels against the plain path: the gradients of kd,
    ks and roughness within GRAD_GATE, all finite."""
    from arendur_tpu_torch.parallel import mesh
    scene, camera, film, config, _ = scenedesc.parse_scene(
        os.path.join(REPO, "examples/cornellbox/cb_etex.json"),
        spp_override=4, resolution_override=(24, 16))
    config = dataclasses.replace(config, max_depth=4, wave_size=24 * 16 * 4)
    ds = sc.DeviceScene.build(scene, card)
    assert ds.composed_only
    p = {k: torch.tensor(getattr(scene.materials, k), device=card)
         for k in ("kd", "ks", "roughness")}
    target = torch.full((24 * 16, 3), 0.2, device=card)
    idx = torch.arange(24 * 16 * 4, device=card)
    grads = {}
    for name, wops in (("kernels", integ.KERNEL_OPS),
                       ("plain", integ.PLAIN_OPS)):
        before = ops.SLOT_SAMPLE.launches
        step = mesh.train_step_fn(ds, camera, film, config, lr=GRAD_LR,
                                  ops=wops)
        new, _ = step(dict(p), target, idx)
        assert (ops.SLOT_SAMPLE.launches > before) == (name == "kernels")
        grads[name] = {k: (p[k] - new[k]) / GRAD_LR for k in p}
    for k in p:
        g, g_p = grads["kernels"][k], grads["plain"][k]
        assert torch.isfinite(g).all() and torch.isfinite(g_p).all()
        assert ((g - g_p).norm() / g_p.norm().clamp(min=1e-30)).item() \
            <= GRAD_GATE


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(SLOT_CASES))
def test_two_sweeps_run_k9(card, case, monkeypatch):
    """slots.bsdf_evaluate / bsdf_pdf on CUDA tensors launch K9 (one
    launch each) and agree with the same sweeps over the plain fused
    sweep: elements within RTOL / ATOL, kinds equal."""
    from arendur_tpu_torch.bxdf import slot_shade as ssh
    from arendur_tpu_torch.bxdf import slots as sl
    b, wo, _, wi = fuzz.fuzz_slots(fuzz.fuzz_slot_inputs(
        N, 12, **SLOT_CASES[case]), card)
    before = ops.SLOT_EVAL_PDF.launches
    got = sl.bsdf_evaluate(b, wo, wi) + (sl.bsdf_pdf(b, wo, wi),)
    assert ops.SLOT_EVAL_PDF.launches == before + 2
    monkeypatch.setattr(ssh, "bsdf_eval_pdf", sl.bsdf_eval_pdf)
    ref = sl.bsdf_evaluate(b, wo, wi) + (sl.bsdf_pdf(b, wo, wi),)
    assert ops.SLOT_EVAL_PDF.launches == before + 2
    assert torch.equal(got[1], ref[1])
    for g, r in ((got[0], ref[0]), (got[2], ref[2])):
        close = torch.isclose(g, r, rtol=RTOL, atol=ATOL)
        assert close.float().mean().item() >= ELEM_GATE


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(SLOT_CASES))
def test_rho_runs_k8(card, case, monkeypatch):
    """slots.rho_hd / rho_hh on CUDA tensors launch K8 once a sample and
    agree with the same estimators over the plain sample sweep."""
    from arendur_tpu_torch.bxdf import slot_shade as ssh
    from arendur_tpu_torch.bxdf import slots as sl
    b, wo, _, _ = fuzz.fuzz_slots(fuzz.fuzz_slot_inputs(
        N, 13, **SLOT_CASES[case]), card)
    rng = np.random.default_rng(14)
    s, s1, s2 = (torch.tensor(rng.random((4, N, 2)).astype(np.float32),
                              device=card) for _ in range(3))
    before = ops.SLOT_SAMPLE.launches
    got = (sl.rho_hd(b, wo, s), sl.rho_hh(b, s1, s2))
    assert ops.SLOT_SAMPLE.launches == before + 8
    monkeypatch.setattr(ssh, "bsdf_sample", sl.bsdf_sample)
    ref = (sl.rho_hd(b, wo, s), sl.rho_hh(b, s1, s2))
    assert ops.SLOT_SAMPLE.launches == before + 8
    for g, r in zip(got, ref):
        assert torch.isfinite(g).all()
        close = torch.isclose(g, r, rtol=RTOL, atol=ATOL)
        assert close.float().mean().item() >= ELEM_GATE


@pytest.mark.gpu
def test_sharded_paths_one_rank_on_the_card(card, cornell, tmp_path):
    """render_sharded and sharded_train_step_fn in a one-rank NCCL group
    against the one-device render and train_step_fn (K1-K4).  The steps
    run under PyTorch's deterministic algorithms: the scatter splat's
    index_add_ otherwise sums with atomics, in another order each run
    (one-device steps differ by ~2e-5 from each other, chip_smoke.py
    phase 18)."""
    import torch.distributed as dist
    from arendur_tpu_torch.parallel import distributed as pdist
    from arendur_tpu_torch.parallel import mesh
    ds, camera, film, config = cornell
    m = pdist.init_distributed(num_processes=1, process_id=0,
                               init_method="file://" + str(tmp_path / "rdv"),
                               device=card, timeout_s=120)
    try:
        assert dist.get_backend() == "nccl" and m.size == 1
        img = mesh.render_sharded(ds, camera, film, config, m)
        ref = integ.render(ds, camera, film, config)
        torch.testing.assert_close(img, ref, rtol=1e-4, atol=1e-5)
        w, h = film.resolution
        p = {k: torch.tensor(getattr(ds.materials, k), device=card)
             for k in ("kd", "ks", "roughness")}
        target = torch.full((w * h, 3), 0.2, device=card)
        idx = torch.arange(w * h * config.spp, device=card)
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            a, la = mesh.sharded_train_step_fn(
                ds, camera, film, config, m, lr=GRAD_LR)(dict(p), target,
                                                         idx)
            b, lb = mesh.train_step_fn(ds, camera, film, config,
                                       lr=GRAD_LR)(dict(p), target, idx)
        finally:
            torch.use_deterministic_algorithms(False)
        assert abs(la.item() - lb.item()) <= 1e-5 * abs(lb.item())
        for k in p:
            g, g1 = (p[k] - a[k]) / GRAD_LR, (p[k] - b[k]) / GRAD_LR
            assert ((g - g1).norm() / g1.norm().clamp(min=1e-30)).item() \
                <= 1e-5
    finally:
        dist.destroy_process_group()
