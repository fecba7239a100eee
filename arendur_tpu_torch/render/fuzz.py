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
tests/test_cbounce.py, for the same table shapes);
``fuzz_split_inputs`` turns such rows into the hit and shade inputs of
the textured split.

``checker_textured`` puts bench.py's checkerboard kd texture on every
matte material of a scene (the textured render's measured cell).

``fuzz_slot_inputs`` draws the slot-sweep inputs of the JAX package's
tests/test_pallas_shade.py (its five material recipes, optionally
grazing wo for total internal reflection); ``fuzz_slots`` turns them
into a port BsdfSlots on a device.

``sphere_rays`` draws world rays that exercise the intersect kernels'
sphere branch (camera-like and secondary rays, rays aimed at the
spheres, rays started on a sphere's surface or inside it, grazing
rays).

``train_step_bounces`` records the bounce shade's inputs and output
cotangents in one train step: the bounce-shade backward's real inputs.

``tie_set`` builds the intersect kernels' tie cases (equal t across
slots, clusters and spheres, rays past n_alive) with exact arithmetic.

``wave_queries`` records the closest-hit and any-hit queries of one
wave (K1 / K2's main-path inputs) and their results.
``bpt_wave_sets`` records one BPT wave's K1 / K2 queries (tagged by
walk step and strategy), its BSDF samples (K8) and its fused evaluate +
pdf calls (K9); ``bpt_light_rays`` draws the light subpaths' first
rays, started just off a light's surface.

``spread_materials`` copies each material row of a scene several times
and spreads the triangles and spheres over the copies: the tables grow
past 32 rows (the JAX package's fused-kernel cap) and the image stays
the same.
"""

from __future__ import annotations

import dataclasses

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


def train_step_bounces(ds, camera, film_cfg, config, ops, target, ray_idx):
    """The bounce-shade backward's inputs of every bounce of one train
    step (parallel/mesh.py, kd only, kd at 1.25x the scene's) of the wave
    ray_idx against target [H*W, 3] through ops (a WaveOps of
    render/integrator.py), on ds's device: per bounce, in order, a dict
    of the fused bounce shade's input "xt", tables "ltab", "mtab",
    "stab" (detached), live count "n_alive" (a device scalar or None)
    and its output's cotangent "ct" [OUT_COLS, N]."""
    import torch
    from arendur_tpu_torch.parallel import mesh
    bounces = []

    def bounce_shade(xt, ltab, mtab, stab, static, min_depth, rr_threshold,
                     n_alive=None):
        args = (xt, ltab, mtab, stab, static, min_depth, rr_threshold)
        # (a checkout whose wave hands the shade no live count calls
        # entries that take none)
        out = ops.bounce_shade(*args) if n_alive is None \
            else ops.bounce_shade(*args, n_alive=n_alive)
        rec = dict(xt=xt.detach(), ltab=ltab.detach(), mtab=mtab.detach(),
                   stab=stab.detach(),
                   n_alive=None if n_alive is None else n_alive.clone())
        bounces.append(rec)
        out.register_hook(lambda g: rec.update(ct=g.detach()))
        return out

    wops = dataclasses.replace(ops, bounce_shade=bounce_shade)
    kd = torch.tensor(ds.materials.kd, device=ds.device) * 1.25
    mesh.train_step_fn(ds, camera, film_cfg, config, ops=wops)(
        kd, target, ray_idx)
    return bounces


def fuzz_split_inputs(ltab, mtab, stab, seed: int = 0, n: int = 2048,
                      atlas=None, hit=None, tex_present=None):
    """The textured split's inputs from fuzz rows, on the tables' device:
    (hit input [HIT_IN_COLS, n], shade input [SHADE_IN_COLS, n], fused
    input [IN_COLS, n]).  The hit input is columns 0:39 of
    ``fuzz_bounce_inputs`` and a seeded cone width and spread; the shade
    input packs hit(hit input, stab) (the plain hit body by default),
    the material columns resolve_params gives over `atlas`, and the fuzz
    path state, as the integrator packs them."""
    import torch
    from arendur_tpu_torch import materials as mats
    from arendur_tpu_torch.render import cbounce as cb
    from arendur_tpu_torch.render import integrator as integ
    dev = ltab.device
    x = torch.tensor(fuzz_bounce_inputs(
        *(t.cpu().numpy() for t in (ltab, mtab, stab)), seed=seed, n=n),
        device=dev)
    rng = np.random.default_rng(seed + 100)
    cone = lambda hi: torch.tensor(rng.uniform(0.0, hi, n),
                                   dtype=torch.float32, device=dev)
    carry = dict(o=x[:, 0:3], d=x[:, 3:6], cone_w=cone(0.02),
                 cone_g=cone(4e-3), beta=x[:, 39:42], L=x[:, 42:45],
                 specular=x[:, 45] > 0.5, sel_prev=x[:, 46],
                 wb_prev=x[:, 47], nee_prev=x[:, 48] > 0.5,
                 alive=x[:, 49] > 0.5)
    raw = dict(t=x[:, 6], hit=x[:, 7] > 0.5, is_sphere=x[:, 8] > 0.5,
               s_idx=x[:, 9], p_local=x[:, 10:13], trow=x[:, 13:39])
    xh = integ.pack_hit_input(carry, raw)
    hi = cb.unpack_hit_t((hit or cb.cbody_hit_reference)(xh, stab))
    res = mats.resolve_params(
        mtab, hi["mat_id"], hi["ns"], hi["ng"], hi["dpdu"], uv=hi["uv"],
        textures=atlas, dpdv=hi["dpdv"], duvdx=hi["duvdx"],
        duvdy=hi["duvdy"], tex_present=tex_present)
    xs = integ.pack_shade_input(carry, raw, hi, res, x[:, 50], x[:, 51],
                                x[:, 52:54], x[:, 54:56], x[:, 56], 0)
    xs[cb.S_BOUNCE] = x[:, 57]
    return xh, xs, x.T.contiguous()


def _trace(ds, camera, film_cfg, config, ops, wave: int):
    """trace_wave of wave `wave` of a render (as render() cuts the waves
    of config.wave_size rays) through ops, without gradients."""
    import torch
    from arendur_tpu_torch.render import integrator as integ
    from arendur_tpu_torch.sampling import sampler as smp
    w = film_cfg.resolution[0]
    ray_idx = wave * config.wave_size + torch.arange(
        config.wave_size, dtype=torch.int64, device=ds.device)
    pid = ray_idx // config.spp
    pxy = torch.stack([(pid % w).to(torch.float32),
                       (pid // w).to(torch.float32)], -1)
    with torch.no_grad():
        integ.trace_wave(ds, camera, config, pxy, pid, ray_idx % config.spp,
                         smp.make_base_key(config.seed), ops=ops)


def wave_shades(ds, camera, film_cfg, config, ops, wave: int = 0):
    """The bounce shades of wave `wave` of a render through ops (a WaveOps
    of render/integrator.py): the fused bounce shade's calls (K3), or
    the split shade's (K6) where config carries textures.  Per bounce,
    in order, a dict of its input "xt", the live count "n_alive" it was
    handed (a device scalar, or None) and its output "out"."""
    shades = []
    textured = config.textures is not None
    entry = ops.shade_split if textured else ops.bounce_shade

    def record(xt, *args, n_alive=None):
        out = entry(xt, *args) if n_alive is None \
            else entry(xt, *args, n_alive=n_alive)
        shades.append(dict(xt=xt.detach().clone(),
                           n_alive=None if n_alive is None
                           else n_alive.clone(), out=out.detach().clone()))
        return out

    wops = dataclasses.replace(
        ops, **{"shade_split" if textured else "bounce_shade": record})
    _trace(ds, camera, film_cfg, config, wops, wave)
    return shades


def _query_recorder(queries: list, kind: str, fn):
    """A closest_hit / any_hit entry that calls fn and appends the query
    to `queries` (the dicts of wave_queries)."""
    def call(w_clusters, cbox, o, d, tmax, n_alive=None, period=0,
             sph_tab=None, full_phi=False):
        out = fn(w_clusters, cbox, o, d, tmax, n_alive, period, sph_tab,
                 full_phi)
        q = dict(kind=kind, o=o.detach().clone(), d=d.detach().clone(),
                 tmax=tmax.detach().clone(),
                 n_alive=None if n_alive is None else n_alive.clone(),
                 period=period, sph_tab=sph_tab, full_phi=full_phi)
        if kind == "closest":
            q.update(t=out[0].clone(), slot=out[1].clone())
        else:
            q.update(blocked=out.clone())
        queries.append(q)
        return out
    return call


def _instanced_recorder(queries: list, kind: str, fn):
    """A closest_hit_instanced / any_hit_instanced entry that calls fn
    and appends the query to `queries`: kind "closest_instanced" or
    "any_instanced", the mesh's tables "w", "cbox", "itab", the world
    rays "o", "d", "tmax" (the bound of a closest hit), "n_alive",
    "blocked_in" (any hit: the flags it starts from), and the result:
    "t", "slot" and "inst", or "blocked"."""
    def call(w_clusters, cbox, itab, o, d, tmax, n_alive=None,
             blocked=None):
        args = (w_clusters, cbox, itab, o, d, tmax, n_alive)
        out = fn(*args) if kind == "closest_instanced" \
            else fn(*args, blocked)
        q = dict(kind=kind, w=w_clusters, cbox=cbox, itab=itab,
                 o=o.detach().clone(), d=d.detach().clone(),
                 tmax=tmax.detach().clone(),
                 n_alive=None if n_alive is None else n_alive.clone(),
                 blocked_in=None if blocked is None else blocked.clone())
        if kind == "closest_instanced":
            q.update(t=out[0].clone(), slot=out[1].clone(),
                     inst=out[2].clone())
        else:
            q.update(blocked=out.clone())
        queries.append(q)
        return out
    return call


def _recording(ops, queries: list, **more):
    """ops with its four scene-query entries recording into `queries`."""
    return dataclasses.replace(
        ops, closest_hit=_query_recorder(queries, "closest", ops.closest_hit),
        any_hit=_query_recorder(queries, "any", ops.any_hit),
        closest_hit_instanced=_instanced_recorder(
            queries, "closest_instanced", ops.closest_hit_instanced),
        any_hit_instanced=_instanced_recorder(
            queries, "any_instanced", ops.any_hit_instanced), **more)


def wave_queries(ds, camera, film_cfg, config, ops, wave: int = 0):
    """The closest-hit and any-hit queries of wave `wave` of a render
    (render/integrator.py trace_wave, as render() cuts the waves of
    config.wave_size rays) through ops, a WaveOps whose closest_hit /
    any_hit are wrapped to record them: per query, in call order (a
    depth-8 fused wave: 8 closest, 8 any and the final closest), a dict
    of "kind" ("closest" or "any"), the arguments "o", "d", "tmax",
    "n_alive" (a device scalar or None), "period", "sph_tab" and
    "full_phi", and the result: "t" and "slot", or "blocked".  A scene
    with instanced meshes adds, after each world query, one query per
    mesh of kind "closest_instanced" / "any_instanced"
    (_instanced_recorder)."""
    queries = []
    _trace(ds, camera, film_cfg, config, _recording(ops, queries), wave)
    return queries


def bpt_wave_sets(ds, camera, film_cfg, config, ops, wave: int = 0):
    """What BPT's kernels see in wave `wave` of a render_bpt (render/
    bpt.py, as it cuts the waves of config.wave_size rays) through ops:
    dict(queries: the closest-hit and any-hit queries in call order (the
    dicts of wave_queries, each with its "tag": "camera walk i" and
    "light walk i" for the walks' max_depth + 1 and max_depth closest
    hits, "s{s} t{t}" for the shadow rays of the (s >= 1, t >= 2)
    connections in the wave's loop order, then of the t = 1 lens
    rays; an instanced mesh's queries, kinds "closest_instanced" and
    "any_instanced", carry their world query's tag),
    samples: the BSDF samples (K8) of the walks' vertices, evals: the
    fused evaluate + pdf calls (K9): walk reverse densities, connections'
    f, MIS densities; each a dict of the BsdfSlots "b", "wo", "u" or
    "wi", "types" and the result "out")."""
    import torch
    from arendur_tpu_torch.render import bpt
    from arendur_tpu_torch.sampling import sampler as smp
    queries, samples, evals = [], [], []

    def sample(b, wo, u, types):
        out = ops.bsdf_sample(b, wo, u, types)
        samples.append(dict(b=b, wo=wo, u=u, types=types, out=out))
        return out

    def eval_pdf(b, wo, wi, types):
        out = ops.bsdf_eval_pdf(b, wo, wi, types)
        evals.append(dict(b=b, wo=wo, wi=wi, types=types, out=out))
        return out

    wops = _recording(ops, queries, bsdf_sample=sample,
                      bsdf_eval_pdf=eval_pdf)
    w = film_cfg.resolution[0]
    ray_idx = wave * config.wave_size + torch.arange(
        config.wave_size, dtype=torch.int64, device=ds.device)
    pid = ray_idx // config.spp
    pxy = torch.stack([(pid % w).to(torch.float32),
                       (pid // w).to(torch.float32)], -1)
    with torch.no_grad():
        bpt.trace_wave_bpt(ds, camera, config, film_cfg, pxy, pid,
                           ray_idx % config.spp,
                           smp.make_base_key(config.seed), ops=wops)
    depth = config.max_depth
    tags = dict(
        closest=[f"camera walk {i}" for i in range(depth + 1)]
        + [f"light walk {i}" for i in range(depth)],
        any=[f"s{s} t{t}" for t in range(2, depth + 3)
             for s in range(1, depth + 2) if s + t <= depth + 2]
        + [f"s{s} t1" for s in range(2, depth + 2)])
    seen, last = {"closest": 0, "any": 0}, None
    for q in queries:
        if q["kind"].endswith("_instanced"):
            q["tag"] = f"{last} instanced"
            continue
        last = q["tag"] = tags[q["kind"]][seen[q["kind"]]]
        seen[q["kind"]] += 1
    return dict(queries=queries, samples=samples, evals=evals)


def bpt_light_rays(ds, n: int = 4096, seed: int = 0, textures=None):
    """The first rays of n BPT light subpaths on ds (render/bpt.py): a
    light picked by power, an emitted ray (lighting/emission.py
    generate_path) from seeded uniforms, started 1e-4 off an area
    light's surface.  Returns (o, d, tmax) on ds's device; on a sphere
    light the closest hit's quadratic is ill-conditioned there."""
    import torch
    from arendur_tpu_torch import scene as sc
    from arendur_tpu_torch.lighting import emission as emi
    from arendur_tpu_torch.sampling import distribution
    rng = np.random.default_rng(seed)
    u = lambda *shape: torch.tensor(rng.uniform(size=shape),  # noqa: E731
                                    dtype=torch.float32, device=ds.device)
    lidx, _ = distribution.sample_discrete(ds.light_distribution, u(n))
    gp = emi.generate_path(ds, lidx, u(n, 2), u(n, 2), textures=textures)
    lt = ds.ltab[lidx, dict(ds.static.lcidx)["ltype"][0]]
    area = (lt == sc.L_AREA_SPHERE) | (lt == sc.L_AREA_TRI)
    o = gp["pos"] + gp["n"] * 1e-4 * area.float()[:, None]
    return o, gp["dir"], torch.full((n,), float("inf"), device=ds.device)


TIE_K, TIE_C = 64, 3


def _sphere_row(center, radius):
    """A sphere.kernel_table row of a full sphere at center."""
    m = np.eye(4, dtype=np.float32)
    m[3, :3] = -np.asarray(center, np.float32)
    return np.concatenate([m.reshape(16), [radius, -radius, radius,
                                           2 * np.pi, 0, 0, 0, 0]])


def tie_set():
    """The intersect kernels' tie set, NumPy, with exact arithmetic on
    its crafted rays (small integer and half-integer coordinates, axis
    directions): 3 clusters of K = 64 slots (a backdrop triangle in each
    holds every crafted ray's x, y strictly inside the cluster boxes, so
    no slab test decides a tie) with a triangle duplicated within a
    cluster and across two, a quad split along its diagonal within a
    cluster and across two, a triangle at a sphere's pole; a table of
    three spheres, the last two equal; each crafted ray with tmax inf,
    at its first hit's t and past it, 64 random rays, and 16 rays past
    n_alive.  Returns (w [3,16,256], cbox [3,8], ktab [3,24], o, d,
    tmax, n_alive, the slot expected with the table, the slot expected
    without; None for the random rays)."""
    from arendur_tpu_torch.shapes import mxu_intersect as mxi
    tris = np.zeros((TIE_C * TIE_K, 3, 3), np.float32)
    quad = lambda x, y, z: ([(x, y, z), (x + 2, y, z), (x + 2, y + 2, z)],
                            [(x, y, z), (x + 2, y + 2, z), (x, y + 2, z)])
    a = [(-1, -1, 4), (3, -1, 4), (-1, 3, 4)]
    tris[5] = tris[7] = tris[TIE_K + 3] = a          # duplicates of A
    tris[10], tris[11] = quad(10, 0, 6)              # diagonal in cluster 0
    tris[12] = [(19, -1, 9), (23, -1, 9), (19, 3, 9)]  # at sphere 0's pole
    tris[13], tris[TIE_K + 6] = quad(40, 0, 8)       # split across clusters
    tris[2 * TIE_K + 9] = [(28, -2, 12), (33, -2, 12), (28, 3, 12)]
    for c in range(TIE_C):
        tris[c * TIE_K + 60] = [(-100, -100, 50), (300, -100, 50),
                                (-100, 300, 50)]
    w = mxi.pack_chunks(tris[:, 0], tris[:, 1], tris[:, 2], chunk=TIE_K)
    cbox = np.zeros((TIE_C, 8), np.float32)
    for c in range(TIE_C):
        pts = tris[c * TIE_K:(c + 1) * TIE_K]
        pts = pts[np.abs(pts).sum((1, 2)) > 0].reshape(-1, 3)
        cbox[c, :3], cbox[c, 3:6] = pts.min(0), pts.max(0)
    ktab = np.stack([_sphere_row((20, 0, 10), 1), _sphere_row((30, 0, 10), 1),
                     _sphere_row((30, 0, 10), 1)]).astype(np.float32)
    up, down = (0, 0, 1), (0, 0, -1)
    # (origin, direction, (t, slot) with the table, (t, slot) without;
    # t None: a miss); each ray with tmax inf, at the first hit's t and
    # past it
    geo = [((0, 0, 0), up, (4.0, 5), (4.0, 5)),         # A thrice
           ((11, 1, 0), up, (6.0, 10), (6.0, 10)),      # on the diagonal
           ((12, 2, 0), up, (6.0, 10), (6.0, 10)),      # the shared vertex
           ((10.5, 1.5, 0), up, (6.0, 11), (6.0, 11)),  # the upper half
           ((20, 0, 0), up, (9.0, -2), (9.0, 12)),      # sphere 0 = slot 12
           ((30, 0, 0), up, (9.0, -3), (12.0, 2 * TIE_K + 9)),  # 1 = 2
           ((41, 1, 0), up, (8.0, 13), (8.0, 13)),      # across clusters
           ((40.5, 1.5, 0), up, (8.0, TIE_K + 6), (8.0, TIE_K + 6)),
           ((5, 5, 0), up, (50.0, 60), (50.0, 60)),     # the backdrops
           ((0, 0, 0), down, (None, -1), (None, -1))]   # a miss
    o, d, tmax, want, want_ns = [], [], [], [], []
    for org, dr, (t, s_tab), (t_ns, s_ns) in geo:
        for tm in ((np.inf,) if t is None else (np.inf, t, t + 0.5)):
            o.append(org)
            d.append(dr)
            tmax.append(tm)
            want.append(s_tab if t is not None and t < tm else -1)
            want_ns.append(s_ns if t_ns is not None and t_ns < tm else -1)
    rng = np.random.default_rng(3)
    k = 64
    o += list(rng.uniform([-5, -5, 0], [45, 5, 3], (k, 3)))
    dr = rng.normal(size=(k, 3)) + [0, 0, 2]
    d += list(dr / np.linalg.norm(dr, axis=-1, keepdims=True))
    tmax += list(np.where(np.arange(k) % 2, np.inf, rng.uniform(2, 20, k)))
    want += [None] * k
    want_ns += [None] * k
    n_alive = len(o)
    # rays past n_alive: copies of the first rays
    o += o[:16]
    d += d[:16]
    tmax += tmax[:16]
    want += [-1] * 16
    want_ns += [-1] * 16
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return (w, cbox, ktab, f32(o), f32(d), f32(tmax), n_alive, want,
            want_ns)


def checker_image(size: int = 256, cell: int = 16) -> np.ndarray:
    """bench.py's checkerboard [size, size, 3]: texels
    (0.8 c + 0.1, 0.5 c + 0.2, 0.6), c in {0, 1} alternating every
    `cell` texels."""
    ch = (np.indices((size, size)).sum(0) // cell % 2).astype(np.float32)
    return np.stack([ch * 0.8 + 0.1, ch * 0.5 + 0.2,
                     np.full_like(ch, 0.6)], -1)


def checker_textured(scene, device="cpu"):
    """bench.py's textured leg on a port SceneData: the checkerboard
    (wrap repeat, no gamma) as the kd texture of every matte material.
    Returns (scene, atlas on device)."""
    import dataclasses
    from arendur_tpu_torch.texturing.texture import AtlasBuilder
    ab = AtlasBuilder()
    tid = ab.add_image(checker_image())
    m = scene.materials
    kd_tex = np.where(np.asarray(m.mtype) == 0, tid,
                      np.asarray(m.kd_tex)).astype(np.int32)
    return (dataclasses.replace(scene, materials=dataclasses.replace(
        m, kd_tex=kd_tex)), ab.build(device))


# the five recipes of tests/test_pallas_shade.py: matte Lambert, matte
# Oren-Nayar, plastic (Ashikhmin-Shirley, Beckmann), three-slot glass,
# translucent (Ashikhmin-Shirley + Lambert transmission)
SLOT_ROWS = (
    dict(mtype=0, kd=(.5, .4, .3)),
    dict(mtype=0, kd=(.6, .6, .2), sigma=20.0),
    dict(mtype=1, kd=(.4, .2, .1), ks=(.5, .5, .5), roughness=500.0),
    dict(mtype=2, kd=(.9, .9, .9), ks=(1., 1., 1.), eta=1.5,
         roughness=200.0),
    dict(mtype=3, kd=(.5, .5, .5), ks=(.3, .3, .3), dissolve=0.5,
         roughness=300.0),
)


def _unit32(v):
    v = v.astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def fuzz_slot_inputs(n: int = 1024, seed: int = 0, rows=SLOT_ROWS,
                     grazing: bool = False) -> dict:
    """NumPy inputs of the slot sweeps, drawn in the order of the JAX
    package's _mixed_bsdf fixture: material rows, mat_id [n] int32,
    ns [n,3] (also the geometric normal), dpdu, wo [n,3], u [n,2] and a
    second direction wi [n,3] (float32).  grazing pushes wo nearly into
    the surface plane (total internal reflection on glass lanes)."""
    rng = np.random.RandomState(seed)
    mat_id = rng.randint(0, len(rows), n).astype(np.int32)
    ns = _unit32(rng.normal(size=(n, 3)))
    dpdu = rng.normal(size=(n, 3)).astype(np.float32)
    wo = rng.normal(size=(n, 3)).astype(np.float32)
    if grazing:
        wo = wo - ns * (wo * ns).sum(-1, keepdims=True) * np.float32(0.995)
    wo = _unit32(wo)
    u = rng.uniform(size=(n, 2)).astype(np.float32)
    wi = _unit32(rng.normal(size=(n, 3)))
    return dict(rows=list(rows), mat_id=mat_id, ns=ns, dpdu=dpdu, wo=wo,
                u=u, wi=wi)


def fuzz_slots(inputs: dict, device="cpu"):
    """(BsdfSlots, wo, u, wi) on `device` from ``fuzz_slot_inputs``: the
    port's compute_scattering over the rows' material table."""
    import torch
    from arendur_tpu_torch import materials as mats
    t = lambda a: torch.as_tensor(a, device=device)
    table = mats.make_material_table(inputs["rows"])
    mtab = t(mats.param_table(table))
    ns = t(inputs["ns"])
    b = mats.compute_scattering(table, mtab, t(inputs["mat_id"]), ns, ns,
                                t(inputs["dpdu"]))
    return b, t(inputs["wo"]), t(inputs["u"]), t(inputs["wi"])


def spread_materials(scene, copies: int = 5):
    """The scene with each of its M material rows repeated `copies`
    times (M * copies rows); triangle i takes copy i % copies of its
    row and sphere s copy s % copies.  Every copy is the same row, so
    the image does not change."""
    import dataclasses
    m = scene.materials
    nm = len(np.asarray(m.mtype))
    rep = lambda a: np.concatenate([np.asarray(a)] * copies, 0)
    table = type(m)(**{f.name: rep(getattr(m, f.name))
                       for f in dataclasses.fields(m)})
    tm = np.asarray(scene.tri_mat)
    tri_mat = (tm + nm * (np.arange(len(tm)) % copies)).astype(tm.dtype)
    s = scene.spheres
    sm = np.asarray(s.mat_id)
    sph_mat = (sm + nm * (np.arange(len(sm)) % copies)).astype(sm.dtype)
    return dataclasses.replace(
        scene, materials=table, tri_mat=tri_mat,
        spheres=dataclasses.replace(s, mat_id=sph_mat))


def sphere_rays(spheres, lo, hi, n: int = 512, seed: int = 0):
    """NumPy rays (o [n,3], d [n,3] unit, tmax [n]) against the spheres
    of a SphereSoA inside the box [lo, hi]: 3/16 secondary rays (random
    origin in the box, random direction), 3/16 camera-like rays (from
    an eye beyond the box's far z toward points in it), 1/4 aimed at a
    point within 1.1 radii of a sphere's center, 3/16 started on a
    sphere's surface (alternately leaving it and entering it), 1/16
    started inside a sphere, the rest grazing a sphere (closest approach
    r (1 + e), |e| <= 2e-6).  Half the lanes have tmax = inf, the others
    tmax uniform in [0.05, 6)."""
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(lo, np.float64), np.asarray(hi, np.float64)
    o2w = np.asarray(spheres.o2w, np.float64)
    rad = np.asarray(spheres.radius, np.float64)
    real = np.nonzero(rad > 1e-3)[0]   # not the builder's padding sphere
    ctr = o2w[:, 3, :3]
    lin = lambda v, s: np.einsum("nj,njk->nk", v, o2w[s, :3, :3])

    def unit(k):
        v = rng.normal(size=(k, 3))
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    k_sec, k_cam, k_aim, k_on, k_in = (3 * n // 16, 3 * n // 16, n // 4,
                                       3 * n // 16, n // 16)
    k_gr = n - k_sec - k_cam - k_aim - k_on - k_in
    o, d = [rng.uniform(lo, hi, (k_sec, 3))], [unit(k_sec)]
    eye = np.array([(lo[0] + hi[0]) / 2, (lo[1] + hi[1]) / 2, hi[2] + 6.0])
    o.append(np.repeat(eye[None], k_cam, 0))
    d.append(rng.uniform(lo, hi, (k_cam, 3)) - eye)
    s = rng.choice(real, k_aim)
    oa = rng.uniform(lo, hi, (k_aim, 3))
    o.append(oa)
    d.append(ctr[s] + rad[s, None] * rng.uniform(0, 1.1, (k_aim, 1))
             * unit(k_aim) - oa)
    s = rng.choice(real, k_on)
    pl = rad[s, None] * unit(k_on)
    dir_ = unit(k_on)
    leave = (np.sum(dir_ * lin(pl, s), -1) > 0) == (np.arange(k_on) % 2 == 0)
    o.append(lin(pl, s) + ctr[s])
    d.append(np.where(leave[:, None], dir_, -dir_))
    s = rng.choice(real, k_in)
    o.append(ctr[s] + 0.5 * rad[s, None] * rng.uniform(0, 1, (k_in, 1))
             * unit(k_in))
    d.append(unit(k_in))
    s = rng.choice(real, k_gr)
    u = unit(k_gr)
    v = np.cross(u, unit(k_gr))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    e = rng.uniform(-2e-6, 2e-6, (k_gr, 1))
    o.append(lin(rad[s, None] * ((1 + e) * u - 3 * v), s) + ctr[s])
    d.append(lin(v, s))
    d = np.concatenate(d)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    tmax = np.where(rng.uniform(size=n) < 0.5, np.inf,
                    rng.uniform(0.05, 6.0, n)).astype(np.float32)
    return np.concatenate(o).astype(np.float32), d, tmax

