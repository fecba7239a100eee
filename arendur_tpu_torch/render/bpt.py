"""Bidirectional path tracer, wavefront form (port of
arendur_tpu/render/bpt.py; ref: src/renderer/bpt/, written but disabled
in the reference build).

Per pixel sample one wave grows a camera subpath (max_depth + 1 surface
vertices after the lens vertex) and a light subpath (max_depth surface
vertices after the light vertex) by masked random walks, then connects
every (s, t) strategy with s + t <= max_depth + 2 under Veach's
iterative MIS weight, computed from the forward and reverse area
densities stored on the vertices.  The t = 1 strategies sample the
camera lens and return splats (raster position, radiance) that the
render adds to the film's splat plane.  The (s = 1, t = 1) strategy is
omitted, as in the JAX package: the reference never produces it
(bpt/node.rs:97-118).

Subpaths are Python lists of per-vertex dicts of [N, ...] tensors over
the wave.  Each surface vertex carries the BSDF its walk built
(``bsdf``), which every later evaluation at that vertex reuses: the
connections' f and the MIS weight's reverse densities both come from
the fused evaluate + pdf (kernel K9 on CUDA tensors), the one call a
vertex and a (wo, wi) pair need giving f and pdf together; the walk's
BSDF sample is kernel K8, its scene queries K1 (closest hit) and K2
(shadow rays).  On CPU tensors each of them runs its plain version.
The sampler dimensions are the JAX package's (the camera walk at
BOUNCE_DIM_BASE, the light walk at _LIGHT_WALK_BASE, the connections at
_CONNECT_BASE), so both draw the same numbers.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from arendur_tpu_torch import materials as mats
from arendur_tpu_torch import scene as sc
from arendur_tpu_torch.bxdf.types import ALL, SPECULAR
from arendur_tpu_torch.filming import camera as cam
from arendur_tpu_torch.filming import film as flm
from arendur_tpu_torch.filming import importance as imp
from arendur_tpu_torch.lighting import emission as emi
from arendur_tpu_torch.lighting import nee
from arendur_tpu_torch.render import cbounce as cb
from arendur_tpu_torch.render import cmath as cm
from arendur_tpu_torch.render.integrator import KERNEL_OPS, WaveOps
from arendur_tpu_torch.sampling import distribution
from arendur_tpu_torch.sampling import sampler as smp

# sampler dimension blocks disjoint from the path tracer's
_LIGHT_WALK_BASE = 1024
_CONNECT_BASE = 4096


def _c(x: torch.Tensor):
    return tuple(x.unbind(-1))


def _r(v) -> torch.Tensor:
    return torch.stack(v, -1)


def _dot(a, b):
    return cm.vdot(_c(a), _c(b))


def _v3(x):
    return x[:, None]


def _safe_dir(a, b):
    seg = b - a
    d2 = _dot(seg, seg)
    return seg * torch.rsqrt(torch.clamp(d2, min=1e-20))[:, None], d2


def convert_density(pdf_dir, from_pos, to_pos, to_ng, to_on_surface):
    """Solid-angle density at from_pos -> area density at to_pos (ref:
    bpt/node.rs density conversion)."""
    w, d2 = _safe_dir(from_pos, to_pos)
    inv_d2 = 1.0 / torch.clamp(d2, min=1e-20)
    cos = torch.where(to_on_surface, torch.abs(_dot(to_ng, w)), 1.0)
    return torch.where(d2 > 0.0, pdf_dir * cos * inv_d2, 0.0)


def _vertex(n: int, device) -> dict:
    """An empty vertex record of wave size n."""
    z3 = torch.zeros(n, 3, device=device)
    z1 = torch.zeros(n, device=device)
    zb = torch.zeros(n, dtype=torch.bool, device=device)
    return dict(valid=zb, pos=z3, pos_err=z3, ns=z3, ng=z3, dpdu=z3,
                dpdv=z3, uv=torch.zeros(n, 2, device=device),
                mat_id=torch.zeros(n, dtype=torch.int32, device=device),
                light_id=torch.full((n,), -1, dtype=torch.int32,
                                    device=device),
                beta=z3, pdf_fwd=z1, pdf_rev=z1, delta=zb, is_surface=zb,
                bsdf=None)


class _Wave:
    """What one wave's walks and connections share: the scene, the
    camera, the config, the kernel entries, the sampler and the
    texture atlas on the scene's device."""

    def __init__(self, scene, camera, config, resolution, ws, ops):
        self.scene, self.camera, self.config = scene, camera, config
        self.resolution, self.ws, self.ops = resolution, ws, ops
        self.textures = None
        self.tex_present = None
        if config.textures is not None:
            self.textures = config.textures.to(scene.device)
            self.tex_present = mats.tex_channel_presence(scene.materials)

    def bsdf(self, v: dict):
        """The BSDF of surface vertex v (twin: bpt._vertex_bsdf)."""
        return mats.compute_scattering(
            self.scene.materials, self.scene.mtab, v["mat_id"], v["ns"],
            v["ng"], v["dpdu"], uv=v["uv"], textures=self.textures,
            dpdv=v["dpdv"], tex_filter=self.config.tex_filter,
            tex_present=self.tex_present)

    def intersect(self, o, d):
        return sc.intersect(
            self.scene, o, d, closest_hit=self.ops.closest_hit,
            closest_hit_instanced=self.ops.closest_hit_instanced)

    def occluded(self, o, d, tmax):
        return sc.occluded(self.scene, o, d, tmax, any_hit=self.ops.any_hit,
                           any_hit_instanced=self.ops.any_hit_instanced)

    def eval_pdf(self, v: dict, toward_prev, toward_next):
        """f [N,3] and the solid-angle pdf [N] of scattering at surface
        vertex v from toward_next into toward_prev, from one fused
        evaluate + pdf of v's BSDF, with the unit directions (wo, wi)."""
        wo, _ = _safe_dir(v["pos"], toward_prev)
        wi, _ = _safe_dir(v["pos"], toward_next)
        f, pdf = self.ops.bsdf_eval_pdf(v["bsdf"], wo, wi, ALL)
        return f, pdf, wo, wi


def _shading_correction(bsdf, wo, wi):
    """The adjoint shading-normal correction of importance transport
    (ref: bpt/mod.rs:225-232 correct_shading_normal)."""
    num = torch.abs(_dot(wo, bsdf.ns)) * torch.abs(_dot(wi, bsdf.ng))
    den = torch.abs(_dot(wo, bsdf.ng)) * torch.abs(_dot(wi, bsdf.ns))
    return num, den


def _random_walk(wv: _Wave, o, d, beta, pdf_dir, n_steps: int,
                 dim_base: int, importance_mode: bool):
    """Masked wavefront random walk (twin: bpt._random_walk): n_steps
    vertex records (invalid lanes flagged), each with its BSDF, and the
    reverse density at the subpath's root."""
    n, dev = o.shape[0], o.device
    verts: List[dict] = []
    alive = _dot(d, d) > 0.0
    prev_pos, prev_ng = o, d
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    root_pdf_rev = None
    for i in range(n_steps):
        hit = wv.intersect(o, d)
        valid = alive & hit.hit
        v = _vertex(n, dev)
        v.update(valid=valid, pos=hit.pos, pos_err=hit.pos_err, ns=hit.ns,
                 ng=hit.ng, dpdu=hit.dpdu, dpdv=hit.dpdv, uv=hit.uv,
                 mat_id=hit.mat_id, light_id=hit.light_id,
                 beta=torch.where(_v3(valid), beta, 0.0),
                 pdf_fwd=convert_density(pdf_dir, prev_pos, hit.pos, hit.ng,
                                         ones),
                 is_surface=valid)
        bsdf = v["bsdf"] = wv.bsdf(v)
        wo = -d
        u = wv.ws.u2(dim_base + 4 * i)
        f, wi, pdf, kind = wv.ops.bsdf_sample(bsdf, wo, u, ALL)
        is_spec = (kind & SPECULAR) != 0
        v["delta"] = valid & is_spec
        cont = valid & ~cm.is_black(_c(f)) & (pdf > 0.0) \
            & (_dot(wi, wi) > 1e-12)

        # the reverse density at the previous vertex
        _, pdf_rev_dir = wv.ops.bsdf_eval_pdf(bsdf, wi, wo, ALL)
        pdf_rev_dir = torch.where(is_spec, 0.0, pdf_rev_dir)
        pr = convert_density(pdf_rev_dir, hit.pos, prev_pos, prev_ng, ones)
        if verts:
            verts[-1]["pdf_rev"] = torch.where(valid, pr,
                                               verts[-1]["pdf_rev"])
        else:
            root_pdf_rev = pr

        scale = torch.abs(_dot(wi, bsdf.ns)) / torch.clamp(pdf, min=1e-20)
        if importance_mode:
            num, den = _shading_correction(bsdf, wo, wi)
            scale = scale * num / torch.clamp(den, min=1e-20)
        new_beta = beta * f * _v3(scale)
        ok = cm.valid(_c(new_beta))
        beta = torch.where(_v3(cont & ok), new_beta, beta)
        alive = cont & ok

        prev_pos = torch.where(_v3(valid), hit.pos, prev_pos)
        prev_ng = torch.where(_v3(valid), hit.ng, prev_ng)
        o = _r(cb.offset_ray_origin(_c(hit.pos), _c(hit.pos_err), _c(hit.ng),
                                    _c(wi)))
        safe_wi = torch.where(_v3(_dot(wi, wi) < 1e-12),
                              torch.tensor([0.0, 0.0, 1.0], device=dev), wi)
        d = _r(cm.vnormalize(_c(safe_wi)))
        pdf_dir = pdf   # specular slots report pdf 1 with delta flagged
        verts.append(v)
    return verts, root_pdf_rev


def _remap0(x):
    return torch.where(x > 0.0, x, 1.0)


def _light_origin_pdf(scene: sc.DeviceScene, lidx):
    """pdfChoice * pdfPos (area) of light lidx (PdfLightOrigin)."""
    return distribution.discrete_pdf(scene.light_distribution, lidx) \
        * emi.pdf_origin(scene, lidx)


def _light_dir_pdf_to(scene, lidx, lpos, lng, to_pos, to_ng, to_surf):
    """PdfLight: the emission direction density from the light toward
    to_pos, as an area density at to_pos."""
    w, _ = _safe_dir(lpos, to_pos)
    pdf_dir = emi.pdf_dir_at(scene, lidx, lng, w)
    return convert_density(pdf_dir, lpos, to_pos, to_ng, to_surf)


def _bsdf_pdf_to(wv: _Wave, v, prev_pos, next_pos, next_ng, next_surf):
    """Vertex::Pdf of a surface vertex: the BSDF pdf of scattering
    prev -> v -> next as an area density at next."""
    _, pdf_dir, _, _ = wv.eval_pdf(v, prev_pos, next_pos)
    return convert_density(pdf_dir, v["pos"], next_pos, next_ng, next_surf)


def mis_weight(wv: _Wave, cam_vs, light_vs, s: int, t: int, lidx,
               sampled_light=None, sampled_cam=None, pt_rev=None,
               qs_rev=None):
    """Veach's iterative MIS weight [N] of strategy (s, t) over the wave
    (twin: bpt.mis_weight; ref: bpt/mod.rs:354-384, pbrt 16.3).  pt_rev
    / qs_rev: the reverse area densities at the junction vertices where
    the caller has them already (from the evaluation that gave the
    connection's f), else computed here."""
    scene = wv.scene
    n, dev = cam_vs[0]["pos"].shape[0], cam_vs[0]["pos"].device
    one = torch.ones(n, device=dev)
    zb = torch.zeros(n, dtype=torch.bool, device=dev)
    if s + t == 2:
        return one

    # the junction vertices (sampled overrides for s == 1 / t == 1)
    qs = sampled_light if (s == 1 and sampled_light is not None) else (
        light_vs[s - 1] if s > 0 else None)
    pt = sampled_cam if (t == 1 and sampled_cam is not None) else \
        cam_vs[t - 1]
    qs_minus = light_vs[s - 2] if s > 1 else None
    pt_minus = cam_vs[t - 2] if t > 1 else None

    # the junctions' reverse densities (pbrt a4-a7)
    if pt_rev is not None:
        pass
    elif s > 0:
        if s == 1:
            pt_rev = _light_dir_pdf_to(scene, lidx, qs["pos"], qs["ns"],
                                       pt["pos"], pt["ng"], pt["is_surface"])
        else:
            pt_rev = _bsdf_pdf_to(wv, qs, qs_minus["pos"], pt["pos"],
                                  pt["ng"], pt["is_surface"])
    else:
        # s == 0: pt lies on a light; its origin density
        lid = torch.clamp(pt["light_id"], min=0)
        pt_rev = torch.where(pt["light_id"] >= 0,
                             _light_origin_pdf(scene, lid), 0.0)

    ptm_rev = None
    if t > 1:
        if s > 0:
            ptm_rev = _bsdf_pdf_to(wv, pt, qs["pos"], pt_minus["pos"],
                                   pt_minus["ng"], pt_minus["is_surface"])
        else:
            lid = torch.clamp(pt["light_id"], min=0)
            ptm_rev = _light_dir_pdf_to(
                scene, lid, pt["pos"], pt["ns"], pt_minus["pos"],
                pt_minus["ng"], pt_minus["is_surface"])
            ptm_rev = torch.where(pt["light_id"] >= 0, ptm_rev, 0.0)

    if qs_rev is not None or s == 0:
        pass
    elif t == 1:
        # the camera vertex's density toward qs
        w, _ = _safe_dir(pt["pos"], qs["pos"])
        _, pdf_dir = imp.importance_pdf(wv.camera, pt["pos"], w,
                                        wv.resolution)
        qs_rev = convert_density(pdf_dir, pt["pos"], qs["pos"], qs["ng"],
                                 qs["is_surface"])
    else:
        qs_rev = _bsdf_pdf_to(wv, pt, pt_minus["pos"], qs["pos"], qs["ng"],
                              qs["is_surface"])

    qsm_rev = None
    if s > 1:
        qsm_rev = _bsdf_pdf_to(wv, qs, pt["pos"], qs_minus["pos"],
                               qs_minus["ng"], qs_minus["is_surface"])

    def rev_of_cam(i):
        if i == t - 1:
            return pt_rev
        if i == t - 2 and ptm_rev is not None:
            return ptm_rev
        return cam_vs[i]["pdf_rev"]

    def rev_of_light(i):
        if i == s - 1:
            return qs_rev
        if i == s - 2 and qsm_rev is not None:
            return qsm_rev
        return light_vs[i]["pdf_rev"]

    def fwd_of_light(i):
        if i == s - 1 and s == 1 and sampled_light is not None:
            return sampled_light["pdf_fwd"]
        return light_vs[i]["pdf_fwd"]

    def delta_cam(i):
        if i == t - 1 or i == t - 2:
            return zb   # the junction made connectible
        return cam_vs[i]["delta"]

    def delta_light(i):
        if i == s - 1 and s == 1 and sampled_light is not None:
            return sampled_light["delta"]
        if i == s - 1 or (i == s - 2 and s >= 2):
            return light_vs[0]["delta"] if i == 0 else zb
        return light_vs[i]["delta"]

    sum_ri = torch.zeros(n, device=dev)
    # the camera side: strategies extending the light subpath
    ri = one
    for i in range(t - 1, 0, -1):
        ri = ri * _remap0(rev_of_cam(i)) / _remap0(cam_vs[i]["pdf_fwd"])
        not_delta = ~delta_cam(i) & ~(delta_cam(i - 1) if i - 1 > 0 else zb)
        sum_ri = sum_ri + torch.where(not_delta, ri, 0.0)
    # the light side
    ri = one
    for i in range(s - 1, -1, -1):
        ri = ri * _remap0(rev_of_light(i)) / _remap0(fwd_of_light(i))
        prev_delta = delta_light(i - 1) if i > 0 else zb
        sum_ri = sum_ri + torch.where(~delta_light(i) & ~prev_delta, ri, 0.0)
    return 1.0 / (1.0 + sum_ri)


def _g_term(wv: _Wave, va_pos, va_err, va_ng, va_ns, va_surf, vb_pos, vb_ns,
            vb_surf):
    """The visibility-tested geometric term between two vertices (ref:
    bpt/mod.rs:330-352); its shadow ray is a K2 query."""
    w, d2 = _safe_dir(va_pos, vb_pos)
    g = 1.0 / torch.clamp(d2, min=1e-20)
    g = g * torch.where(va_surf, torch.abs(_dot(va_ns, w)), 1.0)
    g = g * torch.where(vb_surf, torch.abs(_dot(vb_ns, w)), 1.0)
    o = _r(cb.offset_ray_origin(_c(va_pos), _c(va_err), _c(va_ng), _c(w)))
    dist = torch.sqrt(torch.clamp(d2, min=1e-20))
    blocked = wv.occluded(o, w, dist * (1.0 - 1e-3))
    return torch.where(blocked, 0.0, g)


def _eval_f(wv: _Wave, v, toward_prev, toward_next,
            importance_mode: bool = False):
    """f at surface vertex v for prev -> v -> next, with the adjoint
    shading-normal correction in importance mode, and the solid-angle
    pdf [N] of the same scattering: (f [N,3], pdf [N])."""
    f, pdf, wo, wi = wv.eval_pdf(v, toward_prev, toward_next)
    if importance_mode:
        num, den = _shading_correction(v["bsdf"], wo, wi)
        f = f * _v3(num / torch.clamp(den, min=1e-20))
    return f, pdf


def trace_wave_bpt(scene: sc.DeviceScene, camera: cam.CameraData, config,
                   film_cfg: flm.FilmConfig, pixel_xy, pixel_id, sample_id,
                   base_key, collect: Optional[dict] = None,
                   ops: WaveOps = KERNEL_OPS):
    """Trace one BPT wave (twin: bpt.trace_wave_bpt): (pfilm [N,2], L
    [N,3], splat_praster [K*N,2], splat_L [K*N,3], splat_valid [K*N]),
    the splat arrays holding the t = 1 light-tracing contributions.

    collect: an optional dict that receives {(s, t): (contribution
    [N,3], MIS weight [N])} per strategy, and under "cam_vs" /
    "light_vs" the two subpaths' vertex records."""
    n, dev = pixel_xy.shape[0], pixel_xy.device
    resolution = film_cfg.resolution
    ws = smp.WaveSampler(base_key, pixel_id, sample_id, kind=config.sampler,
                         sobol_table=config.sobol_table,
                         sample_dx=config.sample_dx,
                         sample_dy=config.sample_dy)
    wv = _Wave(scene, camera, config, resolution, ws, ops)
    max_depth = config.max_depth
    n_cam = max_depth + 1      # surface vertices of the camera subpath
    n_light = max_depth        # surface vertices of the light subpath
    ones3 = torch.ones(n, 3, device=dev)
    zb = torch.zeros(n, dtype=torch.bool, device=dev)
    tb = torch.ones(n, dtype=torch.bool, device=dev)

    # ---- the camera subpath --------------------------------------------
    pfilm = pixel_xy + ws.film_jitter()
    o, d = cam.generate_rays(camera, pfilm, ws.u2(2))
    nd = _r(cm.vnormalize(_c(d)))
    cam_v0 = _vertex(n, dev)
    cam_v0.update(valid=tb, pos=o, ns=nd, ng=nd, beta=ones3,
                  pdf_fwd=torch.ones(n, device=dev))
    _, pdf_dir0 = imp.importance_pdf(camera, o, nd, resolution)
    cam_walk, _ = _random_walk(wv, o, d, ones3, pdf_dir0, n_cam,
                               smp.BOUNCE_DIM_BASE, importance_mode=False)
    cam_vs = [cam_v0] + cam_walk

    # ---- the light subpath ---------------------------------------------
    lidx, l_choice_pdf = distribution.sample_discrete(
        scene.light_distribution, ws.u1(_LIGHT_WALK_BASE - 1))
    gp = emi.generate_path(scene, lidx, ws.u2(_LIGHT_WALK_BASE),
                           ws.u2(_LIGHT_WALK_BASE + 2),
                           textures=wv.textures)
    lt = scene.ltab[lidx, dict(scene.static.lcidx)["ltype"][0]] \
        .to(torch.int32)
    delta_origin = (lt == sc.L_POINT) | (lt == sc.L_SPOT) \
        | (lt == sc.L_DISTANT)
    lv0 = _vertex(n, dev)
    lv0.update(valid=tb, pos=gp["pos"], ns=gp["n"], ng=gp["n"],
               light_id=lidx.to(torch.int32), delta=delta_origin,
               is_surface=~delta_origin,
               pdf_fwd=l_choice_pdf * gp["pdf_pos"])
    safe_pp = torch.clamp(gp["pdf_pos"], min=1e-20)
    lv0["beta"] = gp["le"] / _v3(l_choice_pdf * torch.where(
        gp["pdf_pos"] > 0.0, safe_pp, 1.0))
    cosl = torch.where(delta_origin, 1.0,
                       torch.abs(_dot(gp["n"], gp["dir"])))
    safe_pd = torch.clamp(gp["pdf_dir"], min=1e-20)
    walk_beta = lv0["beta"] * _v3(
        cosl / torch.where(gp["pdf_dir"] > 0.0, safe_pd, 1.0))
    walk_beta = torch.where(_v3(gp["pdf_dir"] > 0.0), walk_beta, 0.0)
    # the first rays start 1e-4 off an area light's surface
    o_l = gp["pos"] + gp["n"] * 1e-4 * torch.where(_v3(delta_origin), 0.0,
                                                   1.0)
    light_walk, lw0_rev = _random_walk(
        wv, o_l, gp["dir"], walk_beta, gp["pdf_dir"], n_light,
        _LIGHT_WALK_BASE + 8, importance_mode=True)
    if light_walk:
        lv0["pdf_rev"] = torch.where(light_walk[0]["valid"], lw0_rev, 0.0)
    light_vs = [lv0] + light_walk
    if collect is not None:
        collect["cam_vs"], collect["light_vs"] = cam_vs, light_vs

    def record(s, t, contrib, w):
        if collect is not None:
            collect[(s, t)] = (contrib, w)

    # ---- the strategies with t >= 2 ------------------------------------
    L = torch.zeros(n, 3, device=dev)
    for t in range(2, n_cam + 2):
        for s in range(0, n_light + 2):
            if s + t > max_depth + 2:
                continue
            pt = cam_vs[t - 1]
            ptm = cam_vs[t - 2]
            if s == 0:
                # the camera subpath hit a light
                is_light = pt["valid"] & (pt["light_id"] >= 0)
                le = sc.light_emission(scene, pt["light_id"], pt["uv"],
                                       wv.textures)
                w = mis_weight(wv, cam_vs, light_vs, s, t,
                               torch.clamp(pt["light_id"], min=0))
                contrib = torch.where(_v3(is_light),
                                      pt["beta"] * le * _v3(w), 0.0)
                record(s, t, contrib, w)
                L = L + contrib
                continue
            if s == 1:
                # a light sample toward pt (the NEE-like connection)
                u_l = ws.u2(_CONNECT_BASE + 4 * (t * 8 + s))
                ls = nee.light_sample(scene, lidx, pt["pos"], u_l,
                                      need_nl=True)
                active = pt["valid"] & ~pt["delta"] & (ls["pdf"] > 0.0) \
                    & ~cm.is_black(_c(ls["radiance"]))
                f_pt, pdf_pt = _eval_f(wv, pt, ptm["pos"], ls["pfrom"])
                cos_pt = torch.abs(_dot(ls["wi"], pt["ns"]))
                hit = sc.Hit(hit=pt["valid"], t=None, prim=None,
                             pos=pt["pos"], pos_err=pt["pos_err"],
                             ng=pt["ng"], ns=pt["ns"], dpdu=pt["dpdu"],
                             dpdv=pt["dpdv"], uv=pt["uv"],
                             mat_id=pt["mat_id"], light_id=pt["light_id"])
                blocked = nee._occlusion_query(
                    scene, hit, ls["pfrom"], any_hit=ops.any_hit,
                    any_hit_instanced=ops.any_hit_instanced)
                c = pt["beta"] * f_pt * ls["radiance"] * _v3(
                    cos_pt / torch.clamp(ls["pdf"] * l_choice_pdf,
                                         min=1e-20))
                c = torch.where(_v3(active & ~blocked), c, 0.0)
                samp = _vertex(n, dev)
                samp.update(pos=ls["pfrom"], ns=ls["nl"], ng=ls["nl"],
                            is_surface=~ls["delta"], delta=ls["delta"],
                            pdf_fwd=_light_origin_pdf(scene, lidx))
                w = mis_weight(
                    wv, cam_vs, light_vs, s, t, lidx, sampled_light=samp,
                    qs_rev=convert_density(pdf_pt, pt["pos"], samp["pos"],
                                           samp["ng"], samp["is_surface"]))
                contrib = _r(cm.sanitize(_c(c * _v3(w))))
                record(s, t, contrib, w)
                L = L + contrib
                continue
            # s >= 2: a surface-surface connection
            qs, qsm = light_vs[s - 1], light_vs[s - 2]
            active = pt["valid"] & qs["valid"] & ~pt["delta"] & ~qs["delta"]
            f_pt, pdf_pt = _eval_f(wv, pt, ptm["pos"], qs["pos"])
            f_qs, pdf_qs = _eval_f(wv, qs, qsm["pos"], pt["pos"],
                                   importance_mode=True)
            g = _g_term(wv, pt["pos"], pt["pos_err"], pt["ng"], pt["ns"],
                        pt["is_surface"], qs["pos"], qs["ns"],
                        qs["is_surface"])
            c = pt["beta"] * f_pt * f_qs * qs["beta"] * _v3(g)
            c = torch.where(_v3(active), c, 0.0)
            w = mis_weight(
                wv, cam_vs, light_vs, s, t, lidx,
                pt_rev=convert_density(pdf_qs, qs["pos"], pt["pos"],
                                       pt["ng"], pt["is_surface"]),
                qs_rev=convert_density(pdf_pt, pt["pos"], qs["pos"],
                                       qs["ng"], qs["is_surface"]))
            contrib = _r(cm.sanitize(_c(c * _v3(w))))
            record(s, t, contrib, w)
            L = L + contrib

    # ---- the t == 1 strategies (light tracing, splatted) ----------------
    splat_praster, splat_L, splat_valid = [], [], []
    for s in range(2, n_light + 2):
        if s + 1 > max_depth + 2:
            continue
        qs, qsm = light_vs[s - 1], light_vs[s - 2]
        u_c = ws.u2(_CONNECT_BASE + 4 * (1 * 8 + s) + 2)
        cs = imp.importance_sample(camera, qs["pos"], u_c, resolution)
        active = qs["valid"] & ~qs["delta"] & cs["valid"] & (cs["pdf"] > 0.0)
        f_qs, pdf_qs = _eval_f(wv, qs, qsm["pos"], cs["pcam"],
                               importance_mode=True)
        cos_qs = torch.abs(_dot(cs["wi"], qs["ns"]))
        # visibility qs -> the lens point
        o_sh = _r(cb.offset_ray_origin(_c(qs["pos"]), _c(qs["pos_err"]),
                                       _c(qs["ng"]), _c(cs["wi"])))
        seg = cs["pcam"] - o_sh
        dist = torch.sqrt(torch.clamp(_dot(seg, seg), min=1e-20))
        blocked = wv.occluded(o_sh, seg / _v3(dist), dist * (1.0 - 1e-3))
        c = qs["beta"] * f_qs * _v3(cs["we"] * cos_qs
                                    / torch.clamp(cs["pdf"], min=1e-20))
        c = torch.where(_v3(active & ~blocked), c, 0.0)
        samp_cam = _vertex(n, dev)
        fwd, _ = _safe_dir(cs["pcam"], qs["pos"])
        samp_cam.update(pos=cs["pcam"], ns=fwd, ng=fwd,
                        pdf_fwd=torch.ones(n, device=dev))
        w = mis_weight(
            wv, cam_vs, light_vs, s, 1, lidx, sampled_cam=samp_cam,
            pt_rev=convert_density(pdf_qs, qs["pos"], samp_cam["pos"],
                                   samp_cam["ng"], samp_cam["is_surface"]))
        contrib = _r(cm.sanitize(_c(c * _v3(w))))
        record(s, 1, contrib, w)
        splat_praster.append(cs["praster"])
        splat_L.append(contrib)
        splat_valid.append(active & ~blocked)

    if splat_praster:
        sp = torch.cat(splat_praster, 0)
        sl_ = torch.cat(splat_L, 0)
        sv = torch.cat(splat_valid, 0)
    else:
        sp = torch.zeros(0, 2, device=dev)
        sl_ = torch.zeros(0, 3, device=dev)
        sv = torch.zeros(0, dtype=torch.bool, device=dev)
    return pfilm, _r(cm.sanitize(_c(L))), sp, sl_, sv


def render_bpt(scene: sc.DeviceScene, camera: cam.CameraData,
               film_cfg: flm.FilmConfig, config, ops: WaveOps = KERNEL_OPS,
               progress: bool = False):
    """The full BPT render on the scene's device (twin: bpt.render_bpt;
    ref: bpt/mod.rs:38-98): waves over (pixels x spp), the t >= 2
    radiance filtered into the film, the t = 1 splats added to the splat
    plane and scaled by 1/spp at finalize.  Returns [H, W, 3]."""
    dev = scene.device
    w, h = film_cfg.resolution
    spp = config.spp
    base_key = smp.make_base_key(config.seed)
    state = flm.film_init(film_cfg, dev, with_splat=True)
    total = w * h * spp
    wave = min(config.wave_size, total)
    n_waves = (total + wave - 1) // wave
    for i in range(n_waves):
        ray_idx = i * wave + torch.arange(wave, dtype=torch.int64,
                                          device=dev)
        pixel_id = ray_idx // spp
        sample_id = ray_idx % spp
        pixel_xy = torch.stack([(pixel_id % w).to(torch.float32),
                                (pixel_id // w).to(torch.float32)], -1)
        valid = ray_idx < total
        with torch.no_grad():
            pfilm, L, sp, sL, sv = trace_wave_bpt(
                scene, camera, config, film_cfg, pixel_xy, pixel_id,
                sample_id, base_key, ops=ops)
        flm.film_splat(film_cfg, state, pfilm, L, mask=valid)
        k = sp.shape[0] // max(wave, 1)
        if k:
            # the t = 1 contributions are film-density estimates: summed
            # and scaled by 1/spp at finalize (ref: bpt/mod.rs:85-86)
            flm.film_add_splat(film_cfg, state, sp, sL,
                               mask=sv & valid.repeat(k))
        if progress:
            import logging
            logging.getLogger("arendur_tpu_torch").info(
                "bpt wave %d/%d done", i + 1, n_waves)
    return flm.film_finalize(state, film_cfg, splat_scale=1.0 / spp)
