"""Wavefront path-tracing integrator: the main path (port of the
fused-shade branch of arendur_tpu/render/integrator.py and of its
hybrid split for textured scenes; ref: src/renderer/pt.rs).

A wave of N camera rays advances through max_depth bounces.  Each
bounce runs:

1. dead-lane compaction (alive lanes first; the count stays a device
   scalar that the intersection kernels read);
2. the closest hit against the triangle clusters and the analytic
   spheres (kernel K1);
3. the whole bounce shade over the lane-transposed wave (kernel K3);
4. the shadow any-hit against both (kernel K2);
5. one masked add of the NEE contribution.

With ``config.textures`` set (a texturing.texture.TextureAtlas), step 3
splits in three: the hit kernel (K5) resolves the hit's shading info,
uv and the uv footprint of a ray cone carried per lane (width cone_w,
spread cone_g, started from the camera's ray differentials); the texel
lookups run in plain PyTorch (materials.resolve_params); the split
shade kernel (K6) shades on the resolved material columns.  The
untextured wave carries no cone and launches neither.

Instanced meshes ride every branch: each scene query adds one launch
of the instanced K1 / K2 per instanced mesh (scene.closest_hits), and the
bounce shades read the winning instance's triangle row baked into world
space.  Scenes the fused and split branches do not serve, those whose
area lights carry an emission texture, those with no triangle at all
and those whose world triangles meet the BVH walk or the brute force
(no cluster tables), take the composed bounce (the JAX package's per-bounce
composition, integrator.py:440-547): the full
closest hit (scene.intersect, K1), the emission through the texture,
the material's BSDF (materials.compute_scattering), the NEE light
branch (lighting/nee.py: the fused evaluate + pdf, kernel K9, and the
shadow any-hit, K2), the continuation sample (kernel K8), the MIS
weight, beta and Russian roulette, each a separate step.  A caller can
ask for the composed path on any scene (``composed=True``, the JAX
package's ARENDUR_SHADE=xla), so the paths can be held against each
other.

After the loop, one more closest hit completes the deferred-MIS BSDF
branch at the last vertex, and the lanes go back to their original
order.  ``render`` runs the waves and splats them into the film.

The kernel calls go through a ``WaveOps``: ``KERNEL_OPS``
(default) dispatches on the tensors' device, CUDA to the hand-written
kernels and CPU to the plain versions; ``PLAIN_OPS`` names the plain
PyTorch versions, so a caller can time the plain path on the card.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Optional

import numpy as np
import torch

from arendur_tpu_torch import materials as mats
from arendur_tpu_torch import scene as sc
from arendur_tpu_torch.bxdf import slot_shade as ssh
from arendur_tpu_torch.bxdf import slots as sl
from arendur_tpu_torch.bxdf.types import ALL, ALL_NON_SPECULAR, SPECULAR
from arendur_tpu_torch.filming import camera as cam
from arendur_tpu_torch.filming import film as flm
from arendur_tpu_torch.lighting import nee
from arendur_tpu_torch.render import cbounce as cb
from arendur_tpu_torch.render import cmath as cm
from arendur_tpu_torch.sampling import sampler as smp
from arendur_tpu_torch.sampling import sobol
from arendur_tpu_torch.shapes import cluster_intersect as ci
from arendur_tpu_torch.shapes import sphere as sph

log = logging.getLogger("arendur_tpu_torch")


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    max_depth: int = 8
    rr_threshold: float = 0.05
    spp: int = 16
    sample_dx: int = 4          # stratification grid (dx*dy == spp)
    sample_dy: int = 4
    seed: int = 0
    wave_size: int = 1 << 16    # rays per wavefront launch
    sampler: str = "strata"     # "strata" | "sobol" | "uniform"
    sobol_table: Optional[object] = None  # [spp, D] u32 (host-built,
                                          # sampling/sobol.py)
    compact: bool = True        # dead-lane compaction per bounce
    defer_final_mis: bool = True  # the closest hit after the loop that
                                  # completes the deferred-MIS branch
    textures: Optional[object] = None   # texturing.texture.TextureAtlas
    tex_filter: str = "trilinear"       # "trilinear" | "ewa"
    cone_curvature: bool = True   # grow the texture-LOD cone's spread at
                                  # specular bounces off curved surfaces
                                  # (gamma' = gamma + 2 kappa w)

    @property
    def min_depth(self):
        return self.max_depth // 2


@dataclasses.dataclass(frozen=True)
class WaveOps:
    """The kernel entries one bounce calls: the scene queries (the
    world's and each instanced mesh's), bounce_shade on the fused
    branch, hit_shade and shade_split on the textured split,
    bsdf_sample and bsdf_eval_pdf on the composed bounce."""
    closest_hit: Callable
    any_hit: Callable
    bounce_shade: Callable
    hit_shade: Callable
    shade_split: Callable
    bsdf_sample: Callable
    bsdf_eval_pdf: Callable
    closest_hit_instanced: Callable
    any_hit_instanced: Callable


KERNEL_OPS = WaveOps(ci.intersect_clusters, ci.occluded_clusters,
                     cb.bounce_shade_t, cb.hit_shade_t, cb.shade_split_t,
                     ssh.bsdf_sample, ssh.bsdf_eval_pdf,
                     ci.intersect_instanced, ci.occluded_instanced)
PLAIN_OPS = WaveOps(ci.intersect_clusters_reference,
                    ci.occluded_clusters_reference, cb.cbody_reference,
                    cb.cbody_hit_reference, cb.cbody_shade_reference,
                    sl.bsdf_sample, sl.bsdf_eval_pdf,
                    ci.intersect_instanced_reference,
                    ci.occluded_instanced_reference)


def _compact_perm(alive: torch.Tensor):
    """Stable alive-first permutation + live count (an int32 device
    scalar, the form the kernels read)."""
    n = alive.shape[0]
    ai = alive.to(torch.int64)
    n_alive = ai.sum()
    pos_alive = torch.cumsum(ai, 0) - 1
    pos_dead = n_alive + torch.cumsum(1 - ai, 0) - 1
    dst = torch.where(alive, pos_alive, pos_dead)
    perm = torch.empty(n, dtype=torch.int64, device=alive.device)
    perm[dst] = torch.arange(n, device=alive.device)
    return perm, n_alive.to(torch.int32)


def _permute(carry: dict, perm: torch.Tensor) -> dict:
    return {k: v[perm] for k, v in carry.items()}


def _closest(scene: sc.DeviceScene, o, d, n_alive, ops: WaveOps):
    """Closest hit over the world's triangles, the spheres (K1 with the
    scene's sphere table) and the instanced meshes (one instanced K1
    each): scene.Closest."""
    tmax = torch.full((o.shape[0],), float("inf"), device=o.device)
    return sc.closest_hits(scene, o, d, tmax, n_alive, ops.closest_hit,
                           ops.closest_hit_instanced)


def intersect_raw(scene: sc.DeviceScene, o, d, n_alive=None,
                  ops: WaveOps = KERNEL_OPS) -> dict:
    """Raw closest hit for the bounce shade (twin: scene.intersect_raw
    under ARENDUR_SPHERES=kernel): dict(t, hit, is_sphere, s_idx,
    p_local, trow [N,26]); p_local is rebuilt from the kernel's t on the
    winning sphere's frame, and a lane whose nearest triangle is
    instanced carries that instance's row baked into world space
    (scene.instance_world_rows), which the bounce shade reads as it
    reads a world row.  The ray geometry is detached, as in the JAX
    package (detached-sampling estimator): no gradient reaches t or
    p_local from o and d."""
    o, d = o.detach(), d.detach()
    c = _closest(scene, o, d, n_alive, ops)
    p_local, s_idx = sph.hit_p_local(scene.ktab, c.slot, o, d, c.t_k)
    trow = scene.tpack[torch.clamp(c.tri_idx, min=0)]
    for im, hit_i, li, best in c.wins:
        trow = torch.where(hit_i[:, None],
                           sc.instance_world_rows(im, li, best), trow)
    return dict(t=c.t, hit=c.hit, is_sphere=c.use_sphere, s_idx=s_idx,
                p_local=p_local, trow=trow)


def intersect_light(scene: sc.DeviceScene, o, d, n_alive=None,
                    ops: WaveOps = KERNEL_OPS):
    """What the final deferred-MIS pass needs of a closest hit (twin: the
    hit and light_id of the JAX pass's full scene.intersect): (hit,
    light_id) with light_id -1 where the hit is no light, an instanced
    triangle among them; ray geometry detached, as in intersect_raw."""
    o, d = o.detach(), d.detach()
    c = _closest(scene, o, d, n_alive, ops)
    light_tri = scene.tpack[torch.clamp(c.tri_idx, min=0), 25]
    for _, hit_i, _, _ in c.wins:
        light_tri = torch.where(hit_i, -1.0, light_tri)
    s_idx = torch.clamp(-2 - c.slot.long(), min=0)
    light_id = torch.where(c.use_sphere, scene.stab[s_idx, 21], light_tri)
    hit = c.hit
    return hit, torch.where(hit, light_id, -1.0).long()


def occluded(scene: sc.DeviceScene, o, d, tmax, n_alive=None,
             ops: WaveOps = KERNEL_OPS) -> torch.Tensor:
    """Shadow any-hit against triangles and spheres (ray geometry
    detached, as in intersect_raw)."""
    return sc.occluded(scene, o, d, tmax, n_alive, any_hit=ops.any_hit,
                       any_hit_instanced=ops.any_hit_instanced)


def bounce_draws(config: RenderConfig, keys: torch.Tensor, bounce: int):
    """The four sample streams one bounce consumes: (u_sel, u_light
    [N,2], u_bsdf [N,2], u_rr)."""
    dim0 = smp.BOUNCE_DIM_BASE + bounce * smp.DIMS_PER_BOUNCE
    grid_ok = config.sample_dx * config.sample_dy == config.spp
    table = None
    if config.sampler == "sobol":
        table = sobol.sobol_tensor(config.sobol_table, keys.device)

    def draw1(dim):
        if table is not None:
            return sobol.sobol_from_keys(table, keys, dim)
        if config.sampler == "uniform":
            return smp.uniform_1d(keys, dim)
        return smp.stratified_1d(keys, config.spp, dim)

    def draw2(dim):
        if table is not None:
            return sobol.sobol_2d_from_keys(table, keys, dim)
        if grid_ok and config.sampler != "uniform":
            return smp.stratified_2d(keys, config.sample_dx,
                                     config.sample_dy, dim)
        return smp.uniform_2d(keys, dim)

    return (draw1(dim0 + smp.DIM_LIGHT_SELECT),
            draw2(dim0 + smp.DIM_LIGHT_U), draw2(dim0 + smp.DIM_BSDF_U),
            draw1(dim0 + smp.DIM_RR))


def pack_bounce_input(carry: dict, raw: dict, lidx, selpdf, u_light,
                      u_bsdf, u_rr, bounce: int) -> torch.Tensor:
    """The bounce shade's input [IN_COLS, N] (the column layout of
    render/cbounce.py)."""
    n = carry["o"].shape[0]
    f1 = lambda a: a.to(torch.float32)[:, None]
    x = torch.cat([
        carry["o"], carry["d"], raw["t"][:, None], f1(raw["hit"]),
        f1(raw["is_sphere"]), f1(raw["s_idx"]), raw["p_local"],
        raw["trow"], carry["beta"], carry["L"], f1(carry["specular"]),
        f1(carry["sel_prev"]), carry["wb_prev"][:, None],
        f1(carry["nee_prev"]), f1(carry["alive"]), f1(lidx),
        selpdf[:, None], u_light, u_bsdf, u_rr[:, None],
        torch.full((n, 1), float(bounce), device=carry["o"].device),
    ], dim=1)
    return x.T.contiguous()


def pack_hit_input(carry: dict, raw: dict) -> torch.Tensor:
    """The hit kernel's input [HIT_IN_COLS, N]: columns 0:39 of the
    bounce input, then the lane's cone width and spread."""
    f1 = lambda a: a.to(torch.float32)[:, None]
    x = torch.cat([
        carry["o"], carry["d"], raw["t"][:, None], f1(raw["hit"]),
        f1(raw["is_sphere"]), f1(raw["s_idx"]), raw["p_local"],
        raw["trow"], carry["cone_w"][:, None], carry["cone_g"][:, None],
    ], dim=1)
    return x.T.contiguous()


def pack_shade_input(carry: dict, raw: dict, hi: dict, res: tuple, lidx,
                     selpdf, u_light, u_bsdf, u_rr,
                     bounce: int) -> torch.Tensor:
    """The split shade kernel's input [SHADE_IN_COLS, N]: the hit info,
    the texture-resolved material columns res (resolve_params' output)
    and the path state (the layout of render/cbounce.py S_*)."""
    mtype, kd, ks, sigma, rough, eta, dissolve, ns, dpdu = res
    n = carry["o"].shape[0]
    f1 = lambda a: a.to(torch.float32)[:, None]
    x = torch.cat([
        carry["d"], hi["pos"], hi["pos_err"], hi["ng"], ns, dpdu,
        f1(mtype), kd, ks, sigma[:, None], rough[:, None], eta[:, None],
        dissolve[:, None], f1(hi["light_id"]), f1(raw["hit"]),
        carry["beta"], carry["L"], f1(carry["specular"]),
        f1(carry["sel_prev"]), carry["wb_prev"][:, None],
        f1(carry["nee_prev"]), f1(carry["alive"]), f1(lidx),
        selpdf[:, None], u_light, u_bsdf, u_rr[:, None],
        torch.full((n, 1), float(bounce), device=carry["o"].device),
    ], dim=1)
    return x.T.contiguous()


def _length(a):
    return torch.sqrt(a[:, 0] * a[:, 0] + a[:, 1] * a[:, 1]
                      + a[:, 2] * a[:, 2])


def curv_spread(scene: sc.DeviceScene, config: RenderConfig, cone_g,
                is_sph, s_idx, w_at_hit, spec_bounce):
    """Curvature growth of the cone's spread at a specular bounce:
    gamma' = gamma + 2 kappa w (ray cones), kappa = 1 / r on spheres
    (the object-space radius) and 0 on flat triangles."""
    if not config.cone_curvature or scene.ktab.shape[0] == 0:
        return cone_g
    radius = scene.ktab[s_idx.long(), 16]
    kappa = torch.where(is_sph, 1.0 / torch.clamp(radius, min=1e-6), 0.0)
    return cone_g + torch.where(spec_bounce, 2.0 * kappa * w_at_hit, 0.0)


def _rdot(a, b):
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def composed_bounce(scene: sc.DeviceScene, config: RenderConfig, c: dict,
                    bounce: int, n_alive, ops: WaveOps, textures=None,
                    tex_present=None) -> dict:
    """One composed bounce over the wave state c (twin: the XLA
    composition of integrator.bounce_step, ref: pt.rs:72-122): returns
    the next state."""
    d, beta, L = c["d"], c["beta"], c["L"]
    hit = sc.intersect(scene, c["o"], d, n_alive=n_alive,
                       closest_hit=ops.closest_hit,
                       closest_hit_instanced=ops.closest_hit_instanced)
    lane_active = c["alive"] & hit.hit

    # (2) emitted radiance, weight 1 for camera hits and specular
    # continuations, plus the deferred MIS weight at the light NEE chose
    emit_gate = lane_active & (hit.light_id >= 0)
    w_emit = torch.where(c["specular"] | (bounce == 0), 1.0, 0.0) \
        + torch.where(c["nee_prev"] & (hit.light_id == c["sel_prev"]),
                      c["wb_prev"], 0.0)
    le = sc.light_emission(scene, hit.light_id, hit.uv, textures)
    L = L + torch.where(emit_gate[:, None], w_emit[:, None] * beta * le,
                        0.0)

    # (3) scattering and NEE
    wo = -d
    out = {}
    duvdx = duvdy = None
    if textures is not None:
        from arendur_tpu_torch.geometry import dxy
        ft = torch.where(hit.hit, hit.t, 0.0)
        r_cone = c["cone_w"] + c["cone_g"] * ft
        duvdx, duvdy = dxy.cone_duv(r_cone, d, hit.ng, hit.dpdu, hit.dpdv)
        out["cone_w"] = torch.where(hit.hit, r_cone, c["cone_w"])
    bsdf = mats.compute_scattering(
        scene.materials, scene.mtab, hit.mat_id, hit.ns, hit.ng, hit.dpdu,
        uv=hit.uv, textures=textures, dpdv=hit.dpdv, duvdx=duvdx,
        duvdy=duvdy, tex_filter=config.tex_filter, tex_present=tex_present)
    do_nee = lane_active & (sl.match_count(bsdf, ALL_NON_SPECULAR) > 0)
    u_sel, u_light, u_bsdf, u_rr = bounce_draws(config, c["keys"], bounce)
    direct, lidx, selpdf = nee.uniform_sample_one_light(
        scene, hit, bsdf, wo, u_sel, u_light, n_alive, textures,
        eval_pdf=ops.bsdf_eval_pdf, any_hit=ops.any_hit,
        any_hit_instanced=ops.any_hit_instanced)
    L = L + torch.where(do_nee[:, None], beta * direct, 0.0)

    # (4) the BSDF sample for the continuation, also the MIS BSDF sample
    f, wi, pdf, kind = ops.bsdf_sample(bsdf, wo, u_bsdf, ALL)
    cont = lane_active & ~cm.is_black((f[:, 0], f[:, 1], f[:, 2])) \
        & (pdf > 0.0)
    specular = torch.where(lane_active, (kind & SPECULAR) != 0,
                           c["specular"])
    wb = nee.path_mis_weight(scene, lidx, selpdf, hit.pos, wi, pdf, kind, f)
    ratio = torch.abs(_rdot(wi, bsdf.ns)) / torch.clamp(pdf, min=1e-20)
    cont = cont & ~(ratio > 1e12)
    ratio = torch.where(cont, torch.clamp(ratio, max=1e12), 0.0)
    new_beta = beta * f * ratio[:, None]
    beta_ok = cm.valid((new_beta[:, 0], new_beta[:, 1], new_beta[:, 2]))
    beta = torch.where((cont & beta_ok)[:, None], new_beta, beta)
    alive = lane_active & cont & beta_ok
    o = torch.stack(cb.offset_ray_origin(
        tuple(hit.pos.unbind(1)), tuple(hit.pos_err.unbind(1)),
        tuple(hit.ng.unbind(1)), tuple(wi.unbind(1))), -1)
    # dead lanes may carry a zero direction (total internal reflection)
    degenerate = _rdot(wi, wi) < 1e-12
    d_next = torch.where(degenerate[:, None],
                         torch.tensor([0.0, 0.0, 1.0], device=wi.device), wi)
    alive = alive & ~degenerate

    # (5) Russian roulette
    lum = cm.luminance((beta[:, 0], beta[:, 1], beta[:, 2]))
    q = max(config.rr_threshold, 0.05)
    roulette = (lum < config.rr_threshold) & (bounce + 1 >= config.min_depth)
    killed = roulette & (u_rr < q)
    beta = torch.where((roulette & ~killed)[:, None], beta / (1.0 - q), beta)
    alive = alive & ~killed
    out.update(o=o, d=d_next, L=L, beta=beta, alive=alive, specular=specular,
               sel_prev=torch.where(lane_active, lidx, c["sel_prev"]),
               wb_prev=torch.where(lane_active, wb, c["wb_prev"]),
               nee_prev=do_nee, keys=c["keys"], orig=c["orig"])
    if textures is not None:
        # every id past the world triangles counts as a sphere, the
        # instanced triangles' too (they follow the spheres' [T, T + S)),
        # as the JAX package's composed bounce takes it; the index is
        # clamped as its gather clamps
        n_sph = scene.ktab.shape[0]
        is_sph = hit.hit & (hit.prim >= scene.n_tris)
        s_idx = torch.clamp(hit.prim - scene.n_tris, min=0, max=n_sph - 1)
        out["cone_g"] = curv_spread(scene, config, c["cone_g"], is_sph, s_idx,
                                    out["cone_w"],
                                    alive & ((kind & SPECULAR) != 0))
    return out


def initial_carry(o, d, keys) -> dict:
    """Per-lane wave state before the first bounce."""
    n = o.shape[0]
    dev = o.device
    return dict(
        o=o, d=d, L=torch.zeros(n, 3, device=dev),
        beta=torch.ones(n, 3, device=dev),
        alive=torch.ones(n, dtype=torch.bool, device=dev),
        specular=torch.zeros(n, dtype=torch.bool, device=dev),
        sel_prev=torch.zeros(n, dtype=torch.int64, device=dev),
        wb_prev=torch.zeros(n, device=dev),
        nee_prev=torch.zeros(n, dtype=torch.bool, device=dev),
        keys=keys, orig=torch.arange(n, device=dev))


def trace_wave(scene: sc.DeviceScene, camera: cam.CameraData,
               config: RenderConfig, pixel_xy, pixel_id, sample_id,
               base_key, ops: WaveOps = KERNEL_OPS,
               return_aux: bool = False, composed: bool = False):
    """Trace one wave of rays; returns (pfilm [N,2], L [N,3]).

    pixel_xy: [N,2] pixel coords (float); pixel_id / sample_id: [N]
    integer ids for the stateless sampler, all on the scene's device.
    return_aux adds {"n_invalid": count of lanes whose radiance was
    dropped as invalid} (a device scalar).  composed=True takes the
    composed bounce on any scene; a scene whose lights carry emission
    textures, which only the composed bounce reads, takes it always (as
    the JAX package's _mega_eligible decides), as does a scene with no
    triangle, world or instanced, or with no cluster tables for its
    world triangles (scene.DeviceScene.composed_only)."""
    static = scene.static
    textures = config.textures
    tex_present = None
    composed = composed or scene.composed_only
    if config.sampler == "sobol":
        # the table goes to the device once a wave
        config = dataclasses.replace(config, sobol_table=sobol.sobol_tensor(
            config.sobol_table, scene.device))
    ws = smp.WaveSampler(base_key, pixel_id, sample_id,
                         kind=config.sampler, sobol_table=config.sobol_table,
                         sample_dx=config.sample_dx,
                         sample_dy=config.sample_dy)
    pfilm = pixel_xy + ws.film_jitter()
    plens = ws.u2(2)
    if textures is None:
        o, d = cam.generate_rays(camera, pfilm, plens)
        carry = initial_carry(o, d, ws.keys)
    else:
        textures = textures.to(scene.device)
        # host-static texture channels the table uses (from NumPy)
        tex_present = mats.tex_channel_presence(scene.materials)
        # the cone's spread: the angle to the camera's x / y differential
        # rays, scaled by 1 / sqrt(spp) like the reference's
        # scale_differentials (pt.rs:142)
        o, d, rxd, ryd = cam.generate_ray_differentials(camera, pfilm,
                                                        plens)
        spread = torch.maximum(_length(rxd - d), _length(ryd - d))
        spread = spread / float(np.sqrt(np.float32(max(config.spp, 1))))
        carry = initial_carry(o, d, ws.keys)
        carry["cone_w"] = torch.zeros_like(spread)
        carry["cone_g"] = spread
    for bounce in range(config.max_depth):
        n_alive = None
        if config.compact:
            perm, n_alive = _compact_perm(carry["alive"])
            carry = _permute(carry, perm)
        c = carry
        if composed:
            carry = composed_bounce(scene, config, c, bounce, n_alive, ops,
                                    textures, tex_present)
            continue
        raw = intersect_raw(scene, c["o"], c["d"], n_alive, ops)
        u_sel, u_light, u_bsdf, u_rr = bounce_draws(config, c["keys"],
                                                    bounce)
        lidx, selpdf = nee.sample_one_light(scene, u_sel)
        if textures is None:
            xt = pack_bounce_input(c, raw, lidx, selpdf, u_light, u_bsdf,
                                   u_rr, bounce)
            out_t = ops.bounce_shade(xt, scene.ltab, scene.mtab,
                                     scene.stab, static, config.min_depth,
                                     float(config.rr_threshold),
                                     n_alive=n_alive)
        else:
            # the textured split: hit kernel, texel lookups, shade
            # kernel; the hit geometry is detached, as in the JAX package
            hi = cb.unpack_hit_t(ops.hit_shade(
                pack_hit_input(c, raw).detach(), scene.stab))
            res = mats.resolve_params(
                scene.mtab, hi["mat_id"], hi["ns"], hi["ng"], hi["dpdu"],
                uv=hi["uv"], textures=textures, dpdv=hi["dpdv"],
                duvdx=hi["duvdx"], duvdy=hi["duvdy"],
                tex_filter=config.tex_filter, tex_present=tex_present)
            xs = pack_shade_input(c, raw, hi, res, lidx, selpdf, u_light,
                                  u_bsdf, u_rr, bounce)
            out_t = ops.shade_split(xs, scene.ltab, static,
                                    config.min_depth,
                                    float(config.rr_threshold),
                                    n_alive=n_alive)
        r = cb.unpack_out_t(out_t)
        blocked = occluded(scene, r["sh_o"].contiguous(),
                           r["sh_d"].contiguous(), r["sh_t"].contiguous(),
                           n_alive, ops)
        L = r["L"] + torch.where((r["need_shadow"] & ~blocked)[:, None],
                                 r["contrib"], 0.0)
        carry = dict(o=r["o"].contiguous(), d=r["d"].contiguous(), L=L,
                     beta=r["beta"], alive=r["alive"],
                     specular=r["specular"], sel_prev=r["sel_prev"],
                     wb_prev=r["wb_prev"], nee_prev=r["nee_prev"],
                     keys=c["keys"], orig=c["orig"])
        if textures is not None:
            carry["cone_w"] = hi["cone_w"]
            carry["cone_g"] = curv_spread(
                scene, config, c["cone_g"], raw["is_sphere"], raw["s_idx"],
                hi["cone_w"], r["alive"] & r["specular"] & raw["hit"])

    # final deferred-MIS collection at the last vertex (the reference's
    # evaluate_direct bsdf-branch re-intersection, scene.rs:146-155)
    if config.max_depth > 0 and config.defer_final_mis:
        need = carry["alive"] & carry["nee_prev"]
        n_need = None
        if config.compact:
            perm, n_need = _compact_perm(need)
            carry = _permute(carry, perm)
            need = need[perm]
        if composed:
            # the final hit's emission through the light's texture
            hf = sc.intersect(
                scene, carry["o"], carry["d"], n_alive=n_need,
                closest_hit=ops.closest_hit,
                closest_hit_instanced=ops.closest_hit_instanced)
            hit_f, light_f = hf.hit, hf.light_id
            le_f = sc.light_emission(scene, light_f, hf.uv, textures)
        else:
            hit_f, light_f = intersect_light(scene, carry["o"], carry["d"],
                                             n_need, ops)
            e0 = static.emi_cols[0]
            le_f = scene.ltab[torch.clamp(light_f, min=0), e0:e0 + 3]
        gate = need & hit_f & (light_f >= 0) \
            & (light_f == carry["sel_prev"])
        carry["L"] = carry["L"] + torch.where(
            gate[:, None], carry["wb_prev"][:, None] * carry["beta"] * le_f,
            0.0)

    # restore the original lane order
    L = torch.empty_like(carry["L"])
    L[carry["orig"]] = carry["L"]
    ok = cm.valid((L[:, 0], L[:, 1], L[:, 2]))
    L = torch.where(ok[:, None], L, 0.0)
    if return_aux:
        return pfilm, L, {"n_invalid": (~ok).sum()}
    return pfilm, L


def wave_pixels(ray_idx, w: int, spp: int):
    """(pixel_xy [N,2], pixel_id, sample_id) of ray indices in the
    pixel-major order (ray = pixel * spp + sample)."""
    pixel_id = ray_idx // spp
    sample_id = ray_idx % spp
    pixel_xy = torch.stack([(pixel_id % w).to(torch.float32),
                            (pixel_id // w).to(torch.float32)], -1)
    return pixel_xy, pixel_id, sample_id


def _wave(film_cfg: flm.FilmConfig, config: RenderConfig, size: int):
    """(rays a wave, rays a frame): min(wave_size, frame) rounded up to a
    multiple of the ray group's size."""
    w, h = film_cfg.resolution
    total = w * h * config.spp
    wave = min(config.wave_size, total)
    return -(-wave // size) * size, total


def render_wave(scene: sc.DeviceScene, camera: cam.CameraData,
                film_cfg: flm.FilmConfig, config: RenderConfig, state, i: int,
                ops: WaveOps = KERNEL_OPS, composed: bool = False, mesh=None):
    """Trace wave i of a render (the rays i * wave .. of the pixel-major
    order, wave as render_film_init's) and splat it into the film state
    in place.  With a ray group (parallel/mesh.RayMesh) only this rank's
    contiguous shard of the wave is traced and splatted: the film is
    then this rank's share, which the caller sums over the ranks.
    Returns the count of invalid radiance samples (a device scalar)."""
    dev = scene.device
    w, _ = film_cfg.resolution
    spp = config.spp
    wave, total = _wave(film_cfg, config, 1 if mesh is None else mesh.size)
    ray_idx = i * wave + torch.arange(wave, dtype=torch.int64, device=dev)
    first = i * wave
    if mesh is not None:
        ray_idx = mesh.shard(ray_idx)
        first += mesh.rank * ray_idx.shape[0]
    pixel_xy, pixel_id, sample_id = wave_pixels(ray_idx, w, spp)
    valid = ray_idx < total
    with torch.no_grad():
        pfilm, L, aux = trace_wave(scene, camera, config, pixel_xy,
                                   pixel_id, sample_id,
                                   smp.make_base_key(config.seed), ops=ops,
                                   return_aux=True, composed=composed)
    if state.padded:
        flm.film_splat_pixmajor(film_cfg, state, pfilm - pixel_xy, L,
                                first // spp, spp, mask=valid)
    else:
        flm.film_splat(film_cfg, state, pfilm, L, mask=valid)
    return aux["n_invalid"]


def render_film_init(scene: sc.DeviceScene, film_cfg: flm.FilmConfig,
                     config: RenderConfig, size: int = 1):
    """The empty film of a render over `size` ranks and its wave count:
    (state, wave, n_waves).  The scatter-free splat needs each rank's
    shard of a wave to be whole pixels of the pixel-major order and the
    waves to tile the frame exactly; other waves take the scatter
    splat."""
    wave, total = _wave(film_cfg, config, size)
    dense = (wave // size) % config.spp == 0 and total % wave == 0
    return (flm.film_init(film_cfg, scene.device, padded=dense), wave,
            (total + wave - 1) // wave)


def render(scene: sc.DeviceScene, camera: cam.CameraData,
           film_cfg: flm.FilmConfig, config: RenderConfig,
           ops: WaveOps = KERNEL_OPS, progress: bool = False,
           composed: bool = False, checkpoint_path: Optional[str] = None,
           checkpoint_every: int = 0, mesh=None):
    """Full render on the scene's device: iterate waves over
    (pixels x spp), splat to the film, finalize.  Returns [H, W, 3].
    composed: as in trace_wave.

    mesh: a ray group (parallel/mesh.RayMesh; None renders alone).  The
    wave is then rounded up to a multiple of the group's size, each rank
    traces its shard of every wave into its own film, and one sum
    all-reduce of rgb and weight merges the films before the finalize;
    every rank returns the same image.

    checkpoint_path: resume from the file when it exists and holds the
    same seed, wave size and film shape (and, in a group of more than one
    rank, the same rank and size: the file then holds this rank's share
    of the film, so each rank wants a path of its own), and save the film
    and the ray cursor there every `checkpoint_every` waves and at the
    end (utils.py).  The counter-based sampler makes the resumed render
    bit-identical to an uninterrupted one.

    Each wave runs in the named phase "pt rendering", the ranks' merge in
    "film all-reduce" and the finalize in "pt add sample"
    (utils.profile_phase)."""
    from arendur_tpu_torch import utils
    size = 1 if mesh is None else mesh.size
    state, wave, n_waves = render_film_init(scene, film_cfg, config, size)
    meta = {"wave": wave}
    if size > 1:
        meta.update(rank=mesh.rank, size=size)
    start_wave = 0
    if checkpoint_path:
        ck = utils.load_checkpoint(checkpoint_path, scene.device)
        if ck is not None:
            st, next_ray, seed, ck_meta = ck
            if seed == config.seed and st.rgb.shape == state.rgb.shape \
                    and all(ck_meta.get(k) == v for k, v in meta.items()):
                state, start_wave = st, next_ray // wave
                log.info("resumed at wave %d/%d from %s", start_wave,
                         n_waves, checkpoint_path)
    for i in range(start_wave, n_waves):
        with utils.profile_phase("pt rendering"):
            n_invalid = render_wave(scene, camera, film_cfg, config, state,
                                    i, ops=ops, composed=composed, mesh=mesh)
        if progress:
            ni = int(n_invalid)
            if ni:
                log.warning("wave %d: dropped %d invalid radiance samples",
                            i, ni)
            log.info("wave %d/%d done", i + 1, n_waves)
        if checkpoint_path and checkpoint_every \
                and (i + 1) % checkpoint_every == 0:
            utils.save_checkpoint(checkpoint_path, state, (i + 1) * wave,
                                  config.seed, meta=meta)
    if checkpoint_path:
        utils.save_checkpoint(checkpoint_path, state, n_waves * wave,
                              config.seed, meta=meta)
    if mesh is not None:
        # the ranks' films summed once (the reference's tile merge): the
        # film is a plain sum, read only by the finalize
        with utils.profile_phase("film all-reduce"):
            mesh.all_reduce_(state.rgb)
            mesh.all_reduce_(state.weight)
    with utils.profile_phase("pt add sample"):
        return flm.film_finalize(state, film_cfg)
