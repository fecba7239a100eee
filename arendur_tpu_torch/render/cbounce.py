"""The fused bounce shade over the lane-transposed wave (port of
arendur_tpu/render/cbounce.py:77-811 and its column contract).

One bounce's whole shade — hit shading info, emission with the
deferred-MIS weight, the material recipe (``build_slots``), the NEE
light sample with BSDF eval/pdf and MIS, the BSDF mixture sample, the
next deferred-MIS weight, beta and Russian roulette, and the spawn
offset — reads one [IN_COLS=58, N] input and writes one
[OUT_COLS=32, N] output (the layout of pallas_bounce.py:64-86).

``cbody_reference`` is the plain PyTorch version; ``bounce_shade_t``
dispatches on the input's device: a CUDA tensor launches the
hand-written kernel (kernels/cbounce.cu, which replaces the Pallas
kernel ``cbounce._kernel``), a CPU tensor runs the plain version.
Gradients: on CUDA tensors the kernel's autograd.Function backward
launches the hand-written backward kernel (kernels/cbounce_bwd.cu,
which replaces the Pallas kernel ``cbounce._bwd_kernel``); on CPU
tensors autograd runs over the plain body.  ``cbody_vjp_reference`` is
the backward kernel's plain version.

Textured scenes split the bounce in two around the texel lookups (port
of arendur_tpu/render/cbounce.py:814-948, 1185-1338): ``cbody_hit``
([HIT_IN_COLS=41, N] -> [HIT_OUT_COLS=28, N]: hit info, uv and the
ray-cone uv footprint) and ``cbody_shade`` ([SHADE_IN_COLS=50, N] ->
[OUT_COLS, N]: the shade proper on texture-resolved material columns).
``hit_shade_t`` / ``shade_split_t`` dispatch them like
``bounce_shade_t``: CUDA tensors launch kernels/cbounce_split.cu
(replacing the Pallas kernels ``cbounce._kernel_hit`` and
``_kernel_shade``), CPU tensors run ``cbody_hit_reference`` /
``cbody_shade_reference``.  The split shade's backward is autograd over
its plain body on either device, as the JAX package's is.

Scene-table rows are direct indexed loads (no row cap).

The dead-lane contract: every entry takes ``n_alive``, the wave's live
count after compaction (a device scalar; None: every lane is live).
Lanes below it are shaded as the body shades them.  A lane at or past
it (alive first, so it is not alive) skips the body: its L, beta,
specular, sel_prev and wb_prev pass through, alive, nee_prev,
need_shadow and contrib are 0, and its rays take constants
(``dead_lane_out``).  Nothing reads those lanes (the intersect kernels
treat them as misses, the deferred MIS gates on alive, the unpermute
reads L, which equals the body's), and their VJP is the identity on the
carried values (``bwd_pass_through``).  The JAX package shades every
lane; on those lanes beta and the ray columns differ from its body's.
"""

from __future__ import annotations

import math

import torch

from arendur_tpu_torch.render import cmath as cm
from arendur_tpu_torch.render.cmath import (
    W, vadd, vsub, vneg, vscale, vdot, vcross, vnormalize, vwhere,
    vzero_like, vlength2)
from arendur_tpu_torch.bxdf.types import (
    ALL, ALL_NON_SPECULAR, SPECULAR, KIND_OF_TYPE,
    T_LAMBERT_R, T_LAMBERT_T, T_OREN_NAYAR, T_FRESNEL_SPEC,
    T_TS_R, T_TS_T, T_ASHIKHMIN)
from arendur_tpu_torch import materials as mats
from arendur_tpu_torch import scene as sc
from arendur_tpu_torch.shapes import sphere as sph

PI = math.pi
_GAMMA7 = 7.0 * 2.0 ** -24 / (1.0 - 7.0 * 2.0 ** -24)

# fixed input column layout (integrator.trace_wave packs it)
C_O = 0          # 0:3
C_D = 3          # 3:6
C_T = 6
C_HIT = 7
C_IS_SPH = 8
C_S_IDX = 9
C_PLOCAL = 10    # 10:13
C_TROW = 13      # 13:39
C_BETA = 39      # 39:42
C_L = 42         # 42:45
C_SPECULAR = 45
C_SEL_PREV = 46
C_WB_PREV = 47
C_NEE_PREV = 48
C_ALIVE = 49
C_LIDX = 50
C_SELPDF = 51
C_U_LIGHT = 52   # 52:54
C_U_BSDF = 54    # 54:56
C_U_RR = 56
C_BOUNCE = 57
IN_COLS = 58
OUT_COLS = 32
OUT_L = 6         # output L: 6:9
OUT_BETA = 9      # output beta: 9:12
OUT_WB_PREV = 15


# ---------------------------------------------------------------------------
# per-lane table-row select
# ---------------------------------------------------------------------------

class CRow:
    """Per-lane row select from a small [R, C] table: ``col_abs(j)``
    is column j of each lane's row (a direct indexed load).  Indices
    outside [0, R) read row 0, as the JAX where-chain does."""

    def __init__(self, tab: torch.Tensor, idx: torch.Tensor, cidx=None):
        n = tab.shape[0]
        self._tab = tab
        self._idx = W((idx >= 0) & (idx < n), idx, 0).long()
        self._cidx = cidx
        self._cache = {}

    def col_abs(self, j: int):
        if j not in self._cache:
            self._cache[j] = self._tab[:, j][self._idx]
        return self._cache[j]

    def col1(self, name: str, ofs: int = 0):
        return self.col_abs(self._cidx[name][0] + ofs)

    def col3(self, name: str):
        lo = self._cidx[name][0]
        return (self.col_abs(lo), self.col_abs(lo + 1),
                self.col_abs(lo + 2))

    def col16(self, name: str):
        lo = self._cidx[name][0]
        return tuple(self.col_abs(lo + j) for j in range(16))


# ---------------------------------------------------------------------------
# geometry twins (scene.py / shapes/)
# ---------------------------------------------------------------------------

def bary_from_vertices(o, d, v0, v1, v2):
    """Twin: scene._bary_from_vertices."""
    e1 = vsub(v1, v0)
    e2 = vsub(v2, v0)
    pvec = vcross(d, e2)
    det = vdot(e1, pvec)
    inv = 1.0 / W(torch.abs(det) > 1e-20, det, 1.0)
    tvec = vsub(o, v0)
    u = vdot(tvec, pvec) * inv
    v = vdot(d, vcross(tvec, e1)) * inv
    return 1.0 - u - v, u


def tri_dpduv(v0, v1, v2, uv0, uv1, uv2):
    """Twin: triangle.tri_dpduv.  uv* are (u, v) tuples."""
    duv02 = (uv0[0] - uv2[0], uv0[1] - uv2[1])
    duv12 = (uv1[0] - uv2[0], uv1[1] - uv2[1])
    dp02 = vsub(v0, v2)
    dp12 = vsub(v1, v2)
    det = duv02[0] * duv12[1] - duv02[1] * duv12[0]
    ok = det != 0.0
    inv = 1.0 / W(ok, det, 1.0)
    dpdu = vscale(vsub(vscale(dp02, duv12[1]), vscale(dp12, duv02[1])),
                  inv)
    dpdv = vscale(vadd(vscale(dp02, -duv12[0]), vscale(dp12, duv02[0])),
                  inv)
    ng = vcross(dp02, vsub(v0, v1))
    fb_u = vnormalize(dp02)
    fb_v = vnormalize(vcross(ng, dp02))
    return vwhere(ok, dpdu, fb_u), vwhere(ok, dpdv, fb_v)


def tri_shading_from_row(tcol, b0, b1):
    """Twin: scene.tri_shading_from_row over the 26 packed triangle
    columns (tcol(j) is column j, per lane)."""
    v0 = (tcol(0), tcol(1), tcol(2))
    v1 = (tcol(3), tcol(4), tcol(5))
    v2 = (tcol(6), tcol(7), tcol(8))
    b2 = 1.0 - b0 - b1
    pos = vadd(vadd(vscale(v0, b0), vscale(v1, b1)), vscale(v2, b2))
    perr = vscale(vadd(vadd(cm.vabs(vscale(v0, b0)),
                            cm.vabs(vscale(v1, b1))),
                       cm.vabs(vscale(v2, b2))), _GAMMA7)
    uv0 = (tcol(18), tcol(19))
    uv1 = (tcol(20), tcol(21))
    uv2 = (tcol(22), tcol(23))
    dpdu, dpdv = tri_dpduv(v0, v1, v2, uv0, uv1, uv2)
    n0 = (tcol(9), tcol(10), tcol(11))
    n1 = (tcol(12), tcol(13), tcol(14))
    n2 = (tcol(15), tcol(16), tcol(17))
    ns_raw = vnormalize(
        vadd(vadd(vscale(n0, b0), vscale(n1, b1)), vscale(n2, b2)))
    return pos, perr, dpdu, dpdv, ns_raw


def sphere_shading_from_row(srow: CRow, p_local):
    """Twin: sphere.sphere_shading_from_row (shade_table layout:
    o2w 0:16, radius 16, thetamin 17, thetamax 18, phimax 19)."""
    o2w = tuple(srow.col_abs(j) for j in range(16))
    radius = srow.col_abs(16)
    thetamin = srow.col_abs(17)
    thetamax = srow.col_abs(18)
    phimax = srow.col_abs(19)
    p = p_local
    thetadelta = thetamax - thetamin
    theta = cm.acos_poly(torch.clamp(p[2] / cm._max(radius, 1e-20),
                                     -1.0 + 1e-7, 1.0 - 1e-7))
    inv_zr = 1.0 / torch.sqrt(cm._max(p[0] * p[0] + p[1] * p[1], 1e-30))
    cphi = p[0] * inv_zr
    sphi = p[1] * inv_zr
    dpdu_l = (-phimax * p[1], phimax * p[0], torch.zeros_like(phimax))
    dpdv_l = vscale((p[2] * cphi, p[2] * sphi,
                     -radius * torch.sin(theta)), thetadelta)
    pos = cm.tp16(o2w, p)
    dpdu = cm.tv16(o2w, dpdu_l)
    dpdv = cm.tv16(o2w, dpdv_l)
    ng = vnormalize(vcross(dpdu, dpdv))
    pos_err = vscale(cm.vabs(pos), 5.0 * 2.0 ** -24)
    return pos, ng, dpdu, dpdv, pos_err


class _NextAfter(torch.autograd.Function):
    """nextafter with the derivative of the identity (one ulp)."""

    @staticmethod
    def forward(ctx, p, q):
        return torch.nextafter(p, q)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _nextafter(p, q):
    if p.requires_grad:
        return _NextAfter.apply(p, q)
    return torch.nextafter(p, q)


def offset_ray_origin(pos, pos_err, n, d):
    """Twin: scene.offset_ray_origin (per-component): shift along +/-n
    by the error bound, then nudge one ulp away."""
    edn = (torch.abs(n[0]) * pos_err[0] + torch.abs(n[1]) * pos_err[1]
           + torch.abs(n[2]) * pos_err[2])
    sgn = W(vdot(d, n) <= 0.0, -edn, edn)
    out = []
    for c in range(3):
        off = sgn * n[c]
        p = pos[c] + off
        up = _nextafter(p, torch.full_like(p, math.inf))
        down = _nextafter(p, torch.full_like(p, -math.inf))
        out.append(W(off > 0.0, up, W(off < 0.0, down, p)))
    return tuple(out)


# ---------------------------------------------------------------------------
# NEE twins (lighting/nee.py)
# ---------------------------------------------------------------------------

def _sample_sphere_local_row(radius, zmin, zmax, thetamin, thetamax,
                             phimax, u2, theta_uniform=None):
    """Twin: nee._sample_sphere_local_row (theta_uniform None: the
    module's THETA_UNIFORM_COMPAT)."""
    if theta_uniform is None:
        theta_uniform = sph.THETA_UNIFORM_COMPAT
    phi = u2[0] * phimax
    if theta_uniform:
        theta = u2[1] * (thetamax - thetamin) + thetamin
    else:
        z = zmin / radius + u2[1] * (zmax - zmin) / radius
        theta = cm.acos_poly(torch.clamp(z, -1.0 + 1e-7, 1.0 - 1e-7))
    st = torch.sin(theta)
    nrm = (st * torch.cos(phi), st * torch.sin(phi), torch.cos(theta))
    p = vscale(nrm, radius)
    area = phimax * radius * (zmax - zmin)
    return p, nrm, 1.0 / area


def light_sample_rows(lrow: CRow, present, pos, u2, need_uv: bool = False,
                      need_nl: bool = False):
    """Twin: nee.light_sample_rows.  need_uv adds "uv", the (u, v) of
    the sampled light point (the emission-texture lookup of the composed
    path); need_nl adds "nl", the light's surface normal there (-wi on
    the lanes of a point, spot or distant light; BPT's s = 1 strategy
    reads it); the bounce shade runs without either, as the JAX kernels
    do."""
    has = lambda t: present is None or t in present
    lt = lrow.col1("ltype").to(torch.int32)
    emission = lrow.col3("emission")
    sgv = lambda v: (v[0].detach(), v[1].detach(), v[2].detach())
    zero1 = torch.zeros_like(pos[0])
    zero3 = (zero1, zero1, zero1)

    if has(sc.L_AREA_SPHERE):
        w2o = lrow.col16("s_w2o")
        o2w = lrow.col16("s_o2w")
        pos_local = cm.tp16(w2o, pos)
        lp_l, ln_l, pdf_area_s = _sample_sphere_local_row(
            lrow.col1("s_radius"), lrow.col1("s_zmin"),
            lrow.col1("s_zmax"), lrow.col1("s_thetamin"),
            lrow.col1("s_thetamax"), lrow.col1("s_phimax"), u2)
        lp_l, ln_l = sgv(lp_l), sgv(ln_l)
        wi_l = vsub(lp_l, pos_local)
        d2_l = vlength2(wi_l)
        wi_ln = vscale(wi_l, torch.rsqrt(cm._max(d2_l, 1e-20)))
        denom = torch.abs(vdot(ln_l, wi_ln))
        inv_den = W(denom > 1e-20, 1.0 / cm._max(denom, 1e-20), 0.0)
        pdf_s = pdf_area_s * d2_l * inv_den
        pdf_s = W((d2_l < 1e-12) | ~torch.isfinite(pdf_s), 0.0, pdf_s)
        front_s = vdot(vsub(pos_local, lp_l), ln_l) > 0.0
        pfrom_s = cm.tp16(o2w, lp_l)
        rad_s = vwhere(front_s, emission, zero3)
        if need_uv:
            uv_s = sc.sphere_uv(
                torch.stack(lp_l, -1), lrow.col1("s_radius"),
                lrow.col1("s_thetamin"), lrow.col1("s_thetamax"),
                lrow.col1("s_phimax"))[:2]
        if need_nl:
            nl_s = vnormalize(cm.tv16(o2w, ln_l))
    else:
        pfrom_s, rad_s, pdf_s = zero3, zero3, zero1
        uv_s = (zero1, zero1)
        nl_s = zero3

    has_tris = has(sc.L_AREA_TRI) and "tri_v0" in lrow._cidx
    if has_tris:
        bary = sgv(cm.sample_uniform_triangle(u2))
        v0 = lrow.col3("tri_v0")
        v1 = lrow.col3("tri_v1")
        v2 = lrow.col3("tri_v2")
        n0 = lrow.col3("tri_n0")
        n1 = lrow.col3("tri_n1")
        n2 = lrow.col3("tri_n2")
        lp_t = vadd(vadd(vscale(v0, bary[0]), vscale(v1, bary[1])),
                    vscale(v2, bary[2]))
        ln_t = vnormalize(
            vadd(vadd(vscale(n0, bary[0]), vscale(n1, bary[1])),
                 vscale(n2, bary[2])))
        area_t = 0.5 * torch.sqrt(cm._max(
            vlength2(vcross(vsub(v1, v0), vsub(v2, v0))), 1e-30))
        pdf_area_t = 1.0 / area_t
        wi_t = vsub(lp_t, pos)
        d2_t = vlength2(wi_t)
        wi_tn = vscale(wi_t, torch.rsqrt(cm._max(d2_t, 1e-20)))
        denom_t = torch.abs(vdot(ln_t, wi_tn))
        inv_den_t = W(denom_t > 1e-20, 1.0 / cm._max(denom_t, 1e-20), 0.0)
        pdf_t = pdf_area_t * d2_t * inv_den_t
        pdf_t = W((d2_t < 1e-12) | ~torch.isfinite(pdf_t), 0.0, pdf_t)
        front_t = vdot(vsub(pos, lp_t), ln_t) > 0.0
        rad_t = vwhere(front_t, emission, zero3)
        if need_uv:
            uv0 = (lrow.col1("tri_uv0"), lrow.col1("tri_uv0", 1))
            uv1 = (lrow.col1("tri_uv1"), lrow.col1("tri_uv1", 1))
            uv2 = (lrow.col1("tri_uv2"), lrow.col1("tri_uv2", 1))
            uv_t = tuple(bary[0] * uv0[j] + bary[1] * uv1[j]
                         + bary[2] * uv2[j] for j in range(2))
    else:
        lp_t, pdf_t, rad_t = zero3, zero1, zero3
        uv_t = (zero1, zero1)
        ln_t = None

    lpos = lrow.col3("pos")
    if has(sc.L_POINT) or has(sc.L_SPOT):
        wi_p = vsub(lpos, pos)
        d2_p = vlength2(wi_p)
        rad_p = vscale(emission, 1.0 / cm._max(d2_p, 1e-20))
    else:
        rad_p = zero3
    pdf_p = torch.ones_like(zero1)

    if has(sc.L_SPOT):
        axis = vnormalize(lrow.col3("aux"))
        cos_total = lrow.col1("params")
        cos_falloff = lrow.col1("params", 1)
        wi_pn = vscale(wi_p, torch.rsqrt(cm._max(d2_p, 1e-20)))
        cos_to = vdot(vneg(wi_pn), axis)
        tt = torch.clamp((cos_to - cos_total)
                         / cm._max(cos_falloff - cos_total, 1e-8),
                         0.0, 1.0)
        falloff = W(cos_to < cos_total, 0.0,
                    W(cos_to > cos_falloff, 1.0, (tt * tt) * (tt * tt)))
        rad_sp = vscale(rad_p, falloff)
    else:
        rad_sp = zero3

    if has(sc.L_DISTANT):
        ldir = vnormalize(lpos)
        wr = lrow.col1("params")
        pfrom_d = vsub(pos, vscale(ldir, 2.0 * cm._max(wr, 1e-6)))
        rad_d = emission
    else:
        pfrom_d, rad_d = zero3, zero3
    pdf_d = torch.ones_like(zero1)

    def pick(sphere_v, tri_v, point_v, spot_v, distant_v, default,
             vec=False):
        w = vwhere if vec else W
        out = default
        if has(sc.L_AREA_TRI):
            out = w(lt == sc.L_AREA_TRI, tri_v, out)
        if has(sc.L_AREA_SPHERE):
            out = w(lt == sc.L_AREA_SPHERE, sphere_v, out)
        if has(sc.L_POINT):
            out = w(lt == sc.L_POINT, point_v, out)
        if has(sc.L_SPOT):
            out = w(lt == sc.L_SPOT, spot_v, out)
        if has(sc.L_DISTANT):
            out = w(lt == sc.L_DISTANT, distant_v, out)
        return out

    pfrom = pick(pfrom_s, lp_t, lpos, lpos, pfrom_d, zero3, vec=True)
    radiance = pick(rad_s, rad_t, rad_p, rad_sp, rad_d, zero3, vec=True)
    pdf = pick(pdf_s, pdf_t, pdf_p, pdf_p, pdf_d, zero1)
    wi = vnormalize(vsub(pfrom, pos))
    if present is not None and not (
            sc.L_POINT in present or sc.L_SPOT in present):
        delta = torch.zeros_like(lt, dtype=torch.bool)
    else:
        delta = (lt == sc.L_POINT) | (lt == sc.L_SPOT)
    out = dict(radiance=radiance, pdf=pdf, pfrom=pfrom, wi=wi, delta=delta)
    if need_uv:
        out["uv"] = tuple(pick(uv_s[j], uv_t[j], zero1, zero1, zero1, zero1)
                          for j in range(2))
    if need_nl:
        mwi = vneg(wi)
        out["nl"] = pick(nl_s, mwi if ln_t is None else ln_t, mwi, mwi, mwi,
                         mwi, vec=True)
    return out


def _masked_ratio(hit, num, den):
    """num / den where hit and the ratio is finite, else 0 (double
    where: the lanes that are not kept divide 0 by 1, so their zero
    cotangent meets no infinite partial and stays 0)."""
    ok = hit & torch.isfinite(num.detach() / den.detach())
    return W(ok, W(ok, num, 0.0) / W(ok, den, 1.0), 0.0)


def light_pdf_wi_rows(lrow: CRow, present, pos, wi,
                      full_phi_spheres: bool = False):
    """Twin: nee.light_pdf_wi_rows."""
    has = lambda t: present is None or t in present
    lt = lrow.col1("ltype").to(torch.int32)
    zero1 = torch.zeros_like(pos[0])
    inf = torch.full_like(zero1, math.inf)

    if has(sc.L_AREA_SPHERE):
        w2o = lrow.col16("s_w2o")
        pos_l = cm.tp16(w2o, pos)
        wi_l = cm.tv16(w2o, wi)
        radius = lrow.col1("s_radius")
        hit_s, t_s, p_l = sph.intersect_local(
            pos_l, wi_l, inf, radius, lrow.col1("s_zmin"),
            lrow.col1("s_zmax"), lrow.col1("s_phimax"),
            skip_phi_clip=full_phi_spheres)
        n_l = vscale(p_l, torch.rsqrt(cm._max(vlength2(p_l), 1e-20)))
        area_s = (lrow.col1("s_phimax") * radius
                  * (lrow.col1("s_zmax") - lrow.col1("s_zmin")))
        d2_s = vlength2(vsub(p_l, pos_l))
        den_s = cm._max(torch.abs(vdot(wi_l, n_l)), 1e-20) * area_s
        pdf_s = _masked_ratio(hit_s, d2_s, den_s)
    else:
        pdf_s = zero1

    if has(sc.L_AREA_TRI) and "tri_v0" in lrow._cidx:
        v0 = lrow.col3("tri_v0")
        v1 = lrow.col3("tri_v1")
        v2 = lrow.col3("tri_v2")
        e1 = vsub(v1, v0)
        e2 = vsub(v2, v0)
        pvec = vcross(wi, e2)
        det = vdot(e1, pvec)
        ok = torch.abs(det) > 1e-12
        inv = 1.0 / W(ok, det, 1.0)
        tvec = vsub(pos, v0)
        u = vdot(tvec, pvec) * inv
        qvec = vcross(tvec, e1)
        v = vdot(wi, qvec) * inv
        t_t = vdot(e2, qvec) * inv
        hit_t = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) \
            & (t_t > 1e-6)
        t_t = W(hit_t, t_t, math.inf)
        ng = vnormalize(vcross(e1, e2))
        area_t = 0.5 * torch.sqrt(cm._max(vlength2(vcross(e1, e2)),
                                          1e-30))
        d2_t = t_t * t_t
        den_t = cm._max(torch.abs(vdot(wi, ng)), 1e-20) * area_t
        pdf_t = _masked_ratio(hit_t, d2_t, den_t)
    else:
        pdf_t = zero1

    return W(lt == sc.L_AREA_SPHERE, pdf_s,
             W(lt == sc.L_AREA_TRI, pdf_t, 0.0))


def direct_light_contrib(ls, f_raw, spdf, ns):
    """Twin: nee.direct_light_contrib."""
    wi = ls["wi"]
    no_effect = (ls["pdf"] == 0.0) | cm.is_black(ls["radiance"])
    f = vscale(f_raw, torch.abs(vdot(wi, ns)))
    f = vwhere(spdf == 0.0, vzero_like(spdf), f)
    need_shadow = ~no_effect & ~cm.is_black(f)
    inv_lpdf = W(ls["pdf"] > 1e-18, 1.0 / cm._max(ls["pdf"], 1e-18), 0.0)
    w_mis = cm.power_heuristic(1, ls["pdf"], 1, spdf)
    contrib_delta = vscale(cm.vmul(ls["radiance"], f), inv_lpdf)
    contrib_area = vscale(contrib_delta, w_mis)
    contrib = vwhere(ls["delta"], contrib_delta, contrib_area)
    contrib = vwhere(need_shadow & ~no_effect, contrib, vzero_like(spdf))
    return cm.sanitize(contrib), need_shadow


def path_mis_weight_rows(lrow: CRow, present, selpdf, pos, wi2, pdf2,
                         kind2, f2, full_phi_spheres: bool = False):
    """Twin: nee.path_mis_weight_rows."""
    lt = lrow.col1("ltype").to(torch.int32)
    is_spec = (kind2 & SPECULAR) != 0
    lpdf = light_pdf_wi_rows(lrow, present, pos, wi2,
                             full_phi_spheres=full_phi_spheres)
    if present is not None and not (
            sc.L_POINT in present or sc.L_SPOT in present):
        delta = torch.zeros_like(lt, dtype=torch.bool)
    else:
        delta = (lt == sc.L_POINT) | (lt == sc.L_SPOT)
    active = (~delta & ~cm.is_black(f2) & (pdf2 > 0.0)
              & (is_spec | (lpdf > 0.0)))
    w2 = W(is_spec, 1.0, cm.power_heuristic(1, pdf2, 1, lpdf))
    return W(active, w2 / cm._max(selpdf, 1e-20), 0.0)


# ---------------------------------------------------------------------------
# material recipe twin (materials.build_slots)
# ---------------------------------------------------------------------------

def build_slots(mtype, kd, ks, sigma, rough, eta, dissolve,
                ns, ng, dpdu, presence=None, dist_sets=None):
    """Twin: materials.build_slots (component form; K = MAX_SLOTS)."""
    K = mats.MAX_SLOTS
    alpha = cm.roughness_to_alpha(rough)
    sigma_c = torch.clamp(sigma, 0.0, 90.0)
    kd_black = cm.is_black(kd)
    ks_black = cm.is_black(ks)

    zi = torch.zeros_like(mtype)
    zf = torch.zeros_like(sigma)
    z3 = (zf, zf, zf)
    ktype = [zi for _ in range(K)]
    kc0 = [z3 for _ in range(K)]
    kc1 = [z3 for _ in range(K)]
    kp0 = [zf for _ in range(K)]
    kp1 = [zf for _ in range(K)]
    kp2 = [zf for _ in range(K)]
    kdist = [zi for _ in range(K)]

    def put(slot, mask, stype, c0=None, c1=None, p0=None, p1=None,
            p2=None, dist=None):
        ktype[slot] = W(mask, stype, ktype[slot])
        if c0 is not None:
            kc0[slot] = vwhere(mask, c0, kc0[slot])
        if c1 is not None:
            kc1[slot] = vwhere(mask, c1, kc1[slot])
        if p0 is not None:
            kp0[slot] = W(mask, p0, kp0[slot])
        if p1 is not None:
            kp1[slot] = W(mask, p1, kp1[slot])
        if p2 is not None:
            kp2[slot] = W(mask, p2, kp2[slot])
        if dist is not None:
            kdist[slot] = W(mask, dist, kdist[slot])

    one = torch.ones_like(zf)
    clip3 = lambda c: (torch.clamp(c[0], 0.0, 1.0),
                       torch.clamp(c[1], 0.0, 1.0),
                       torch.clamp(c[2], 0.0, 1.0))

    matte = mtype == mats.M_MATTE
    s2 = sigma_c * sigma_c
    on_a = 1.0 - s2 / (2.0 * (s2 + 0.33))
    on_b = 0.45 * s2 / (s2 + 0.09)
    m_lam = matte & ~kd_black & (sigma_c == 0.0)
    m_on = matte & ~kd_black & (sigma_c != 0.0)
    put(0, m_lam, T_LAMBERT_R, c0=kd)
    put(0, m_on, T_OREN_NAYAR, c0=kd, p0=on_a, p1=on_b)

    plastic = mtype == mats.M_PLASTIC
    put(0, plastic, T_ASHIKHMIN, c0=clip3(kd), c1=clip3(ks), p0=alpha,
        dist=zi + mats.RECIPE_DISTS[mats.M_PLASTIC][T_ASHIKHMIN])

    glass = mtype == mats.M_GLASS
    g_spec = glass & ~ks_black
    g_diff = glass & ~kd_black
    tr = zi + mats.RECIPE_DISTS[mats.M_GLASS][T_TS_R]
    put(0, g_spec, T_FRESNEL_SPEC, c0=ks, c1=ks, p0=one, p1=eta)
    put(0, g_diff & ~g_spec, T_TS_R, c0=kd, p0=alpha, p1=one, p2=eta,
        dist=tr)
    put(1, g_diff & g_spec, T_TS_R, c0=kd, p0=alpha, p1=one, p2=eta,
        dist=tr)
    put(1, g_diff & ~g_spec, T_TS_T, c0=kd, p0=alpha, p1=one, p2=eta,
        dist=tr)
    put(2, g_diff & g_spec, T_TS_T, c0=kd, p0=alpha, p1=one, p2=eta,
        dist=tr)

    transl = mtype == mats.M_TRANSLUCENT
    t_as = transl & (dissolve != 0.0)
    t_lt = transl & ~kd_black
    put(0, t_as, T_ASHIKHMIN,
        c0=clip3(vscale(kd, dissolve)), c1=clip3(vscale(ks, dissolve)),
        p0=alpha,
        dist=zi + mats.RECIPE_DISTS[mats.M_TRANSLUCENT][T_ASHIKHMIN])
    put(0, t_lt & ~t_as, T_LAMBERT_T, c0=vscale(kd, 1.0 - dissolve))
    put(1, t_lt & t_as, T_LAMBERT_T, c0=vscale(kd, 1.0 - dissolve))

    kinds = []
    for k in range(K):
        kind = torch.zeros_like(ktype[k])
        for t in range(1, len(KIND_OF_TYPE)):
            if KIND_OF_TYPE[t]:
                kind = W(ktype[k] == t, KIND_OF_TYPE[t], kind)
        kinds.append(kind)

    ts, bs = cm.make_bsdf_frame(ns, ng, dpdu)
    bsdf_eta = W(glass, eta, 1.0)
    return cm.CSlots(ns=ns, ts=ts, bs=bs, ng=ng, eta=bsdf_eta,
                     type=ktype, kind=kinds, c0=kc0, c1=kc1,
                     p0=kp0, p1=kp1, p2=kp2, dist=kdist,
                     present=presence, dists=dist_sets)


# ---------------------------------------------------------------------------
# the bounce body
# ---------------------------------------------------------------------------

def _hit_info(col, stab, with_uv: bool = False):
    """Hit shading-info construction (the first half of the bounce):
    (pos, pos_err, ng, ns, dpdu, dpdv, uv, mat_id, light_id, hitmask).
    dpdv and uv, which only the textured split reads, are None unless
    with_uv, so the untextured body runs no op for them."""
    o_ray = (col(0), col(1), col(2))
    d = (col(3), col(4), col(5))
    hitmask = col(C_HIT) > 0.5
    is_sph = col(C_IS_SPH) > 0.5
    s_idx = col(C_S_IDX).to(torch.int32)
    p_local = (col(10), col(11), col(12))
    tcol = lambda j: col(C_TROW + j)

    srow = CRow(stab, s_idx)
    b0, b1 = bary_from_vertices(o_ray, d, (tcol(0), tcol(1), tcol(2)),
                                (tcol(3), tcol(4), tcol(5)),
                                (tcol(6), tcol(7), tcol(8)))
    pos_t, perr_t, dpdu_t, dpdv_t, ns_raw = tri_shading_from_row(
        tcol, b0, b1)
    ng_t = vnormalize(vcross(dpdu_t, dpdv_t))
    flip = vdot(ns_raw, ng_t) < 0.0
    ns_t = vwhere(flip, vneg(ns_raw), ns_raw)
    pos_s, ng_s, dpdu_s, dpdv_s, perr_s = sphere_shading_from_row(
        srow, p_local)
    pos = vwhere(is_sph, pos_s, pos_t)
    pos_err = vwhere(is_sph, perr_s, perr_t)
    ng = vwhere(is_sph, ng_s, ng_t)
    ns = vwhere(is_sph, ng_s, ns_t)
    dpdu = vwhere(is_sph, dpdu_s, dpdu_t)
    dpdv = uv = None
    if with_uv:
        dpdv = vwhere(is_sph, dpdv_s, dpdv_t)
        # triangle: barycentric interpolation; sphere: (phi, theta) chart
        b2 = 1.0 - b0 - b1
        uv_t = (b0 * tcol(18) + b1 * tcol(20) + b2 * tcol(22),
                b0 * tcol(19) + b1 * tcol(21) + b2 * tcol(23))
        uv_s = _sphere_uv(srow, p_local)
        uv = (W(is_sph, uv_s[0], uv_t[0]), W(is_sph, uv_s[1], uv_t[1]))
    mat_id = W(is_sph, srow.col_abs(20), tcol(24)).to(torch.int32)
    light_id = W(is_sph, srow.col_abs(21), tcol(25)).to(torch.int32)
    light_id = W(hitmask, light_id, -1)
    return (pos, pos_err, ng, ns, dpdu, dpdv, uv, mat_id, light_id,
            hitmask)


def _sphere_uv(srow: CRow, p):
    """uv at a local sphere point (twin: cbounce._sphere_uv, on the
    polynomial atan2 / acos the kernels share)."""
    radius = srow.col_abs(16)
    thetamin = srow.col_abs(17)
    thetamax = srow.col_abs(18)
    phimax = srow.col_abs(19)
    phi = cm.atan2_poly(p[1], p[0])
    phi = W(phi < 0.0, phi + 2.0 * PI, phi)
    u = phi / cm._max(phimax, 1e-8)
    theta = cm.acos_poly(torch.clamp(p[2] / cm._max(radius, 1e-20),
                                     -1.0 + 1e-7, 1.0 - 1e-7))
    v = (theta - thetamin) / W(torch.abs(thetamax - thetamin) < 1e-8, 1.0,
                               thetamax - thetamin)
    return u, v


def _shade_core(d, pos, pos_err, ng, ns, dpdu, mtype, kd, ks, sigma,
                rough, eta, dissolve, light_id, hitmask, beta, L,
                specular, sel_prev, wb_prev, nee_prev, alive, lidx,
                selpdf, u_light, u_bsdf, u_rr, bounce, ltab, *,
                presence, dist_sets, lcidx, lpresent, emi_cols,
                min_depth, rr_threshold, full_phi):
    """The bounce shade proper over resolved hit info + material
    parameters.  Returns the OUT_COLS output columns."""
    cidx = dict(lcidx)
    lane_active = alive & hitmask

    # (2) emitted radiance
    lerow = CRow(ltab, cm._max(light_id, 0), cidx)
    le = (lerow.col_abs(emi_cols[0]), lerow.col_abs(emi_cols[0] + 1),
          lerow.col_abs(emi_cols[0] + 2))
    emit_gate = lane_active & (light_id >= 0)
    w_emit = W((bounce == 0.0) | specular, 1.0, 0.0) \
        + W(nee_prev & (light_id == sel_prev), wb_prev, 0.0)
    zero3 = vzero_like(w_emit)
    L = vadd(L, vwhere(emit_gate, vscale(cm.vmul(beta, le), w_emit),
                       zero3))

    # (3) scattering + NEE
    wo = vneg(d)
    bsdf = build_slots(mtype, kd, ks, sigma, rough, eta, dissolve,
                       ns, ng, dpdu, presence=presence,
                       dist_sets=dist_sets)
    do_nee = lane_active & (cm.match_count(bsdf, ALL_NON_SPECULAR) > 0)
    lrow = CRow(ltab, cm._max(lidx, 0), cidx)
    ls = light_sample_rows(lrow, lpresent, pos, u_light)
    f_raw, spdf = cm.bsdf_eval_pdf(bsdf, wo, ls["wi"], ALL)
    contrib, need_shadow = direct_light_contrib(ls, f_raw, spdf, bsdf.ns)
    inv_sel = 1.0 / cm._max(selpdf, 1e-20)
    contrib_out = vwhere(do_nee, vscale(cm.vmul(beta, contrib), inv_sel),
                         zero3)
    need_sh_out = need_shadow & do_nee
    d_sh = vsub(ls["pfrom"], pos)
    o_sh = offset_ray_origin(pos, pos_err, ng, d_sh)
    seg = vsub(ls["pfrom"], o_sh)
    dist_sh = torch.sqrt(cm._max(vlength2(seg), 1e-20))
    dirn = vscale(seg, 1.0 / dist_sh)
    sh_t = dist_sh * (1.0 - 1e-3)

    # (4) bsdf sample for path continuation
    f, wi, pdf, kind = cm.bsdf_sample(bsdf, wo, u_bsdf, ALL)
    cont = lane_active & ~cm.is_black(f) & (pdf > 0.0)
    spec_new = (kind & SPECULAR) != 0
    specular = (lane_active & spec_new) | (~lane_active & specular)
    wb = path_mis_weight_rows(lrow, lpresent, selpdf, pos, wi, pdf,
                              kind, f, full_phi_spheres=full_phi)
    sel_prev = W(lane_active, lidx, sel_prev)
    wb_prev = W(lane_active, wb, wb_prev)
    nee_prev = do_nee
    ratio = torch.abs(vdot(wi, bsdf.ns)) / cm._max(pdf, 1e-20)
    overflow = ratio > 1e12
    cont = cont & ~overflow
    ratio = W(cont, cm._min(ratio, 1e12), 0.0)
    new_beta = vscale(cm.vmul(beta, f), ratio)
    beta_ok = cm.valid(new_beta)
    beta = vwhere(cont & beta_ok, new_beta, beta)
    alive = lane_active & cont & beta_ok

    o = offset_ray_origin(pos, pos_err, ng, wi)
    degenerate = vlength2(wi) < 1e-12
    zero = torch.zeros_like(wi[0])
    fallback = (zero, zero, torch.ones_like(zero))
    d_out = vwhere(degenerate, fallback, wi)
    alive = alive & ~degenerate

    # (5) russian roulette
    lum = cm.luminance(beta)
    q = max(rr_threshold, 0.05)
    rr_active = (bounce + 1.0) >= float(min_depth)
    roulette = rr_active & (lum < rr_threshold)
    killed = roulette & (u_rr < q)
    beta = vwhere(roulette & ~killed, vscale(beta, 1.0 / (1.0 - q)), beta)
    alive = alive & ~killed

    b1_ = lambda m: m.to(torch.float32)
    out = [
        o[0], o[1], o[2], d_out[0], d_out[1], d_out[2],
        L[0], L[1], L[2], beta[0], beta[1], beta[2],
        b1_(alive), b1_(specular), sel_prev.to(torch.float32),
        wb_prev, b1_(nee_prev),
        o_sh[0], o_sh[1], o_sh[2], dirn[0], dirn[1], dirn[2],
        sh_t, b1_(need_sh_out),
        contrib_out[0], contrib_out[1], contrib_out[2],
    ]
    out += [zero] * (OUT_COLS - len(out))
    return out


def cbody(col, ltab, mtab, stab, *, presence, dist_sets, lcidx,
          lpresent, emi_cols, min_depth, rr_threshold, full_phi):
    """Component-form bounce shade (untextured path).  col(i) is the
    i-th input column [N]; returns the OUT_COLS output columns."""
    d = (col(3), col(4), col(5))
    (pos, pos_err, ng, ns, dpdu, _, _, mat_id, light_id,
     hitmask) = _hit_info(col, stab)

    mrow = CRow(mtab, cm._max(mat_id, 0))
    mtype = mrow.col_abs(0).to(torch.int32)
    kd = (mrow.col_abs(1), mrow.col_abs(2), mrow.col_abs(3))
    ks = (mrow.col_abs(4), mrow.col_abs(5), mrow.col_abs(6))
    sigma = mrow.col_abs(7)
    rough = mrow.col_abs(8)
    eta = mrow.col_abs(9)
    dissolve = mrow.col_abs(10)

    return _shade_core(
        d, pos, pos_err, ng, ns, dpdu, mtype, kd, ks, sigma, rough,
        eta, dissolve, light_id, hitmask,
        (col(39), col(40), col(41)), (col(42), col(43), col(44)),
        col(C_SPECULAR) > 0.5, col(C_SEL_PREV).to(torch.int32),
        col(C_WB_PREV), col(C_NEE_PREV) > 0.5,
        col(C_ALIVE) > 0.5, col(C_LIDX).to(torch.int32),
        col(C_SELPDF), (col(52), col(53)), (col(54), col(55)),
        col(C_U_RR), col(C_BOUNCE), ltab,
        presence=presence, dist_sets=dist_sets, lcidx=lcidx,
        lpresent=lpresent, emi_cols=emi_cols, min_depth=min_depth,
        rr_threshold=rr_threshold, full_phi=full_phi)


# ---------------------------------------------------------------------------
# the textured split: the hit body (kernel K5) resolves hit info, uv and
# the ray-cone uv footprint; the texel lookups run outside the kernels
# (materials.resolve_params); the shade body (kernel K6) runs the shade
# proper on the resolved material columns
# ---------------------------------------------------------------------------

# hit input: columns 0:39 of the fused layout + cone width and spread
H_CONE_W = 39
H_SPREAD = 40
HIT_IN_COLS = 41
# hit output: pos 0:3 perr 3:6 ng 6:9 ns 9:12 dpdu 12:15 dpdv 15:18
# uv 18:20 duvdx 20:22 duvdy 22:24 mat_id 24 light_id 25 cone_w 26 (pad 27)
HIT_OUT_COLS = 28


def _solve_duv_c(nrm, dpdu, dpdv, dp):
    """Component twin of geometry/dxy._solve_duv: the axis where |n| is
    largest is dropped by comparison masks."""
    anx, any_, anz = torch.abs(nrm[0]), torch.abs(nrm[1]), torch.abs(nrm[2])
    amax0 = (anx >= any_) & (anx >= anz)
    amax2 = ~amax0 & (anz > any_)
    pick_a0 = lambda v: W(amax0, v[1], v[0])
    pick_a1 = lambda v: W(amax2, v[1], v[2])
    A00 = pick_a0(dpdu)
    A01 = pick_a0(dpdv)
    A10 = pick_a1(dpdu)
    A11 = pick_a1(dpdv)
    b0 = pick_a0(dp)
    b1 = pick_a1(dp)
    det = A00 * A11 - A01 * A10
    ok = torch.abs(det) > 1e-20
    inv = W(ok, 1.0 / W(ok, det, 1.0), 0.0)
    du = (A11 * b0 - A01 * b1) * inv
    dv = (A00 * b1 - A10 * b0) * inv
    return du, dv


def _cone_duv_c(r, d, ng, dpdu, dpdv):
    """Component twin of geometry/dxy.cone_duv.  The inverse length is
    1 / sqrt (correctly rounded here and in the kernel), not rsqrt."""
    cos_i = vdot(d, ng)
    proj = vsub(d, vscale(ng, cos_i))
    p2 = vlength2(proj)
    rs = 1.0 / torch.sqrt(cm._max(p2, 1e-30))
    nd = vnormalize(dpdu)
    e1 = vwhere(p2 > 1e-12, vscale(proj, rs), nd)
    e2 = vcross(ng, e1)
    a1 = vscale(e1, r / cm._max(torch.abs(cos_i), 0.1))
    a2 = vscale(e2, r)
    dudx, dvdx = _solve_duv_c(ng, dpdu, dpdv, a1)
    dudy, dvdy = _solve_duv_c(ng, dpdu, dpdv, a2)
    return (dudx, dvdx), (dudy, dvdy)


def cbody_hit(col, stab):
    """The hit body: hit info, uv and the ray-cone footprint at the hit.
    Returns the HIT_OUT_COLS output columns."""
    d = (col(3), col(4), col(5))
    t = col(C_T)
    (pos, pos_err, ng, ns, dpdu, dpdv, uv, mat_id, light_id,
     hitmask) = _hit_info(col, stab, with_uv=True)
    cone_w = col(H_CONE_W)
    spread = col(H_SPREAD)
    ft = W(hitmask, t, 0.0)
    r_cone = cone_w + spread * ft
    (dudx, dvdx), (dudy, dvdy) = _cone_duv_c(r_cone, d, ng, dpdu, dpdv)
    cone_out = W(hitmask, r_cone, cone_w)
    zero = torch.zeros_like(t)
    return [
        pos[0], pos[1], pos[2], pos_err[0], pos_err[1], pos_err[2],
        ng[0], ng[1], ng[2], ns[0], ns[1], ns[2],
        dpdu[0], dpdu[1], dpdu[2], dpdv[0], dpdv[1], dpdv[2],
        uv[0], uv[1], dudx, dvdx, dudy, dvdy,
        mat_id.to(torch.float32), light_id.to(torch.float32),
        cone_out, zero,
    ]


# shade input layout
S_D = 0          # 0:3
S_POS = 3        # 3:6
S_PERR = 6       # 6:9
S_NG = 9         # 9:12
S_NS = 12        # 12:15
S_DPDU = 15      # 15:18
S_MTYPE = 18
S_KD = 19        # 19:22
S_KS = 22        # 22:25
S_SIGMA = 25
S_ROUGH = 26
S_ETA = 27
S_DISSOLVE = 28
S_LIGHT_ID = 29
S_HIT = 30
S_BETA = 31      # 31:34
S_L = 34         # 34:37
S_SPECULAR = 37
S_SEL_PREV = 38
S_WB_PREV = 39
S_NEE_PREV = 40
S_ALIVE = 41
S_LIDX = 42
S_SELPDF = 43
S_U_LIGHT = 44   # 44:46
S_U_BSDF = 46    # 46:48
S_U_RR = 48
S_BOUNCE = 49
SHADE_IN_COLS = 50

# the input columns a lane past n_alive carries through (beta, L,
# specular, sel_prev, wb_prev), in the fused and the split shade layout
CARRIED = (C_BETA, C_L, C_SPECULAR, C_SEL_PREV, C_WB_PREV)
S_CARRIED = (S_BETA, S_L, S_SPECULAR, S_SEL_PREV, S_WB_PREV)


def dead_lanes(n_alive, n: int, device):
    """[N] bool: the lanes at or past the live count n_alive (a device
    scalar), or None where n_alive is None (every lane is live)."""
    if n_alive is None:
        return None
    return torch.arange(n, device=device) >= n_alive


def dead_lane_out(xt, carried=CARRIED) -> torch.Tensor:
    """[OUT_COLS, N]: the output of lanes past the live count (kernel
    twin: kernels/cbounce.cuh dead_lane), for inputs xt whose carried
    columns are `carried` (CARRIED or S_CARRIED): L, beta and wb_prev
    pass through, specular and sel_prev as the body converts them;
    o = sh_o = 0, d = sh_d = (0, 0, 1), sh_t = 0, and alive, nee_prev,
    need_shadow and contrib 0."""
    c_beta, c_l, c_spec, c_sel, c_wb = carried
    zero = torch.zeros_like(xt[0])
    one = torch.ones_like(zero)
    rows = [zero, zero, zero, zero, zero, one,
            xt[c_l], xt[c_l + 1], xt[c_l + 2],
            xt[c_beta], xt[c_beta + 1], xt[c_beta + 2],
            zero, (xt[c_spec] > 0.5).to(torch.float32),
            xt[c_sel].to(torch.int32).to(torch.float32), xt[c_wb], zero,
            zero, zero, zero, zero, zero, one, zero, zero,
            zero, zero, zero]
    return torch.stack(rows + [zero] * (OUT_COLS - len(rows)), dim=0)


def _live_lanes_only(body, xt, n_alive, carried):
    """body(xt) [OUT_COLS, N] on the lanes below n_alive and
    dead_lane_out on the others.  The dead lanes enter the body
    detached, so no gradient reaches their inputs through it."""
    dead = dead_lanes(n_alive, xt.shape[1], xt.device)
    if dead is None:
        return body(xt)
    return torch.where(dead, dead_lane_out(xt, carried),
                       body(torch.where(dead, xt.detach(), xt)))


def cbody_shade(col, ltab, *, presence, dist_sets, lcidx, lpresent,
                emi_cols, min_depth, rr_threshold, full_phi):
    """The shade body: the bounce shade proper over texture-resolved
    material columns.  Returns the OUT_COLS output columns."""
    c3 = lambda j: (col(j), col(j + 1), col(j + 2))
    return _shade_core(
        c3(S_D), c3(S_POS), c3(S_PERR), c3(S_NG), c3(S_NS), c3(S_DPDU),
        col(S_MTYPE).to(torch.int32), c3(S_KD), c3(S_KS), col(S_SIGMA),
        col(S_ROUGH), col(S_ETA), col(S_DISSOLVE),
        col(S_LIGHT_ID).to(torch.int32), col(S_HIT) > 0.5, c3(S_BETA),
        c3(S_L), col(S_SPECULAR) > 0.5, col(S_SEL_PREV).to(torch.int32),
        col(S_WB_PREV), col(S_NEE_PREV) > 0.5, col(S_ALIVE) > 0.5,
        col(S_LIDX).to(torch.int32), col(S_SELPDF),
        (col(S_U_LIGHT), col(S_U_LIGHT + 1)),
        (col(S_U_BSDF), col(S_U_BSDF + 1)), col(S_U_RR), col(S_BOUNCE),
        ltab, presence=presence, dist_sets=dist_sets, lcidx=lcidx,
        lpresent=lpresent, emi_cols=emi_cols, min_depth=min_depth,
        rr_threshold=rr_threshold, full_phi=full_phi)


def _static_kwargs(static: sc.ShadeStatic, min_depth, rr_threshold):
    return dict(presence=static.presence, dist_sets=static.dist_sets,
                lcidx=static.lcidx, lpresent=static.lpresent,
                emi_cols=static.emi_cols, min_depth=int(min_depth),
                rr_threshold=float(rr_threshold),
                full_phi=static.full_phi)


def cbody_reference(xt, ltab, mtab, stab, static: sc.ShadeStatic,
                    min_depth: int, rr_threshold: float,
                    n_alive=None) -> torch.Tensor:
    """Plain PyTorch version of the bounce-shade kernel: the body over
    the transposed wave xt [IN_COLS, N] -> [OUT_COLS, N], under the
    dead-lane contract for n_alive."""
    kw = _static_kwargs(static, min_depth, rr_threshold)
    return _live_lanes_only(
        lambda x: torch.stack(cbody(lambda i: x[i], ltab, mtab, stab, **kw),
                              dim=0), xt, n_alive, CARRIED)


def cbody_vjp_reference(xt, ltab, mtab, stab, ct, static: sc.ShadeStatic,
                        min_depth: int, rr_threshold: float, n_alive=None):
    """Plain PyTorch version of the bounce-shade backward kernel:
    autograd over the body (under the dead-lane contract for n_alive)
    for the output cotangent ct [OUT_COLS, N].  Returns (dx [IN_COLS,
    N], dltab, dmtab, dstab); inputs the body does not differentiate get
    zeros, as jax.vjp gives them."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True)
               for t in (xt, ltab, mtab, stab)]
        out = cbody_reference(*ins, static, min_depth, rr_threshold,
                              n_alive)
        grads = torch.autograd.grad(out, ins, ct, allow_unused=True)
    return tuple(torch.zeros_like(t) if g is None else g
                 for g, t in zip(grads, ins))


def bwd_needs_body(xt, ct, stab, n_alive=None) -> torch.Tensor:
    """Plain twin of K4's classifier (kernels/cbounce_ad.cuh needs_body):
    [N] bool, True where a lane's VJP needs the body.  A lane past
    n_alive never does: its forward passes L, beta and wb_prev through.
    Nor does a lane that adds no emission (its emission gate: alive,
    hit, and a light id >= 0, as _hit_info / _shade_core read it) and
    whose output cotangent ct [OUT_COLS, N] is zero in columns 0..27
    outside L and finite on L: there L_out = L_in + 0 and no other
    output has a cotangent.  Either way the VJP is the pass-through
    (bwd_pass_through) and no table cotangent."""
    hitmask = xt[C_HIT] > 0.5
    srow = CRow(stab, xt[C_S_IDX].to(torch.int32))
    light_id = W(xt[C_IS_SPH] > 0.5, srow.col_abs(21),
                 xt[C_TROW + 25]).to(torch.int32)
    emit = (xt[C_ALIVE] > 0.5) & hitmask & (light_id >= 0)
    other = torch.cat([ct[:OUT_L], ct[OUT_L + 3:28]])
    need = emit | (other != 0).any(0) \
        | ~torch.isfinite(ct[OUT_L:OUT_L + 3]).all(0)
    dead = dead_lanes(n_alive, xt.shape[1], xt.device)
    return need if dead is None else need & ~dead


def bwd_pass_through(ct) -> torch.Tensor:
    """dx [IN_COLS, N] of a lane whose VJP needs no body: the cotangents
    of L, beta and wb_prev on their input columns (beta's and wb_prev's
    are zero on a live lane that needs no body), zero elsewhere."""
    dx = ct.new_zeros(IN_COLS, ct.shape[1])
    dx[C_L:C_L + 3] = ct[OUT_L:OUT_L + 3]
    dx[C_BETA:C_BETA + 3] = ct[OUT_BETA:OUT_BETA + 3]
    dx[C_WB_PREV] = ct[OUT_WB_PREV]
    return dx


class _BounceShadeKernel(torch.autograd.Function):
    """Forward: the bounce-shade kernel (K3).  Backward: the hand-written
    backward kernel (K4), which replaces the Pallas kernel
    cbounce._bwd_kernel."""

    @staticmethod
    def forward(ctx, xt, ltab, mtab, stab, static, min_depth,
                rr_threshold, n_alive):
        from arendur_tpu_torch.kernels import ops
        ctx.save_for_backward(xt, ltab, mtab, stab)
        ctx.cfg = (static, min_depth, rr_threshold, n_alive)
        return ops.bounce_shade(xt, ltab, mtab, stab, static, min_depth,
                                rr_threshold, n_alive)

    @staticmethod
    def backward(ctx, g):
        from arendur_tpu_torch.kernels import ops
        xt, ltab, mtab, stab = ctx.saved_tensors
        grads = ops.bounce_shade_bwd(xt, ltab, mtab, stab, g, *ctx.cfg)
        return tuple(grads) + (None,) * 4


def bounce_shade_t(xt, ltab, mtab, stab, static: sc.ShadeStatic,
                   min_depth: int, rr_threshold: float,
                   n_alive=None) -> torch.Tensor:
    """The bounce shade over xt [IN_COLS, N] -> [OUT_COLS, N] under the
    dead-lane contract for n_alive: the hand-written kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if xt.is_cuda:
        return _BounceShadeKernel.apply(xt, ltab, mtab, stab, static,
                                        min_depth, rr_threshold, n_alive)
    return cbody_reference(xt, ltab, mtab, stab, static, min_depth,
                           rr_threshold, n_alive)


def unpack_out_t(out: torch.Tensor) -> dict:
    """[OUT_COLS, N] output -> dict of row-form tensors."""
    v3 = lambda j: out[j:j + 3].T
    return dict(
        o=v3(0), d=v3(3), L=v3(6), beta=v3(9),
        alive=out[12] > 0.5, specular=out[13] > 0.5,
        sel_prev=out[14].to(torch.int64), wb_prev=out[15],
        nee_prev=out[16] > 0.5,
        sh_o=v3(17), sh_d=v3(20), sh_t=out[23],
        need_shadow=out[24] > 0.5, contrib=v3(25))


def cbody_hit_reference(xt: torch.Tensor, stab: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the hit kernel: [HIT_IN_COLS, N] ->
    [HIT_OUT_COLS, N]."""
    return torch.stack(cbody_hit(lambda i: xt[i], stab), dim=0)


def cbody_shade_reference(xt, ltab, static: sc.ShadeStatic, min_depth: int,
                          rr_threshold: float, n_alive=None) -> torch.Tensor:
    """Plain PyTorch version of the split shade kernel:
    [SHADE_IN_COLS, N] -> [OUT_COLS, N], under the dead-lane contract
    for n_alive."""
    kw = _static_kwargs(static, min_depth, rr_threshold)
    return _live_lanes_only(
        lambda x: torch.stack(cbody_shade(lambda i: x[i], ltab, **kw), dim=0),
        xt, n_alive, S_CARRIED)


def cbody_shade_vjp_reference(xt, ltab, ct, static: sc.ShadeStatic,
                              min_depth: int, rr_threshold: float,
                              n_alive=None):
    """The split shade's backward: autograd over the plain shade body
    (under the dead-lane contract for n_alive) for the output cotangent
    ct [OUT_COLS, N] -> (dx, dltab), as the JAX package's _bwd_shade
    takes jax.vjp of its plain body."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (xt, ltab)]
        out = cbody_shade_reference(*ins, static, min_depth, rr_threshold,
                                    n_alive)
        grads = torch.autograd.grad(out, ins, ct, allow_unused=True)
    return tuple(torch.zeros_like(t) if g is None else g
                 for g, t in zip(grads, ins))


def hit_shade_t(xt: torch.Tensor, stab: torch.Tensor) -> torch.Tensor:
    """The hit body over xt [HIT_IN_COLS, N] -> [HIT_OUT_COLS, N]: the
    hand-written kernel for CUDA tensors, the plain version for CPU
    tensors.  Geometry only: the result is detached (no gradient flows
    through hit geometry, as in the JAX package)."""
    xt, stab = xt.detach(), stab.detach()
    if xt.is_cuda:
        from arendur_tpu_torch.kernels import ops
        return ops.hit_shade(xt, stab)
    return cbody_hit_reference(xt, stab)


class _ShadeSplitKernel(torch.autograd.Function):
    """Forward: the split shade kernel (K6).  Backward: autograd over the
    plain shade body, as the JAX package's custom_vjp does (it has no
    backward kernel for this shade either)."""

    @staticmethod
    def forward(ctx, xt, ltab, static, min_depth, rr_threshold, n_alive):
        from arendur_tpu_torch.kernels import ops
        ctx.save_for_backward(xt, ltab)
        ctx.cfg = (static, min_depth, rr_threshold, n_alive)
        return ops.shade_split(xt, ltab, static, min_depth, rr_threshold,
                               n_alive)

    @staticmethod
    def backward(ctx, g):
        grads = cbody_shade_vjp_reference(*ctx.saved_tensors, g, *ctx.cfg)
        return tuple(grads) + (None,) * 4


def shade_split_t(xt, ltab, static: sc.ShadeStatic, min_depth: int,
                  rr_threshold: float, n_alive=None) -> torch.Tensor:
    """The split shade over xt [SHADE_IN_COLS, N] -> [OUT_COLS, N] under
    the dead-lane contract for n_alive: the hand-written kernel for CUDA
    tensors, the plain version for CPU tensors; differentiable in xt and
    ltab."""
    if xt.is_cuda:
        return _ShadeSplitKernel.apply(xt, ltab, static, min_depth,
                                       rr_threshold, n_alive)
    return cbody_shade_reference(xt, ltab, static, min_depth, rr_threshold,
                                 n_alive)


def unpack_hit_t(out: torch.Tensor) -> dict:
    """[HIT_OUT_COLS, N] hit output -> dict of row-form tensors."""
    v3 = lambda j: out[j:j + 3].T
    v2 = lambda j: out[j:j + 2].T
    return dict(
        pos=v3(0), pos_err=v3(3), ng=v3(6), ns=v3(9), dpdu=v3(12),
        dpdv=v3(15), uv=v2(18), duvdx=v2(20), duvdy=v2(22),
        mat_id=out[24].to(torch.int64), light_id=out[25].to(torch.int64),
        cone_w=out[26])
