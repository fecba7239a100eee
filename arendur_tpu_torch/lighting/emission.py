"""Light path generation (photon emission) and its densities: the
adjoint side of every light type, which BPT's light subpaths need (port
of arendur_tpu/lighting/emission.py; ref: src/lighting/mod.rs:40-63).

Per light type:

* area sphere / triangle: a uniform-area position, a cosine-weighted
  direction about the surface normal (ref: component/shape.rs:133-145,
  shape/triangle.rs:585-607);
* point: a sphere-uniform direction, pdf_dir = 1/4pi
  (ref: pointlights.rs:63-74);
* spot: a cone-uniform direction about the axis, with the spot's
  falloff on the emitted radiance (ref: pointlights.rs:196-208);
* distant: a position on the disk of the world's bounding sphere,
  pushed back one radius against the direction
  (ref: distantlight.rs:84-99).

pdf_pos is an area density (0 marks a delta position: point, spot),
pdf_dir a solid-angle density (0 marks a delta direction: distant).
Every per-light attribute, the area light's triangle corners and sphere
transform included, comes from the DeviceScene's packed light rows
(``ltab``, scene.light_pack) by one row select per lane; branches of
light types the scene lacks are skipped.
"""

from __future__ import annotations

import math

import torch

from arendur_tpu_torch import scene as sc
from arendur_tpu_torch.render import cmath as cm
from arendur_tpu_torch.render.cmath import (
    W, vadd, vsub, vscale, vdot, vcross, vnormalize, vwhere)
from arendur_tpu_torch.sampling import warps
from arendur_tpu_torch.shapes import sphere as sph

PI = math.pi


def _rows(scene: sc.DeviceScene, lidx):
    from arendur_tpu_torch.render import cbounce as cb
    return cb.CRow(scene.ltab, lidx, dict(scene.static.lcidx))


def _r(v) -> torch.Tensor:
    return torch.stack(v, -1)


def _c(x: torch.Tensor):
    return tuple(x.unbind(-1))


def _cosine_dir_about(n, u):
    """A cosine-weighted world direction about the normal n."""
    t, b = cm.get_basis_from(n)
    return cm.to_world(t, b, n, _c(warps.sample_cosw_hemisphere(u)))


def _sphere_area(lrow):
    return lrow.col1("s_phimax") * lrow.col1("s_radius") \
        * (lrow.col1("s_zmax") - lrow.col1("s_zmin"))


def sample_sphere_local(radius, zmin, zmax, thetamin, thetamax, phimax, u2,
                        theta_uniform=None):
    """A point on each lane's sphere in its local frame for uniforms u2
    (two [N] tensors): (p_local, n_local, pdf_area), pdf = 1/area (twin:
    sphere.sample_sphere_local, the exact arccos; theta_uniform None:
    the module's THETA_UNIFORM_COMPAT)."""
    if theta_uniform is None:
        theta_uniform = sph.THETA_UNIFORM_COMPAT
    phi = u2[0] * phimax
    if theta_uniform:
        theta = u2[1] * (thetamax - thetamin) + thetamin
    else:
        z = zmin / radius + u2[1] * (zmax - zmin) / radius
        theta = torch.acos(torch.clamp(z, -1.0 + 1e-7, 1.0 - 1e-7))
    st = torch.sin(theta)
    n = (st * torch.cos(phi), st * torch.sin(phi), torch.cos(theta))
    return vscale(n, radius), n, 1.0 / (phimax * radius * (zmax - zmin))


def _tri_area(lrow):
    e = vcross(vsub(lrow.col3("tri_v1"), lrow.col3("tri_v0")),
               vsub(lrow.col3("tri_v2"), lrow.col3("tri_v0")))
    return 0.5 * torch.sqrt(cm.vlength2(e))


def _has_tris(lrow, present):
    return sc.L_AREA_TRI in present and "tri_v0" in lrow._cidx


def generate_path(scene: sc.DeviceScene, lidx, u_pos, u_dir,
                  textures=None) -> dict:
    """An emitted ray from light lidx [N] for uniforms u_pos, u_dir
    [N,2]: dict(pos [N,3], dir [N,3], n [N,3] the light normal (the
    direction for point, spot and distant lights), le [N,3], pdf_pos
    [N], pdf_dir [N]).  textures: the atlas of area lights' emission
    profiles, evaluated at the sampled point."""
    present = scene.static.lpresent
    lrow = _rows(scene, lidx)
    lt = lrow.col1("ltype").to(torch.int32)
    up = (u_pos[:, 0], u_pos[:, 1])
    zero1 = torch.zeros_like(up[0])
    zero3 = (zero1, zero1, zero1)
    emission = lrow.col3("emission")

    # ---- area sphere (sampled in its local frame) ----------------------
    if sc.L_AREA_SPHERE in present:
        radius = lrow.col1("s_radius")
        thetamin, thetamax = lrow.col1("s_thetamin"), lrow.col1("s_thetamax")
        phimax = lrow.col1("s_phimax")
        lp_l, ln_l, pdf_a_s = sample_sphere_local(
            radius, lrow.col1("s_zmin"), lrow.col1("s_zmax"), thetamin,
            thetamax, phimax, up)
        o2w = lrow.col16("s_o2w")
        pos_s = cm.tp16(o2w, lp_l)
        n_s = vnormalize(cm.tv16(o2w, ln_l))
        dir_s = _cosine_dir_about(n_s, u_dir)
        pdf_dir_s = warps.pdf_cosw_hemisphere(
            torch.clamp(vdot(dir_s, n_s), min=0.0))
    else:
        pos_s = n_s = dir_s = zero3
        pdf_a_s = pdf_dir_s = zero1

    # ---- area triangle ---------------------------------------------------
    if _has_tris(lrow, present):
        bary = cm.sample_uniform_triangle(up)
        corner = lambda name: vadd(vadd(  # noqa: E731
            vscale(lrow.col3(name + "0"), bary[0]),
            vscale(lrow.col3(name + "1"), bary[1])),
            vscale(lrow.col3(name + "2"), bary[2]))
        pos_t = corner("tri_v")
        n_t = vnormalize(corner("tri_n"))
        pdf_a_t = 1.0 / _tri_area(lrow)
        dir_t = _cosine_dir_about(n_t, u_dir)
        pdf_dir_t = warps.pdf_cosw_hemisphere(
            torch.clamp(vdot(dir_t, n_t), min=0.0))
        uv_t = tuple(bary[0] * lrow.col1("tri_uv0", j)
                     + bary[1] * lrow.col1("tri_uv1", j)
                     + bary[2] * lrow.col1("tri_uv2", j) for j in range(2))
    else:
        pos_t = n_t = dir_t = zero3
        pdf_a_t = pdf_dir_t = zero1
        uv_t = (zero1, zero1)

    # ---- point / spot ------------------------------------------------------
    lpos = lrow.col3("pos")
    dir_p = _c(warps.sample_uniform_sphere(u_dir))
    falloff = zero1
    dir_sp = zero3
    pdf_dir_sp = zero1
    if sc.L_SPOT in present:
        axis = vnormalize(lrow.col3("aux"))
        cos_total = lrow.col1("params")
        w_cone = _c(warps.sample_uniform_cone(u_dir, cos_total))
        t_ax, b_ax = cm.get_basis_from(axis)
        dir_sp = cm.to_world(t_ax, b_ax, axis, w_cone)
        pdf_dir_sp = warps.pdf_uniform_cone(cos_total)
        # the spot's falloff on the emitted direction (pointlights.rs:
        # 146-159)
        cos_falloff = lrow.col1("params", 1)
        cos_to = vdot(dir_sp, axis)
        tt = torch.clamp((cos_to - cos_total)
                         / torch.clamp(cos_falloff - cos_total, min=1e-8),
                         0.0, 1.0)
        falloff = W(cos_to < cos_total, 0.0,
                    W(cos_to > cos_falloff, 1.0, (tt * tt) * (tt * tt)))

    # ---- distant -----------------------------------------------------------
    ldir = vnormalize(lpos)
    pos_d = zero3
    pdf_pos_d = zero1
    if sc.L_DISTANT in present:
        wr = torch.clamp(lrow.col1("params"), min=1e-6)
        t_d, b_d = cm.get_basis_from(ldir)
        disk = _c(warps.sample_concentric_disk(u_pos))
        # the disk of the world's bounding sphere, pushed back one radius
        # against the travel direction (distantlight.rs:84-91)
        pos_d = vsub(vadd(lrow.col3("aux"), vscale(
            vadd(vscale(t_d, disk[0]), vscale(b_d, disk[1])), wr)),
            vscale(ldir, wr))
        pdf_pos_d = 1.0 / (PI * wr * wr)

    # ---- combine by type ----------------------------------------------
    def pick(sv, tv, pv, spv, dv, vec=True):
        sel = vwhere if vec else W
        out = sel(lt == sc.L_AREA_SPHERE, sv, tv)
        out = sel(lt == sc.L_POINT, pv, out)
        out = sel(lt == sc.L_SPOT, spv, out)
        return sel(lt == sc.L_DISTANT, dv, out)

    pos = pick(pos_s, pos_t, lpos, lpos, pos_d)
    dirn = pick(dir_s, dir_t, dir_p, dir_sp, ldir)
    nrm = pick(n_s, n_t, dir_p, dir_sp, ldir)
    le = pick(emission, emission, emission, vscale(emission, falloff),
              emission)
    le = _r(le)
    if textures is not None:
        if sc.L_AREA_SPHERE in present:
            uv_s = sc.sphere_uv(_r(lp_l), radius, thetamin, thetamax,
                                phimax)[:2]
        else:
            uv_s = (zero1, zero1)
        uv_area = _r(tuple(W(lt == sc.L_AREA_SPHERE, a, b)
                           for a, b in zip(uv_s, uv_t)))
        le = le * sc.emission_tex_factor(scene, lidx, uv_area, textures)
    pdf_pos = pick(pdf_a_s, pdf_a_t, zero1, zero1, pdf_pos_d, vec=False)
    pdf_dir = pick(pdf_dir_s, pdf_dir_t,
                   torch.full_like(zero1, warps.pdf_uniform_sphere()),
                   pdf_dir_sp, zero1, vec=False)
    return dict(pos=_r(pos), dir=_r(dirn), n=_r(nrm), le=le,
                pdf_pos=pdf_pos, pdf_dir=pdf_dir)


def pdf_dir_at(scene: sc.DeviceScene, lidx, n_light, w) -> torch.Tensor:
    """Solid-angle density [N] of generate_path emitting direction w
    [N,3] from light lidx [N] whose surface normal there is n_light
    [N,3] (the direction part of Light::pdf_path)."""
    present = scene.static.lpresent
    lrow = _rows(scene, lidx)
    lt = lrow.col1("ltype").to(torch.int32)
    wc = _c(w)
    pdf_area = warps.pdf_cosw_hemisphere(
        torch.clamp(vdot(wc, _c(n_light)), min=0.0))
    pdf_spot = torch.zeros_like(pdf_area)
    if sc.L_SPOT in present:
        axis = vnormalize(lrow.col3("aux"))
        cos_total = lrow.col1("params")
        pdf_spot = W(vdot(wc, axis) >= cos_total,
                     warps.pdf_uniform_cone(cos_total), 0.0)
    return W((lt == sc.L_AREA_SPHERE) | (lt == sc.L_AREA_TRI), pdf_area,
             W(lt == sc.L_POINT, warps.pdf_uniform_sphere(),
               W(lt == sc.L_SPOT, pdf_spot, 0.0)))


def pdf_origin(scene: sc.DeviceScene, lidx) -> torch.Tensor:
    """Area density [N] of generate_path's position sample for light
    lidx [N] (0 for a delta position)."""
    present = scene.static.lpresent
    lrow = _rows(scene, lidx)
    lt = lrow.col1("ltype").to(torch.int32)
    zero1 = torch.zeros_like(lrow.col1("ltype"))
    inv_a_s = (1.0 / torch.clamp(_sphere_area(lrow), min=1e-20)
               if sc.L_AREA_SPHERE in present else zero1)
    inv_a_t = (1.0 / torch.clamp(_tri_area(lrow), min=1e-20)
               if _has_tris(lrow, present) else zero1)
    wr = torch.clamp(lrow.col1("params"), min=1e-6)
    inv_a_d = 1.0 / (PI * wr * wr)
    return W(lt == sc.L_AREA_SPHERE, inv_a_s,
             W(lt == sc.L_AREA_TRI, inv_a_t,
               W(lt == sc.L_DISTANT, inv_a_d, 0.0)))
