"""Material table (port of arendur_tpu/materials.py; ref:
src/material/).

Materials are rows of a host-side NumPy table; ``param_table`` packs
them into the [M,16] rows the bounce shade reads (``param_table_t``:
the same rows as a tensor whose kd / ks / roughness columns may carry
gradient), and
``slot_presence`` / ``dist_presence`` / ``tex_channel_presence`` derive
the host-static sets of BSDF families, microfacet models and texture
channels the table can produce.  On textured scenes ``resolve_params``
reads each hit's row and replaces its kd / ks / sigma by texture
lookups and its shading frame by the bump-mapped one, before the shade
kernel builds the BSDF.  The per-lane recipe lives with the bounce body
in component form (render/cbounce.py ``build_slots``); ``build_slots``
and ``compute_scattering`` here return it as a row-form
bxdf/slots.BsdfSlots for the composed path.

* Matte       -> LambertianR (sigma==0) or Oren-Nayar   (matte.rs:38-65)
* Plastic     -> AshikhminShirley(Beckmann)             (plastic.rs:39-64)
* Glass       -> FresnelBxdf + TS-R/TS-T (Trowbridge)   (glass.rs:41-81)
* Translucent -> AshikhminShirley(TR)*d + LambertianT*(1-d)
                                                        (translucent.rs:41-75)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from arendur_tpu_torch.bxdf.types import (
    T_LAMBERT_R, T_LAMBERT_T, T_OREN_NAYAR, T_FRESNEL_SPEC,
    T_TS_R, T_TS_T, T_ASHIKHMIN, D_BECKMANN, D_TROWBRIDGE)

M_MATTE = 0
M_PLASTIC = 1
M_GLASS = 2
M_TRANSLUCENT = 3

MAX_SLOTS = 3  # glass uses 3 (fresnel + TS-R + TS-T); others fewer


@dataclasses.dataclass(frozen=True, eq=False)
class MaterialTable:
    """M materials as SoA rows (NumPy).  *_tex hold image-texture ids
    of the scene's atlas (-1 = the constant column is used)."""
    mtype: np.ndarray      # [M] int32
    kd: np.ndarray         # [M,3]
    ks: np.ndarray         # [M,3]
    sigma: np.ndarray      # [M]
    roughness: np.ndarray  # [M]
    eta: np.ndarray        # [M]
    dissolve: np.ndarray   # [M]
    kd_tex: np.ndarray     # [M] int32
    ks_tex: np.ndarray     # [M] int32
    sigma_tex: np.ndarray  # [M] int32
    bump_tex: np.ndarray   # [M] int32


def make_material_table(rows) -> MaterialTable:
    """rows: list of dicts with keys mtype, kd, ks, sigma, roughness,
    eta, dissolve (+ optional *_tex ids)."""
    def col(key, default, dt=np.float32):
        return np.asarray([r.get(key, default) for r in rows], dt)
    return MaterialTable(
        mtype=col("mtype", M_MATTE, np.int32),
        kd=col("kd", (0.0, 0.0, 0.0)),
        ks=col("ks", (0.0, 0.0, 0.0)),
        sigma=col("sigma", 0.0),
        roughness=col("roughness", 0.0),
        eta=col("eta", 1.5),
        dissolve=col("dissolve", 1.0),
        kd_tex=col("kd_tex", -1, np.int32),
        ks_tex=col("ks_tex", -1, np.int32),
        sigma_tex=col("sigma_tex", -1, np.int32),
        bump_tex=col("bump_tex", -1, np.int32),
    )


def slot_presence(table: MaterialTable):
    """Host-static per-slot-column sets of BSDF types any material row
    can place there: a MAX_SLOTS-tuple of sorted type-id tuples."""
    mtype = np.asarray(table.mtype)
    kd = np.asarray(table.kd)
    ks = np.asarray(table.ks)
    sigma = np.asarray(table.sigma)
    dissolve = np.asarray(table.dissolve)
    kd_tex = np.asarray(table.kd_tex)
    ks_tex = np.asarray(table.ks_tex)
    sigma_tex = np.asarray(table.sigma_tex)
    cols = [set() for _ in range(MAX_SLOTS)]
    for i in range(len(mtype)):
        kd_may = (kd[i] != 0).any() or kd_tex[i] >= 0
        ks_may = (ks[i] != 0).any() or ks_tex[i] >= 0
        if mtype[i] == M_MATTE:
            if kd_may:
                if sigma_tex[i] >= 0:
                    cols[0] |= {T_LAMBERT_R, T_OREN_NAYAR}
                elif sigma[i] == 0.0:
                    cols[0].add(T_LAMBERT_R)
                else:
                    cols[0].add(T_OREN_NAYAR)
        elif mtype[i] == M_PLASTIC:
            cols[0].add(T_ASHIKHMIN)
        elif mtype[i] == M_GLASS:
            if ks_may:
                cols[0].add(T_FRESNEL_SPEC)
            if kd_may:
                if ks_may:
                    cols[1].add(T_TS_R)
                    cols[2].add(T_TS_T)
                if not (ks_may and ks_tex[i] < 0 and (ks[i] != 0).any()):
                    # spec may be absent -> TS slots shift down
                    cols[0].add(T_TS_R)
                    cols[1].add(T_TS_T)
        elif mtype[i] == M_TRANSLUCENT:
            t_as = dissolve[i] != 0.0
            if t_as:
                cols[0].add(T_ASHIKHMIN)
            if kd_may:
                cols[1 if t_as else 0].add(T_LAMBERT_T)
    return tuple(tuple(sorted(c)) for c in cols)


def param_table(table: MaterialTable) -> np.ndarray:
    """[M,16] packed material rows (mtype kd ks sigma roughness eta
    dissolve + tex ids + pad), read per lane by the bounce shade."""
    t = table
    pack = np.concatenate([
        np.asarray(t.mtype).astype(np.float32)[:, None],
        np.asarray(t.kd, np.float32), np.asarray(t.ks, np.float32),
        np.asarray(t.sigma, np.float32)[:, None],
        np.asarray(t.roughness, np.float32)[:, None],
        np.asarray(t.eta, np.float32)[:, None],
        np.asarray(t.dissolve, np.float32)[:, None],
        np.asarray(t.kd_tex).astype(np.float32)[:, None],
        np.asarray(t.ks_tex).astype(np.float32)[:, None],
        np.asarray(t.sigma_tex).astype(np.float32)[:, None],
        np.asarray(t.bump_tex).astype(np.float32)[:, None],
    ], axis=1)
    return np.concatenate(
        [pack, np.zeros((pack.shape[0], 1), np.float32)], axis=1)


def param_table_t(table: MaterialTable, device, kd=None, ks=None,
                  roughness=None) -> torch.Tensor:
    """The [M,16] rows of ``param_table`` as a tensor on device, with
    the kd [M,3], ks [M,3] and roughness [M] columns taken from the
    given tensors where they are given (they may require grad; the
    gradient flows into them through the rows)."""
    base = torch.as_tensor(param_table(table), device=device)
    col = lambda t, lo, hi: base[:, lo:hi] if t is None \
        else t.reshape(-1, hi - lo).to(base.dtype)
    return torch.cat([base[:, 0:1], col(kd, 1, 4), col(ks, 4, 7),
                      base[:, 7:8], col(roughness, 8, 9), base[:, 9:]], 1)


# Which microfacet distribution each material recipe assigns to each
# microfacet-bearing slot type: the single source of truth for
# build_slots and dist_presence (plastic AS = Beckmann, plastic.rs;
# glass TS and translucent AS = Trowbridge, glass.rs / translucent.rs).
RECIPE_DISTS = {
    M_PLASTIC: {T_ASHIKHMIN: D_BECKMANN},
    M_GLASS: {T_TS_R: D_TROWBRIDGE, T_TS_T: D_TROWBRIDGE},
    M_TRANSLUCENT: {T_ASHIKHMIN: D_TROWBRIDGE},
}


def dist_presence(table: MaterialTable):
    """Host-static per-family microfacet-distribution sets, derived
    from RECIPE_DISTS restricted to the material types present."""
    mtype = np.asarray(table.mtype)
    out = {}
    for mt, slots in RECIPE_DISTS.items():
        if (mtype == mt).any():
            for stype, dist in slots.items():
                out.setdefault(stype, set()).add(dist)
    return tuple(sorted((k, tuple(sorted(v))) for k, v in out.items()))


def tex_channel_presence(table: MaterialTable):
    """Host-static (kd, ks, sigma, bump) bool 4-tuple: the texture
    channels any material row uses.  resolve_params skips the lookups
    of the others."""
    return tuple(bool((np.asarray(c) >= 0).any()) for c in
                 (table.kd_tex, table.ks_tex, table.sigma_tex,
                  table.bump_tex))


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], -1)


def apply_bump(textures, bump_tex, uv, ns, ng, dpdu, dpdv, duvdx=None,
               duvdy=None):
    """Bump mapping (ref: material/mod.rs:42-86): finite differences of
    the gray bump texture along u and v shift the shading frame.
    Returns (ns', dpdu').  The step is half the uv footprint, or the
    reference's 0.0005 where the lane has none."""
    from arendur_tpu_torch.texturing import texture as tx
    if textures is None:
        return ns, dpdu
    if duvdx is not None:
        du = 0.5 * (torch.abs(duvdx[..., 0]) + torch.abs(duvdy[..., 0]))
        dv = 0.5 * (torch.abs(duvdx[..., 1]) + torch.abs(duvdy[..., 1]))
        du = torch.where(du == 0.0, 5e-4, du)
        dv = torch.where(dv == 0.0, 5e-4, dv)
    else:
        du = torch.full(uv.shape[:-1], 5e-4, dtype=torch.float32,
                        device=uv.device)
        dv = du
    zero = torch.zeros_like(du)
    disp = tx.eval_gray(textures, bump_tex, uv, zero)
    disp_u = tx.eval_gray(textures, bump_tex,
                          uv + torch.stack([du, zero], -1), zero)
    disp_v = tx.eval_gray(textures, bump_tex,
                          uv + torch.stack([zero, dv], -1), zero)
    ddu = (disp_u - disp) / du
    ddv = (disp_v - disp) / dv
    dpdu_b = dpdu + ddu[..., None] * ns
    dpdv_b = dpdv + ddv[..., None] * ns
    c = _cross(dpdu_b, dpdv_b)
    ns_b = c * torch.sqrt(1.0 / torch.clamp(_dot(c, c)[..., None],
                                            min=1e-30))
    # keep the bumped normal in the original shading hemisphere
    ns_b = torch.where(_dot(ns_b, ns)[..., None] < 0.0, -ns_b, ns_b)
    has_bump = (bump_tex >= 0)[..., None]
    return (torch.where(has_bump, ns_b, ns),
            torch.where(has_bump, dpdu_b, dpdu))


def resolve_params(mtab: torch.Tensor, mat_id, ns, ng, dpdu, uv=None,
                   textures=None, dpdv=None, duvdx=None, duvdy=None,
                   tex_filter: str = "trilinear", tex_present=None):
    """The hit's material parameters, texture-resolved (the pre-recipe
    half of the JAX package's compute_scattering).  mtab: the [M,16]
    rows of ``param_table`` on the lanes' device.  Returns (mtype, kd,
    ks, sigma, roughness, eta, dissolve, ns', dpdu'), ns / dpdu possibly
    bump-mapped.  tex_present: ``tex_channel_presence`` of the table
    (host-static; None looks up every channel)."""
    row = mtab[mat_id.long()]
    mtype = row[:, 0].to(torch.int32)
    kd = row[:, 1:4]
    ks = row[:, 4:7]
    sigma = row[:, 7]
    roughness = row[:, 8]
    eta = row[:, 9]
    dissolve = row[:, 10]
    if textures is not None and uv is not None:
        from arendur_tpu_torch.texturing import texture as tx
        has = lambda i: tex_present is None or bool(tex_present[i])
        tid = lambda c: row[:, c].to(torch.int32)
        if has(0):
            kd = tx.eval_rgb(textures, tid(11), uv, kd, duvdx=duvdx,
                             duvdy=duvdy, filter=tex_filter)
        if has(1):
            ks = tx.eval_rgb(textures, tid(12), uv, ks, duvdx=duvdx,
                             duvdy=duvdy, filter=tex_filter)
        if has(2):
            sigma = tx.eval_gray(textures, tid(13), uv, sigma,
                                 duvdx=duvdx, duvdy=duvdy)
        if dpdv is not None and has(3):
            ns, dpdu = apply_bump(textures, tid(14), uv, ns, ng, dpdu,
                                  dpdv, duvdx=duvdx, duvdy=duvdy)
    return mtype, kd, ks, sigma, roughness, eta, dissolve, ns, dpdu


def build_slots(mtype, kd, ks, sigma, roughness, eta, dissolve, ns, ng,
                dpdu, presence=None, dist_sets=None):
    """The material recipe over resolved per-lane parameters ([N] or
    [N,3] rows) -> a row-form BsdfSlots (twin: materials.build_slots;
    the math is render/cbounce.py's component form)."""
    from arendur_tpu_torch.bxdf.slots import BsdfSlots
    from arendur_tpu_torch.render import cbounce as cb
    c = lambda x: (x[:, 0], x[:, 1], x[:, 2])
    return BsdfSlots.from_c(cb.build_slots(
        mtype, c(kd), c(ks), sigma, roughness, eta, dissolve, c(ns), c(ng),
        c(dpdu), presence=presence, dist_sets=dist_sets))


def compute_scattering(table: MaterialTable, mtab: torch.Tensor, mat_id,
                       ns, ng, dpdu, uv=None, textures=None, dpdv=None,
                       duvdx=None, duvdy=None,
                       tex_filter: str = "trilinear", tex_present=None):
    """The BSDF slot table of N hits (twin: materials.compute_scattering):
    the hit's material row of mtab (``param_table`` of `table` on the
    lanes' device), texture-resolved where the row names a texture, then
    the recipe.  `table` gives the host-static slot and distribution
    sets."""
    (mtype, kd, ks, sigma, roughness, eta, dissolve, ns, dpdu) = \
        resolve_params(mtab, mat_id, ns, ng, dpdu, uv=uv,
                       textures=textures, dpdv=dpdv, duvdx=duvdx,
                       duvdy=duvdy, tex_filter=tex_filter,
                       tex_present=tex_present)
    return build_slots(mtype, kd, ks, sigma, roughness, eta, dissolve, ns,
                       ng, dpdu, presence=slot_presence(table),
                       dist_sets=dist_presence(table))
