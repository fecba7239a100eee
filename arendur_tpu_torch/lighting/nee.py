"""Light selection and next-event estimation (port of
arendur_tpu/lighting/nee.py; ref: src/renderer/scene.rs:58-173).

``sample_one_light`` picks a light by power.  On the fused and split
paths the per-type light sampling, light pdf and MIS weights run inside
the bounce shade (render/cbounce.py).  The composed path calls them
here, over a DeviceScene and row tensors: ``light_sample`` (with the
sampled point's uv), ``light_branch`` (the light-sampling branch of
evaluate_direct: emission texture, the BSDF's fused evaluate + pdf,
MIS, the shadow query), ``path_mis_weight`` (the deferred BSDF branch)
and ``uniform_sample_one_light``.  They are built on the row helpers of
render/cbounce.py; the BSDF evaluation and the shadow query are
callables, the kernel entries by default.
"""

from __future__ import annotations

import torch

from arendur_tpu_torch import scene as sc
from arendur_tpu_torch.bxdf.types import ALL
from arendur_tpu_torch.sampling import distribution


def sample_one_light(scene, u: torch.Tensor):
    """Power-weighted light pick for a DeviceScene: (lidx, selpdf)."""
    return distribution.sample_discrete(scene.light_distribution, u)


def _c(x):
    return (x[:, 0], x[:, 1], x[:, 2])


def _r(v):
    return torch.stack(v, -1)


def _light_rows(scene: sc.DeviceScene, lidx):
    from arendur_tpu_torch.render import cbounce as cb
    return cb.CRow(scene.ltab, torch.clamp(lidx, min=0),
                   dict(scene.static.lcidx))


def light_sample(scene: sc.DeviceScene, lidx, pos, u2,
                 need_nl: bool = False) -> dict:
    """A light sample of light lidx [N] toward pos [N,3] (twin:
    nee.light_sample): dict(radiance [N,3], pdf, pfrom [N,3], wi [N,3],
    uv [N,2], delta), with need_nl also nl [N,3], the light's normal at
    pfrom (-wi for point, spot and distant lights)."""
    from arendur_tpu_torch.render import cbounce as cb
    ls = cb.light_sample_rows(_light_rows(scene, lidx),
                              scene.static.lpresent, _c(pos),
                              (u2[:, 0], u2[:, 1]), need_uv=True,
                              need_nl=need_nl)
    keys = ("radiance", "pfrom", "wi") + (("nl",) if need_nl else ())
    out = {k: _r(ls[k]) for k in keys}
    out.update(pdf=ls["pdf"], delta=ls["delta"], uv=_r(ls["uv"]))
    return out


def direct_light_contrib(ls: dict, f_raw, spdf, ns):
    """The unoccluded light-branch contribution and whether it needs a
    shadow ray (twin: nee.direct_light_contrib): (contrib [N,3],
    need_shadow [N])."""
    from arendur_tpu_torch.render import cbounce as cb
    lsc = dict(ls, radiance=_c(ls["radiance"]), wi=_c(ls["wi"]))
    contrib, need = cb.direct_light_contrib(lsc, _c(f_raw), spdf, _c(ns))
    return _r(contrib), need


def _occlusion_query(scene: sc.DeviceScene, hit: sc.Hit, pfrom,
                     n_alive=None, any_hit=None, any_hit_instanced=None):
    """The shadow ray from the shading point to the light sample, its
    surface end offset and its far end shrunk (twin:
    nee._occlusion_query; ref: lighting/mod.rs:125-133)."""
    from arendur_tpu_torch.render import cbounce as cb
    d = pfrom - hit.pos
    o = _r(cb.offset_ray_origin(_c(hit.pos), _c(hit.pos_err), _c(hit.ng),
                                _c(d)))
    seg = pfrom - o
    dist = torch.sqrt(torch.clamp((seg * seg).sum(-1), min=1e-20))
    return sc.occluded(scene, o, seg / dist[:, None], dist * (1.0 - 1e-3),
                       n_alive, any_hit=any_hit,
                       any_hit_instanced=any_hit_instanced)


def light_branch(scene: sc.DeviceScene, hit: sc.Hit, bsdf, wo, lidx, ulight,
                 n_alive=None, textures=None, eval_pdf=None, any_hit=None,
                 any_hit_instanced=None):
    """The light-sampling branch of evaluate_direct (twin:
    nee.light_branch; ref: scene.rs:92-126): radiance [N,3], not yet
    divided by the selection pdf.  eval_pdf: the BSDF's fused evaluate
    + pdf (kernel K9 on CUDA tensors by default)."""
    from arendur_tpu_torch.bxdf import slot_shade as ssh
    ls = light_sample(scene, lidx, hit.pos, ulight)
    if textures is not None:
        ls["radiance"] = ls["radiance"] * sc.emission_tex_factor(
            scene, lidx, ls["uv"], textures)
    f_raw, spdf = (eval_pdf or ssh.bsdf_eval_pdf)(bsdf, wo, ls["wi"], ALL)
    contrib, _ = direct_light_contrib(ls, f_raw, spdf, bsdf.ns)
    blocked = _occlusion_query(scene, hit, ls["pfrom"], n_alive, any_hit,
                               any_hit_instanced)
    return torch.where(blocked[:, None], 0.0, contrib)


def path_mis_weight(scene: sc.DeviceScene, lidx, selpdf, pos, wi2, pdf2,
                    kind2, f2):
    """The deferred BSDF-sampling branch's weight W [N] (twin:
    nee.path_mis_weight; ref: scene.rs:129-165): the continuation ray
    doubles as the MIS BSDF sample."""
    from arendur_tpu_torch.render import cbounce as cb
    return cb.path_mis_weight_rows(
        _light_rows(scene, lidx), scene.static.lpresent, selpdf, _c(pos),
        _c(wi2), pdf2, kind2, _c(f2))


def uniform_sample_one_light(scene: sc.DeviceScene, hit: sc.Hit, bsdf, wo,
                             u_select, ulight, n_alive=None, textures=None,
                             eval_pdf=None, any_hit=None,
                             any_hit_instanced=None):
    """ref: scene.rs:58-66.  (direct [N,3] divided by the selection pdf,
    lidx, selpdf)."""
    lidx, selpdf = sample_one_light(scene, u_select)
    term = light_branch(scene, hit, bsdf, wo, lidx, ulight, n_alive,
                        textures, eval_pdf, any_hit, any_hit_instanced)
    return term / torch.clamp(selpdf, min=1e-20)[:, None], lidx, selpdf
