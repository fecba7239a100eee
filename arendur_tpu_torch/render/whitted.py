"""Whitted-style direct lighting (port of arendur_tpu/render/whitted.py;
ref: src/renderer/whitted.rs).

One closest hit per camera ray (kernel K1 on CUDA tensors), the
emission there, and for every light of the scene one light sample, the
BSDF's f (the fused evaluate + pdf, kernel K9) and a shadow ray (kernel
K2).  No bounce and no MIS: the reference's Whitted never recurses
despite its depth parameter (whitted.rs:42-79).  Its oddities are kept:
the BSDF is built without textures, and the cosine is the signed
dot(wi, ns).  ``render_whitted`` is the JAX CLI's _render_whitted.
"""

from __future__ import annotations

import torch

from arendur_tpu_torch import materials as mats
from arendur_tpu_torch import scene as sc
from arendur_tpu_torch.bxdf.types import ALL
from arendur_tpu_torch.filming import camera as cam
from arendur_tpu_torch.filming import film as flm
from arendur_tpu_torch.lighting import nee
from arendur_tpu_torch.render import cmath as cm
from arendur_tpu_torch.render.integrator import KERNEL_OPS, WaveOps
from arendur_tpu_torch.sampling import sampler as smp


def _sanitize(x):
    return torch.stack(cm.sanitize(tuple(x.unbind(-1))), -1)


def whitted_wave(scene: sc.DeviceScene, camera: cam.CameraData, config,
                 pixel_xy, pixel_id, sample_id, base_key,
                 ops: WaveOps = KERNEL_OPS):
    """Trace one wave with Whitted shading: (pfilm [N,2], L [N,3])."""
    keys = smp.ray_keys(base_key, pixel_id, sample_id)
    pfilm = pixel_xy + smp.stratified_film_sample(
        keys, sample_id, config.sample_dx, config.sample_dy, dim=0)
    o, d = cam.generate_rays(camera, pfilm, smp.uniform_2d(keys, 2))
    n = o.shape[0]
    hit = sc.intersect(scene, o, d, closest_hit=ops.closest_hit,
                       closest_hit_instanced=ops.closest_hit_instanced)
    wo = -d
    textures = config.textures
    if textures is not None:
        textures = textures.to(scene.device)
    le = sc.light_emission(scene, hit.light_id, hit.uv, textures)
    L = torch.where((hit.hit & (hit.light_id >= 0))[:, None], le, 0.0)
    bsdf = mats.compute_scattering(scene.materials, scene.mtab, hit.mat_id,
                                   hit.ns, hit.ng, hit.dpdu)
    ns = tuple(hit.ns.unbind(-1))
    for li in range(scene.ltab.shape[0]):
        lidx = torch.full((n,), li, dtype=torch.int32, device=o.device)
        ls = nee.light_sample(scene, lidx, hit.pos,
                              smp.uniform_2d(keys, 4 + 2 * li))
        wi = ls["wi"]
        f, _ = ops.bsdf_eval_pdf(bsdf, wo, wi, ALL)
        effective = hit.hit & (ls["pdf"] > 0.0) \
            & ~cm.is_black(tuple(ls["radiance"].unbind(-1))) \
            & ~cm.is_black(tuple(f.unbind(-1)))
        blocked = nee._occlusion_query(
            scene, hit, ls["pfrom"], any_hit=ops.any_hit,
            any_hit_instanced=ops.any_hit_instanced)
        contrib = f * ls["radiance"] * (
            cm.vdot(tuple(wi.unbind(-1)), ns)
            / torch.clamp(ls["pdf"], min=1e-20))[:, None]
        L = L + torch.where((effective & ~blocked)[:, None],
                            _sanitize(contrib), 0.0)
    return pfilm, _sanitize(L)


def render_whitted(scene: sc.DeviceScene, camera: cam.CameraData,
                   film_cfg: flm.FilmConfig, config,
                   ops: WaveOps = KERNEL_OPS, progress: bool = False):
    """The full Whitted render on the scene's device (twin: the JAX
    CLI's _render_whitted): waves over (pixels x spp), filtered into the
    film.  Returns [H, W, 3]."""
    dev = scene.device
    w, h = film_cfg.resolution
    spp = config.spp
    base_key = smp.make_base_key(config.seed)
    total = w * h * spp
    state = flm.film_init(film_cfg, dev)
    wave = min(config.wave_size, total)
    n_waves = (total + wave - 1) // wave
    for i in range(n_waves):
        ray_idx = i * wave + torch.arange(wave, dtype=torch.int64,
                                          device=dev)
        pixel_id = ray_idx // spp
        sample_id = ray_idx % spp
        pixel_xy = torch.stack([(pixel_id % w).to(torch.float32),
                                (pixel_id // w).to(torch.float32)], -1)
        with torch.no_grad():
            pfilm, L = whitted_wave(scene, camera, config, pixel_xy,
                                    pixel_id, sample_id, base_key, ops=ops)
        flm.film_splat(film_cfg, state, pfilm, L, mask=ray_idx < total)
        if progress:
            import logging
            logging.getLogger("arendur_tpu_torch").info(
                "whitted wave %d/%d done", i + 1, n_waves)
    return flm.film_finalize(state, film_cfg)
