"""Material-fitting train step (port of the one-device form of
arendur_tpu/parallel/mesh.py:sharded_train_step_fn).

One step traces one wave of camera rays through the differentiable
render, splats it into a fresh film, takes the masked film MSE against
a target image, and moves the material parameters one plain SGD step
along its gradient.  On a CUDA scene the wave's forward runs the
hand-written kernels K1-K3 and its backward the bounce-shade backward
kernel K4; on a scene only the composed bounce serves (emission
textures, no cluster tables) the forward runs K1, K2, K8 and K9 and the
backward is autograd over their plain versions.
"""

from __future__ import annotations

import dataclasses

import torch

from arendur_tpu_torch import materials as mats
from arendur_tpu_torch import scene as sc
from arendur_tpu_torch.filming import camera as cam
from arendur_tpu_torch.filming import film as flm
from arendur_tpu_torch.render import integrator as integ
from arendur_tpu_torch.sampling import sampler as smp

PARAM_KEYS = ("kd", "ks", "roughness")


def film_mse(film_cfg: flm.FilmConfig, state: flm.FilmState, target):
    """Masked film MSE (twin of the JAX loss): mean over the pixels that
    received weight of (image - target)^2, target [H*W,3]."""
    rgb, wgt = state.rgb, state.weight
    img = torch.where((wgt > 0.0)[:, None],
                      rgb / torch.clamp(wgt, min=1e-8)[:, None], 0.0)
    mask = (wgt > 0.0)[:, None]
    err = torch.where(mask, (img - target) ** 2, 0.0)
    return err.sum() / torch.clamp(mask.sum().to(err.dtype), min=1.0)


def train_step_fn(scene: sc.DeviceScene, camera: cam.CameraData,
                  film_cfg: flm.FilmConfig, config: integ.RenderConfig,
                  lr: float = 0.05, ops: integ.WaveOps = integ.KERNEL_OPS):
    """One material-optimization step on the scene's device.

    Returns fn(params, target [H*W,3], ray_idx [N]) -> (new_params,
    loss).  params is a dict with any of the keys {"kd", "ks",
    "roughness"} (material-table columns, [M,3], [M,3], [M]); a bare
    [M,3] tensor means {"kd": ...} and comes back bare.  The gradient
    flows through the differentiable render (detached-sampling
    estimator) and the update is plain SGD.

    This is the one-device form of the JAX sharded step: there the film
    and the gradients are psum-reduced over the ray mesh, which on one
    device is the identity.  The multi-device form (a torch.distributed
    all-reduce of film and gradients) is not ported yet.  ops=PLAIN_OPS
    runs the wave through the plain PyTorch versions of the kernels.
    """
    w, h = film_cfg.resolution
    spp = config.spp
    total = w * h * spp
    dev = scene.device
    base_key = smp.make_base_key(config.seed)

    def step(params, target, ray_idx):
        bare = not isinstance(params, dict)
        if bare:
            params = {"kd": params}
        unknown = set(params) - set(PARAM_KEYS)
        if unknown:
            raise ValueError(f"not material parameters: {sorted(unknown)}")
        leaves = {k: v.detach().to(dev).requires_grad_(True)
                  for k, v in params.items()}
        ray_idx = ray_idx.reshape(-1).to(dev)
        pixel_id = ray_idx // spp
        sample_id = ray_idx % spp
        pixel_xy = torch.stack([(pixel_id % w).to(torch.float32),
                                (pixel_id // w).to(torch.float32)], -1)
        scene2 = dataclasses.replace(
            scene, mtab=mats.param_table_t(scene.materials, dev, **leaves))
        pfilm, L = integ.trace_wave(scene2, camera, config, pixel_xy,
                                    pixel_id, sample_id, base_key, ops=ops)
        state = flm.film_splat(film_cfg, flm.film_init(film_cfg, dev),
                               pfilm, L, mask=ray_idx < total)
        loss = film_mse(film_cfg, state, target.to(dev))
        keys = list(leaves)
        grads = torch.autograd.grad(loss, [leaves[k] for k in keys])
        new = {k: (leaves[k] - lr * g).detach() for k, g in zip(keys, grads)}
        loss = loss.detach()
        return (new["kd"], loss) if bare else (new, loss)

    return step
