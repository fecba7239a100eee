"""Sharded rendering and material fitting over ranks (port of
arendur_tpu/parallel/mesh.py; ref: renderer/pt.rs:131,163-167, the
tile merge film.rs:82-101).

The JAX package drives a 1-D ``rays`` mesh of devices from one process
under ``shard_map``.  The port runs one process per device, in
PyTorch's idiom: a ``RayMesh`` names a ``torch.distributed`` process
group, this process's rank in it, its size and this rank's device.

* every rank holds its own replica of the scene tables, built on its own
  device from the same SceneData (the replicated tables of the JAX
  mesh);
* each wave of camera rays is cut into ``size`` contiguous shards, rank
  r tracing ``ray_idx[r * wave / size : (r + 1) * wave / size]`` (what
  ``shard_map(in_specs=P("rays"))`` hands device r); the counter-based
  sampler, keyed by pixel and sample index, makes a ray's radiance
  independent of the rank that traces it;
* each rank splats its shards into a film of its own, and one sum
  all-reduce of rgb and weight merges the films before the finalize
  (the ``psum`` of the JAX mesh, the reference's tile merge; the film is
  a plain sum, so once a render and not once a wave): NCCL between
  cards, gloo on the CPU.  The sharded render is integrator.render with
  a ray group;
* for material fitting, the loss is taken on the merged film, the same
  on every rank, and each rank's parameter gradient of its own shard is
  summed once over the ranks (``sharded_train_step_fn``).

Without an initialised process group every collective is the
identity: ``train_step_fn`` is that one-rank case.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from arendur_tpu_torch import materials as mats
from arendur_tpu_torch import scene as sc
from arendur_tpu_torch.filming import camera as cam
from arendur_tpu_torch.filming import film as flm
from arendur_tpu_torch.render import integrator as integ
from arendur_tpu_torch.sampling import sampler as smp

AXIS = "rays"
PARAM_KEYS = ("kd", "ks", "roughness")


def _device(device) -> torch.device:
    """A device with its index made explicit (cuda -> cuda:current)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


@dataclasses.dataclass(frozen=True)
class RayMesh:
    """The ray group: the JAX package's 1-D ``rays`` mesh as a process
    group (None: no process group, the one-rank group), this process's
    rank in it, the group's size and this rank's device."""
    group: Optional[object]
    rank: int
    size: int
    device: torch.device

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum t over the group in place and return it (NCCL sums on the
        cards; gloo stages a CUDA tensor through the host itself).  A
        strided view (a gradient column of the material table) is summed
        in a dense copy: the collectives read a tensor's memory as if it
        were dense.  With no process group the sum is the identity."""
        if self.group is None:
            return t
        buf = t.contiguous()
        dist.all_reduce(buf, group=self.group)
        if buf is not t:
            t.copy_(buf)
        return t

    def shard(self, ray_idx: torch.Tensor) -> torch.Tensor:
        """This rank's contiguous shard of a wave's ray indices."""
        n = ray_idx.shape[0]
        if n % self.size:
            raise ValueError(f"a wave of {n} rays does not divide over "
                             f"{self.size} ranks")
        m = n // self.size
        return ray_idx[self.rank * m:(self.rank + 1) * m]


def make_ray_mesh(group=None, device=None) -> RayMesh:
    """The ray group over `group` (default: the world group when a
    process group is initialised, else the one-rank group) with this
    rank's `device` (default: the current card, which init_distributed
    sets to the rank's own)."""
    device = _device("cuda" if device is None else device)
    if not dist.is_initialized():
        if group is not None:
            raise ValueError("a process group was given, but "
                             "torch.distributed is not initialised")
        return RayMesh(None, 0, 1, device)
    group = group if group is not None else dist.group.WORLD
    return RayMesh(group, dist.get_rank(group), dist.get_world_size(group),
                   device)


def _check_device(scene: sc.DeviceScene, mesh: RayMesh):
    if _device(scene.device) != mesh.device:
        raise ValueError(f"the scene lies on {scene.device}, the ray "
                         f"group's rank on {mesh.device}")


class _FilmSum(torch.autograd.Function):
    """The film's sum over the ranks inside the differentiated graph.
    Its backward passes the cotangent through unsummed: the loss is taken
    on the summed film on every rank alike, so every rank's cotangent of
    the sum is already the whole one, and the derivative of the sum with
    respect to this rank's film is the identity."""

    @staticmethod
    def forward(ctx, mesh, t):
        return mesh.all_reduce_(t.clone())

    @staticmethod
    def backward(ctx, g):
        return None, g


def _film_sum(mesh: RayMesh, t: torch.Tensor) -> torch.Tensor:
    return t if mesh.group is None else _FilmSum.apply(mesh, t)


def sharded_render_fn(scene: sc.DeviceScene, camera: cam.CameraData,
                      film_cfg: flm.FilmConfig, config: integ.RenderConfig,
                      mesh: RayMesh, ops: integ.WaveOps = integ.KERNEL_OPS):
    """Returns fn(i) -> FilmState: wave i of render_sharded's waves (the
    JAX package's fn takes that wave's ray indices, i * wave +
    arange(wave)), this rank's shard traced and splatted into a fresh
    film by integrator.render_wave, then summed over the ray group.
    Every rank passes the same i.  ops: as integrator.trace_wave's
    (KERNEL_OPS: K1-K3 on a cluster scene, K1 / K2 / K5 / K6 textured,
    K1 / K2 / K8 / K9 composed)."""
    _check_device(scene, mesh)

    def run(i: int):
        state = integ.render_film_init(scene, film_cfg, config, mesh.size)[0]
        integ.render_wave(scene, camera, film_cfg, config, state, i, ops=ops,
                          mesh=mesh)
        mesh.all_reduce_(state.rgb)
        mesh.all_reduce_(state.weight)
        return state

    return run


def render_sharded(scene: sc.DeviceScene, camera: cam.CameraData,
                   film_cfg: flm.FilmConfig, config: integ.RenderConfig,
                   mesh: RayMesh, ops: integ.WaveOps = integ.KERNEL_OPS,
                   **kw):
    """Full render over the ray group: integrator.render with `mesh`
    (waves of min(wave_size, W*H*spp) rays rounded up to a multiple of
    the group's size, each rank's shard splatted into its own film, the
    films summed once before the finalize).  The splat is the
    scatter-free film_splat_pixmajor where every rank's shard is whole
    pixels and the waves tile the frame, else the scatter film_splat of
    the JAX package's sharded path.  kw: render's other options.
    Returns the finalized [H, W, 3] image, the same on every rank."""
    _check_device(scene, mesh)
    return integ.render(scene, camera, film_cfg, config, ops=ops, mesh=mesh,
                        **kw)


def film_mse(film_cfg: flm.FilmConfig, state: flm.FilmState, target):
    """Masked film MSE (twin of the JAX loss): mean over the pixels that
    received weight of (image - target)^2, target [H*W,3]."""
    rgb, wgt = state.rgb, state.weight
    img = torch.where((wgt > 0.0)[:, None],
                      rgb / torch.clamp(wgt, min=1e-8)[:, None], 0.0)
    mask = (wgt > 0.0)[:, None]
    err = torch.where(mask, (img - target) ** 2, 0.0)
    return err.sum() / torch.clamp(mask.sum().to(err.dtype), min=1.0)


def sharded_train_step_fn(scene: sc.DeviceScene, camera: cam.CameraData,
                          film_cfg: flm.FilmConfig,
                          config: integ.RenderConfig, mesh: RayMesh,
                          lr: float = 0.05,
                          ops: integ.WaveOps = integ.KERNEL_OPS):
    """One material-optimization step, sharded over the ray group.

    Returns fn(params, target [H*W,3], ray_idx [N]) -> (new_params,
    loss), the same on every rank; every rank passes the same params,
    target and ray_idx, and N must divide by the group's size.  params
    is a dict with any of the keys {"kd", "ks", "roughness"}
    (material-table columns, [M,3], [M,3], [M]); a bare [M,3] tensor
    means {"kd": ...} and comes back bare.  Each rank traces its shard
    through the differentiable render (detached-sampling estimator; on a
    CUDA scene K1-K3 forward and the bounce-shade backward K4, on a
    scene only the composed bounce serves K1 / K2 / K8 / K9 forward and
    autograd over their plain versions backward), splats it into a
    fresh film and sums the film over the ranks inside the graph; the
    loss is the masked film MSE of the summed film.  The update is plain
    SGD.

    How often each gradient is summed, and why the step is the
    one-device step of the whole wave: the summed film F = sum_r F_r
    enters the same loss on every rank, so each rank's cotangent of F is
    the whole dL/dF.  The film sum's backward (_FilmSum) passes it to
    F_r unsummed (summed zero times), and rank r's autograd yields
    (dF_r/dp)^T dL/dF, its own shard's share of the gradient.  Those
    shares are summed once over the ranks (one all-reduce of the
    parameter gradients), which gives sum_r (dF_r/dp)^T dL/dF = dL/dp
    of the whole wave.  Summing the film's cotangent as well (the
    backward of torch.distributed.nn.functional.all_reduce) would make
    it size times too large.  ops=PLAIN_OPS runs the wave through the
    plain PyTorch versions of the kernels.
    """
    _check_device(scene, mesh)
    w, h = film_cfg.resolution
    spp = config.spp
    total = w * h * spp
    dev = mesh.device
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
        ray_idx = mesh.shard(ray_idx.reshape(-1).to(dev))
        pixel_xy, pixel_id, sample_id = integ.wave_pixels(ray_idx, w, spp)
        scene2 = dataclasses.replace(
            scene, mtab=mats.param_table_t(scene.materials, dev, **leaves))
        pfilm, L = integ.trace_wave(scene2, camera, config, pixel_xy,
                                    pixel_id, sample_id, base_key, ops=ops)
        state = flm.film_splat(film_cfg, flm.film_init(film_cfg, dev),
                               pfilm, L, mask=ray_idx < total)
        state = flm.FilmState(rgb=_film_sum(mesh, state.rgb),
                              weight=_film_sum(mesh, state.weight))
        loss = film_mse(film_cfg, state, target.to(dev))
        keys = list(leaves)
        grads = torch.autograd.grad(loss, [leaves[k] for k in keys])
        new = {k: (leaves[k] - lr * mesh.all_reduce_(g)).detach()
               for k, g in zip(keys, grads)}
        loss = loss.detach()
        return (new["kd"], loss) if bare else (new, loss)

    return step


def train_step_fn(scene: sc.DeviceScene, camera: cam.CameraData,
                  film_cfg: flm.FilmConfig, config: integ.RenderConfig,
                  lr: float = 0.05, ops: integ.WaveOps = integ.KERNEL_OPS):
    """One material-optimization step on the scene's device alone: the
    one-rank case of sharded_train_step_fn (no collective), whatever
    process group is initialised."""
    mesh = RayMesh(None, 0, 1, _device(scene.device))
    return sharded_train_step_fn(scene, camera, film_cfg, config, mesh,
                                 lr=lr, ops=ops)
