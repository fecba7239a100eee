"""Conversion of the JAX package's scene objects into the port's.

The JAX package keeps its SceneData, CameraData and FilmConfig leaves
as NumPy arrays on the host; these functions read those leaves (by
attribute, without importing JAX) and build the port's objects, so both
packages can run on identical cluster tables, cameras, films and
texture atlases.  This
plays the part weight conversion plays in a model port.
"""

from __future__ import annotations

import numpy as np

from arendur_tpu_torch import materials as mats
from arendur_tpu_torch import scene as sc
from arendur_tpu_torch.filming import camera as cam
from arendur_tpu_torch.filming import film as flm
from arendur_tpu_torch.sampling import filters as filt
from arendur_tpu_torch.shapes import sphere as sph
from arendur_tpu_torch.texturing import texture as tx

_TRI = ("tri_v0", "tri_v1", "tri_v2", "tri_n0", "tri_n1", "tri_n2",
        "tri_uv0", "tri_uv1", "tri_uv2", "tri_mat", "tri_light")


def _np(a):
    return None if a is None else np.asarray(a)


def _fields(obj, cls, **extra):
    import dataclasses
    kw = {f.name: _np(getattr(obj, f.name)) for f in dataclasses.fields(cls)
          if f.name not in extra}
    kw.update(extra)
    return cls(**kw)


def scene_data_from_numpy(scene) -> sc.SceneData:
    """The JAX package's SceneData (NumPy leaves) as the port's
    SceneData, its instanced meshes and its BVH included (the JAX
    package's native build, which the port's NumPy build equals)."""
    from arendur_tpu_torch.accel import bvh as bvhmod
    s = scene.spheres
    spheres = _fields(s, sph.SphereSoA, phi_full=bool(s.phi_full))
    lt = scene.lights
    lights = _fields(lt, sc.LightTable,
                     types_present=sc.light_types_present(lt))
    materials = _fields(scene.materials, mats.MaterialTable)
    dist = scene.light_distribution
    return sc.SceneData(
        **{k: _np(getattr(scene, k)) for k in _TRI},
        spheres=spheres, materials=materials, lights=lights,
        tri_cw=_np(scene.tri_cw), tri_cbox=_np(scene.tri_cbox),
        tri_remap=_np(scene.tri_remap),
        bvh=(None if getattr(scene, "bvh", None) is None
             else _fields(scene.bvh, bvhmod.BVH)),
        inst=tuple(_fields(im, sc.InstancedMesh)
                   for im in getattr(scene, "inst", ())),
        light_distribution=sc.Distribution1D(
            func=_np(dist.func), cdf=_np(dist.cdf),
            func_int=np.float32(dist.func_int)))


def scene_from_numpy(scene, device) -> sc.DeviceScene:
    """The JAX package's SceneData as the port's DeviceScene on
    `device`."""
    return sc.DeviceScene.build(scene_data_from_numpy(scene), device)


def camera_from_numpy(camera) -> cam.CameraData:
    return _fields(camera, cam.CameraData, area=np.float32(camera.area),
                   kind=int(camera.kind))


def film_from_numpy(film_cfg) -> flm.FilmConfig:
    f = film_cfg.filter
    spec = filt.FilterSpec(kind=f.kind, radius=tuple(f.radius),
                           alpha=f.alpha, b=f.b, c=f.c, tau=f.tau)
    return flm.FilmConfig(resolution=tuple(film_cfg.resolution),
                          filter=spec, crop_min=tuple(film_cfg.crop_min),
                          crop_max=tuple(film_cfg.crop_max))


def atlas_from_numpy(atlas, device="cpu"):
    """The JAX package's TextureAtlas (its leaves read as NumPy arrays)
    as the port's, on `device`; None stays None."""
    if atlas is None:
        return None
    return tx.TextureAtlas.from_arrays(
        *(np.asarray(getattr(atlas, k)) for k in (
            "texels", "offset", "width", "height", "n_levels", "wrap",
            "scale", "uv_scale", "uv_shift")), device=device)
