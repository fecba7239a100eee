"""Projective cameras (port of arendur_tpu/filming/camera.py; ref:
src/filming/perspective.rs, ortho.rs, projective.rs).

Cameras are built on the host with NumPy; ``generate_rays`` runs on
the device of the film samples it is given.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from arendur_tpu_torch.geometry import transform as tf
from arendur_tpu_torch.render import cmath as cm


@dataclasses.dataclass(frozen=True, eq=False)
class CameraData:
    """Camera constants shared by perspective/ortho (NumPy leaves)."""
    view_parent: np.ndarray    # [4,4]
    parent_view: np.ndarray    # [4,4]
    raster_view: np.ndarray    # [4,4]
    view_screen: np.ndarray    # [4,4]
    screen_raster: np.ndarray  # [4,4]
    dx: np.ndarray             # [3] raster x-step in view space
    dy: np.ndarray             # [3]
    lens: np.ndarray           # [2] (radius, focal_distance); 0 = pinhole
    area: np.float32           # screen area at z=1
    kind: int = 0              # 0 = perspective, 1 = ortho


def _proj_info(view_screen, screen_min, screen_max, resolution):
    """raster<->screen<->view matrix set (ref: projective.rs:22-46)."""
    resx, resy = float(resolution[0]), float(resolution[1])
    sxmin, symin = float(screen_min[0]), float(screen_min[1])
    sxmax, symax = float(screen_max[0]), float(screen_max[1])
    scale = np.diag(np.array(
        [(sxmax - sxmin) / resx, (symin - symax) / resy, 1.0, 1.0],
        np.float32))
    translate = np.eye(4, dtype=np.float32)
    translate[3, :3] = [sxmin, symax, 0.0]
    raster_screen = scale @ translate
    screen_raster = np.linalg.inv(raster_screen)
    raster_view = raster_screen @ np.linalg.inv(view_screen)
    return raster_screen, screen_raster, raster_view


def make_perspective(parent_view, screen_min, screen_max, znear, zfar,
                     fov, lens: Optional[Tuple[float, float]],
                     resolution) -> CameraData:
    """Perspective camera (ref: perspective.rs:40-107)."""
    parent_view = np.asarray(parent_view, np.float32)
    view_parent = np.linalg.inv(parent_view)
    view_screen = np.asarray(tf.perspective_matrix(fov, znear, zfar),
                             np.float32)
    _, screen_raster, raster_view = _proj_info(
        view_screen, screen_min, screen_max, resolution)

    def rv_point(p):
        p = np.asarray(p, np.float32)
        out = p @ raster_view[:3, :3] + raster_view[3, :3]
        w = p @ raster_view[:3, 3] + raster_view[3, 3]
        return out / w

    pmin = rv_point([0.0, 0.0, 0.0])
    pmin = pmin / pmin[2]
    pmax = rv_point([float(resolution[0]), float(resolution[1]), 0.0])
    pmax = pmax / pmax[2]
    area = abs((pmax[0] - pmin[0]) * (pmax[1] - pmin[1]))
    origin = rv_point([0.0, 0.0, 0.0])
    dx = rv_point([1.0, 0.0, 0.0]) - origin
    dy = rv_point([0.0, 1.0, 0.0]) - origin
    lens_arr = np.asarray(lens if lens is not None else (0.0, 0.0),
                          np.float32)
    return CameraData(
        view_parent=view_parent, parent_view=parent_view,
        raster_view=raster_view, view_screen=view_screen,
        screen_raster=screen_raster,
        dx=np.asarray(dx, np.float32), dy=np.asarray(dy, np.float32),
        lens=lens_arr, area=np.float32(area), kind=0)


def make_ortho(parent_view, screen_min, screen_max, znear, zfar,
               lens, resolution) -> CameraData:
    """Orthographic camera (ref: src/filming/ortho.rs)."""
    parent_view = np.asarray(parent_view, np.float32)
    view_parent = np.linalg.inv(parent_view)
    f, n = float(zfar), float(znear)
    view_screen = np.array(
        [[1.0, 0, 0, 0],
         [0, 1.0, 0, 0],
         [0, 0, 1.0 / (f - n), 0],
         [0, 0, -n / (f - n), 1.0]], np.float32)
    _, screen_raster, raster_view = _proj_info(
        view_screen, screen_min, screen_max, resolution)
    lens_arr = np.asarray(lens if lens is not None else (0.0, 0.0),
                          np.float32)
    dx = np.asarray([1.0, 0.0, 0.0], np.float32) @ raster_view[:3, :3]
    dy = np.asarray([0.0, 1.0, 0.0], np.float32) @ raster_view[:3, :3]
    return CameraData(
        view_parent=view_parent, parent_view=parent_view,
        raster_view=raster_view, view_screen=view_screen,
        screen_raster=screen_raster,
        dx=np.asarray(dx, np.float32), dy=np.asarray(dy, np.float32),
        lens=lens_arr, area=np.float32(1.0), kind=1)


def _normalize(a):
    n2 = torch.clamp((a * a).sum(-1, keepdim=True), min=1e-30)
    return a * torch.sqrt(1.0 / n2)


def generate_rays(cam: CameraData, pfilm: torch.Tensor,
                  plens: torch.Tensor):
    """World-space camera rays for film points pfilm [N, 2]; returns
    (origin [N,3], dir [N,3]) on pfilm's device (ref:
    perspective.rs:271-290, thin lens included)."""
    dev = pfilm.device
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    n = pfilm.shape[0]
    pfilm3 = torch.cat([pfilm, torch.zeros(n, 1, device=dev)], dim=-1)
    pview = tf.transform_point(t(cam.raster_view), pfilm3)
    if cam.kind == 0:
        o = torch.zeros(n, 3, device=dev)
        d = _normalize(pview)
    else:
        o = pview
        d = torch.tensor([0.0, 0.0, 1.0], device=dev).expand(n, 3)
    lens_r = float(cam.lens[0])
    focal = float(cam.lens[1])
    if lens_r > 0.0:
        px, py = cm.sample_concentric_disk((plens[:, 0], plens[:, 1]))
        pl = torch.stack([px, py], -1) * np.float32(lens_r)
        ft = np.float32(focal) / d[..., 2]
        pfocus = o + ft[..., None] * d
        o = torch.cat([pl, torch.zeros(n, 1, device=dev)], dim=-1)
        d = _normalize(pfocus - o)
    o_world = tf.transform_point(t(cam.view_parent), o)
    d_world = tf.transform_vector(t(cam.view_parent), d)
    return o_world, d_world


def generate_ray_differentials(cam: CameraData, pfilm: torch.Tensor,
                               plens: torch.Tensor):
    """The main ray and the directions of its x / y differential rays
    (ref: perspective.rs:292-320): (o, d, rxd, ryd), the differentials
    sharing the main ray's origin, as in the pinhole reference."""
    dev = pfilm.device
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    o, d = generate_rays(cam, pfilm, plens)
    n = pfilm.shape[0]
    pfilm3 = torch.cat([pfilm, torch.zeros(n, 1, device=dev)], dim=-1)
    pview = tf.transform_point(t(cam.raster_view), pfilm3)
    view_parent = t(cam.view_parent)
    rxd = tf.transform_vector(view_parent, _normalize(pview + t(cam.dx)))
    ryd = tf.transform_vector(view_parent, _normalize(pview + t(cam.dy)))
    return o, d, rxd, ryd
