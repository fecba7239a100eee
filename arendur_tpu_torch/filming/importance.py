"""Camera importance transport: the light-tracing (adjoint) side of the
perspective camera, which BPT's t = 1 strategies need (port of
arendur_tpu/filming/importance.py; ref: src/filming/perspective.rs:
evaluate_importance 332-365, evaluate_importance_sampled 367-401,
Camera::pdf 403-434).

  We(p, w) = 1 / (A * lensArea * cos^4 theta)   if w maps into the
             raster window (A = screen area at z=1), else 0;
  pdf_pos  = 1 / lensArea (a pinhole's delta position counts as 1);
  pdf_dir  = 1 / (A * cos^3 theta).

The view -> raster matrix is the float32 inverse of the camera's
raster_view, taken once per camera and device on the host (the JAX
package inverts it in float32 on every call).  Every function takes
row tensors ([N,3] points and directions) on one device.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from arendur_tpu_torch.filming.camera import CameraData
from arendur_tpu_torch.geometry import transform as tf
from arendur_tpu_torch.render import cmath as cm
from arendur_tpu_torch.sampling.warps import sample_concentric_disk

PI = math.pi


def view_raster(cam: CameraData) -> np.ndarray:
    """The view -> raster matrix: raster_view inverted in float32."""
    return np.linalg.inv(np.asarray(cam.raster_view, np.float32)) \
        .astype(np.float32)


@functools.lru_cache(maxsize=16)
def _mats(cam: CameraData, device: str):
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32),  # noqa: E731
                                  device=device)
    return dict(parent_view=t(cam.parent_view), view_parent=t(cam.view_parent),
                view_raster=t(view_raster(cam)))


def _lens_area(cam: CameraData) -> float:
    r = np.float32(cam.lens[0])
    return float(np.float32(PI) * r * r) if r > 0.0 else 1.0


def _normalize(a):
    return torch.stack(cm.vnormalize(a.unbind(-1)), -1)


def _raster_of(cam: CameraData, m: dict, pview, dview, resolution):
    """A view-space ray's raster position: (praster [N,2], inside [N],
    cos_theta [N])."""
    cos_t = dview[:, 2]
    safe = torch.where(cos_t != 0.0, cos_t, 1.0)
    ft = (float(np.float32(cam.lens[1])) / safe if cam.lens[0] > 0.0
          else 1.0 / safe)
    pfocus = pview + ft[:, None] * dview
    praster3 = tf.transform_point(m["view_raster"], pfocus)
    px, py = praster3[:, 0], praster3[:, 1]
    resx, resy = float(resolution[0]), float(resolution[1])
    inside = ((cos_t > 0.0) & (px >= 0.0) & (px < resx)
              & (py >= 0.0) & (py < resy))
    return torch.stack([px, py], -1), inside, cos_t


def _view_ray(m: dict, p, w):
    pview = tf.transform_point(m["parent_view"], p)
    dview = _normalize(tf.transform_vector(m["parent_view"], w))
    return pview, dview


def importance_eval(cam: CameraData, p, w, resolution):
    """We and raster position of world rays p [N,3], w [N,3] (unit,
    pointing away from the camera): (we [N], praster [N,2], valid [N])."""
    m = _mats(cam, str(p.device))
    praster, inside, cos_t = _raster_of(cam, m, *_view_ray(m, p, w),
                                        resolution)
    cos2 = cos_t * cos_t
    area_lens = float(np.float32(cam.area) * np.float32(_lens_area(cam)))
    we = 1.0 / torch.clamp(area_lens * cos2 * cos2, min=1e-20)
    return torch.where(inside, we, 0.0), praster, inside


def importance_sample(cam: CameraData, pos, u2, resolution) -> dict:
    """Sample a lens point seen from world points pos [N,3] (ref:
    perspective.rs:367-401): dict(we [N], praster [N,2], pdf [N] solid
    angle at pos, pcam [N,3] the lens point, wi [N,3] unit pos ->
    camera, valid [N])."""
    m = _mats(cam, str(pos.device))
    n = pos.shape[0]
    plens2 = float(np.float32(cam.lens[0])) * sample_concentric_disk(u2)
    plens_view = torch.cat([plens2, torch.zeros(n, 1, device=pos.device)],
                           -1)
    pcam = tf.transform_point(m["view_parent"], plens_view)
    seg = pcam - pos
    d2 = cm.vlength2(seg.unbind(-1))
    wi = seg * torch.rsqrt(torch.clamp(d2, min=1e-20))[:, None]
    # the cosine at the lens against the camera's forward axis
    fwd = _normalize(tf.transform_vector(
        m["view_parent"], torch.tensor([0.0, 0.0, 1.0],
                                       device=pos.device).expand(n, 3)))
    cos_t = cm.vdot((-wi).unbind(-1), fwd.unbind(-1))
    pdf = d2 / (torch.clamp(cos_t, min=1e-20) * _lens_area(cam))
    we, praster, valid = importance_eval(cam, pcam, -wi, resolution)
    ok = valid & (cos_t > 0.0)
    return dict(we=we, praster=praster, pdf=torch.where(ok, pdf, 0.0),
                pcam=pcam, wi=wi, valid=ok)


def importance_pdf(cam: CameraData, p, w, resolution):
    """(pdf_pos, pdf_dir) [N] of the camera having generated the ray
    (p, w) (ref: perspective.rs:403-434)."""
    m = _mats(cam, str(p.device))
    _, inside, cos_t = _raster_of(cam, m, *_view_ray(m, p, w), resolution)
    pdf_pos = torch.where(
        inside, float(np.float32(1.0) / np.float32(_lens_area(cam))), 0.0)
    cos3 = torch.clamp(cos_t, min=1e-20) ** 3
    pdf_dir = torch.where(inside,
                          1.0 / (float(np.float32(cam.area)) * cos3), 0.0)
    return pdf_pos, pdf_dir
