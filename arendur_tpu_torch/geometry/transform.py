"""4x4 transforms in the reference's cgmath layout (port of
arendur_tpu/geometry/transform.py, as far as the camera needs it).

Matrices are stored as the JSON layout, one cgmath column per row, so
applying one is a row-vector product ``[p, 1] @ M`` followed by the
homogeneous divide.  Matrix construction is host-side NumPy; the
application runs on tensors of any device.
"""

from __future__ import annotations

import numpy as np
import torch


def transform_point(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply m [4,4] to points p [..., 3], with homogeneous divide
    (broadcast multiply + sum, the reference's operation order)."""
    out = (p[..., :, None] * m[:3, :3]).sum(-2) + m[3, :3]
    w = (p * m[:3, 3]).sum(-1) + m[3, 3]
    return out / w[..., None]


def transform_vector(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Apply m to directions v [..., 3] (no translation, no divide)."""
    return (v[..., :, None] * m[:3, :3]).sum(-2)


def perspective_matrix(fov, znear, zfar) -> np.ndarray:
    """Perspective view->screen matrix (ref: perspective.rs:93-107)."""
    f = float(zfar)
    n = float(znear)
    persp = np.array(
        [[1.0, 0.0, 0.0, 0.0],
         [0.0, 1.0, 0.0, 0.0],
         [0.0, 0.0, f / (f - n), 1.0],
         [0.0, 0.0, -f * n / (f - n), 0.0]], dtype=np.float32)
    inv_tan = 1.0 / np.tan(0.5 * float(fov))
    scale = np.diag(np.array([inv_tan, inv_tan, 1.0, 1.0],
                             dtype=np.float32))
    return (persp @ scale).astype(np.float32)


def look_at(eye, to, up) -> np.ndarray:
    """World->view matrix (ref: perspective.rs:109-121 look_from)."""
    eye = np.asarray(eye, np.float32)
    to = np.asarray(to, np.float32)
    up = np.asarray(up, np.float32)
    fwd = to - eye
    fwd = fwd / np.linalg.norm(fwd)
    s = np.cross(up, fwd)
    s = s / np.linalg.norm(s)
    u = np.cross(fwd, s)
    return np.array(
        [[s[0], u[0], fwd[0], 0.0],
         [s[1], u[1], fwd[1], 0.0],
         [s[2], u[2], fwd[2], 0.0],
         [-eye @ s, -eye @ u, -eye @ fwd, 1.0]], dtype=np.float32)
