"""Reconstruction filters (port of arendur_tpu/sampling/filters.py;
ref: src/sample/filters.rs).

``make_filter`` returns (radius_xy, eval_fn) with eval_fn mapping
offsets [..., 2] to weights [...]; ``make_filter_1d`` returns the
separable per-axis factors the dense film splat uses.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Tuple

import torch

PI = math.pi


@dataclasses.dataclass(frozen=True)
class FilterSpec:
    kind: str = "lanczos"       # box|triangle|gaussian|mitchell|lanczos
    radius: Tuple[float, float] = (4.0, 4.0)
    alpha: float = 2.0          # gaussian
    b: float = 1.0 / 3.0        # mitchell
    c: float = 1.0 / 3.0        # mitchell
    tau: float = 3.0            # lanczos


def _sinc(x):
    xpi = x * PI
    small = x < 1e-5
    return torch.where(small, 1.0,
                       torch.sin(xpi) / torch.where(small, 1.0, xpi))


def _mitchell_1d(x, b, c):
    inv6 = 1.0 / 6.0
    hi = ((-b - 6.0 * c) * x ** 3 + (6.0 * b + 30.0 * c) * x ** 2
          - (12.0 * b + 48.0 * c) * x + (8.0 * b + 24.0 * c) * inv6)
    lo = ((12.0 - 9.0 * b - 6.0 * c) * x ** 3
          + (-18.0 + 12.0 * b + 6.0 * c) * x ** 2
          + (6.0 - 2.0 * b) * inv6)
    return torch.where(x > 1.0, hi, lo)


def _gauss_tail(na, r):
    return float(torch.exp(torch.tensor(na * r * r, dtype=torch.float32)))


def make_filter(spec: FilterSpec) -> Tuple[Tuple[float, float], Callable]:
    rx, ry = float(spec.radius[0]), float(spec.radius[1])
    (_, _), fx, fy = make_filter_1d(spec)
    if spec.kind == "box":
        def evaluate(p):
            return torch.ones(p.shape[:-1], dtype=p.dtype, device=p.device)
    elif spec.kind == "lanczos":
        inv_tau = 1.0 / float(spec.tau)

        def evaluate(p):
            ax = torch.abs(p[..., 0])
            ay = torch.abs(p[..., 1])
            return (_sinc(ax * inv_tau) * _sinc(ax)
                    * _sinc(ay * inv_tau) * _sinc(ay))
    else:
        def evaluate(p):
            return fx(p[..., 0]) * fy(p[..., 1])
    return (rx, ry), evaluate


def make_filter_1d(spec: FilterSpec):
    """Separable decomposition: ((rx, ry), eval_x, eval_y) with
    evaluate(p) == eval_x(p[..., 0]) * eval_y(p[..., 1])."""
    rx, ry = float(spec.radius[0]), float(spec.radius[1])
    kind = spec.kind
    if kind == "box":
        fx = fy = torch.ones_like
    elif kind == "triangle":
        fx = lambda x: rx - torch.abs(x)
        fy = lambda y: ry - torch.abs(y)
    elif kind == "gaussian":
        na = -float(spec.alpha)
        ex, ey = _gauss_tail(na, rx), _gauss_tail(na, ry)
        fx = lambda x: torch.clamp(torch.exp(na * x * x) - ex, min=0.0)
        fy = lambda y: torch.clamp(torch.exp(na * y * y) - ey, min=0.0)
    elif kind == "mitchell":
        b, c = float(spec.b), float(spec.c)
        fx = lambda x: _mitchell_1d(torch.abs(2.0 * x / rx), b, c)
        fy = lambda y: _mitchell_1d(torch.abs(2.0 * y / ry), b, c)
    elif kind == "lanczos":
        inv_tau = 1.0 / float(spec.tau)

        def _l1(x):
            ax = torch.abs(x)
            return _sinc(ax * inv_tau) * _sinc(ax)
        fx = fy = _l1
    else:
        raise ValueError(f"unknown filter kind {kind!r}")
    return (rx, ry), fx, fy


# The reference film's default filter (ref: film.rs:47-51)
DEFAULT_FILTER = FilterSpec(kind="lanczos", radius=(4.0, 4.0), tau=3.0)
