"""Film: filtered sample splatting + finalize (port of
arendur_tpu/filming/film.py; ref: src/filming/film.rs).

The film is two flat accumulators, rgb_sum [H*W, 3] and weight_sum
[H*W], and for the bidirectional renderer a third, the additive splat
plane [H*W, 3] of its light-tracing (t = 1) contributions.  Unlike the
JAX version the splats update the state in place (the state tensors are
owned by the caller's render loop), which saves a full copy of the film
per wave.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from arendur_tpu_torch.sampling import filters as filt


@dataclasses.dataclass(frozen=True)
class FilmConfig:
    resolution: Tuple[int, int]           # (width, height)
    filter: filt.FilterSpec = filt.DEFAULT_FILTER
    crop_min: Tuple[int, int] = (0, 0)    # pixel coords
    crop_max: Tuple[int, int] = (-1, -1)  # -1 = resolution

    def crop(self):
        cmax = (self.crop_max[0] if self.crop_max[0] >= 0
                else self.resolution[0],
                self.crop_max[1] if self.crop_max[1] >= 0
                else self.resolution[1])
        return self.crop_min, cmax


@dataclasses.dataclass
class FilmState:
    rgb: torch.Tensor     # [H*W (+ 2 pad), 3] sum of weighted radiance
    weight: torch.Tensor  # [H*W (+ 2 pad)] sum of filter weights
    # True when rgb/weight carry film_pad() rows of halo on both ends
    # for the scatter-free pixel-major splat
    padded: bool = False
    splat: Optional[torch.Tensor] = None  # [H*W, 3] additive splat plane


def film_pad(config: FilmConfig) -> int:
    """Tap halo (pixels per side) of the dense splat."""
    (rx, ry), _ = filt.make_filter(config.filter)
    return int(math.ceil(max(rx, ry) - 0.5))


def _pad_flat(config: FilmConfig) -> int:
    w, _ = config.resolution
    p = film_pad(config)
    return p * w + p


def film_init(config: FilmConfig, device, padded: bool = False,
              with_splat: bool = False) -> FilmState:
    """An empty film; with_splat adds the splat plane."""
    w, h = config.resolution
    n = h * w + (2 * _pad_flat(config) if padded else 0)
    return FilmState(
        rgb=torch.zeros(n, 3, dtype=torch.float32, device=device),
        weight=torch.zeros(n, dtype=torch.float32, device=device),
        padded=padded,
        splat=(torch.zeros(h * w, 3, dtype=torch.float32, device=device)
               if with_splat else None))


def film_splat(config: FilmConfig, state: FilmState, pfilm, radiance,
               mask: Optional[torch.Tensor] = None) -> FilmState:
    """Scatter splat of N samples (pfilm [N,2] raster coords, radiance
    [N,3]) over a static ceil(2rx) x ceil(2ry) tap grid (ref:
    FilmTile::add_sample, film.rs:297-319)."""
    w, h = config.resolution
    (cx0, cy0), (cx1, cy1) = config.crop()
    (rx, ry), evaluate = filt.make_filter(config.filter)
    ntx = max(1, int(math.ceil(2.0 * rx)))
    nty = max(1, int(math.ceil(2.0 * ry)))
    dev = pfilm.device

    px = pfilm[:, 0]
    py = pfilm[:, 1]
    x0 = torch.floor(px - rx + 0.5).to(torch.int32)
    y0 = torch.floor(py - ry + 0.5).to(torch.int32)
    tx = x0[:, None] + torch.arange(ntx, dtype=torch.int32, device=dev)
    ty = y0[:, None] + torch.arange(nty, dtype=torch.int32, device=dev)
    ox = (tx.to(torch.float32) + 0.5) - px[:, None]
    oy = (ty.to(torch.float32) + 0.5) - py[:, None]
    off = torch.stack([
        ox[:, :, None].expand(-1, -1, nty),
        oy[:, None, :].expand(-1, ntx, -1)], dim=-1)
    wgt = evaluate(off)
    inside = ((torch.abs(off[..., 0]) <= rx)
              & (torch.abs(off[..., 1]) <= ry)
              & (tx[:, :, None] >= cx0) & (tx[:, :, None] < cx1)
              & (ty[:, None, :] >= cy0) & (ty[:, None, :] < cy1))
    if mask is not None:
        inside = inside & mask[:, None, None]
    wgt = torch.where(inside, wgt, 0.0)
    flat_idx = (torch.clamp(ty[:, None, :], 0, h - 1) * w
                + torch.clamp(tx[:, :, None], 0, w - 1)).reshape(-1)
    contrib = (wgt[..., None] * radiance[:, None, None, :]).reshape(-1, 3)
    state.rgb.index_add_(0, flat_idx.long(), contrib)
    state.weight.index_add_(0, flat_idx.long(), wgt.reshape(-1))
    return state


def film_splat_pixmajor(config: FilmConfig, state: FilmState, jitter,
                        radiance, pix0: int, spp: int,
                        mask: Optional[torch.Tensor] = None) -> FilmState:
    """Scatter-free splat for pixel-major waves: the N samples are the
    spp samples of N/spp consecutive pixels from flat pixel index pix0
    (sample-minor); jitter [N,2] is the sub-pixel offset.  The filter
    is evaluated separably and each of the (2p+1)^2 tap offsets is one
    shifted dense add in flat film-index space; the halo rows absorb
    off-image taps.  state must be film_init(..., padded=True)."""
    if not state.padded:
        raise ValueError("film_splat_pixmajor needs film_init(padded=True)")
    w, h = config.resolution
    (cx0, cy0), (cx1, cy1) = config.crop()
    (rx, ry), eval_x, eval_y = filt.make_filter_1d(config.filter)
    p = film_pad(config)
    padf = _pad_flat(config)
    nt = 2 * p + 1
    n = jitter.shape[0]
    n_pix = n // spp
    if n_pix * spp != n:
        raise ValueError("wave is not a whole number of pixels")
    dev = jitter.device

    jx = jitter[:, 0]
    jy = jitter[:, 1]
    pix_j = pix0 + torch.arange(n_pix, dtype=torch.int32, device=dev)
    sx = pix_j % w
    sy = pix_j // w
    doff = torch.arange(nt, dtype=torch.int32, device=dev) - p
    ox = (doff[None, :].to(torch.float32) + 0.5) - jx[:, None]
    oy = (doff[None, :].to(torch.float32) + 0.5) - jy[:, None]
    wx = torch.where(torch.abs(ox) <= rx, eval_x(ox), 0.0)
    wy = torch.where(torch.abs(oy) <= ry, eval_y(oy), 0.0)
    tap_x = sx[:, None] + doff[None, :]
    tap_y = sy[:, None] + doff[None, :]
    okx = (tap_x >= cx0) & (tap_x < min(cx1, w))
    oky = (tap_y >= cy0) & (tap_y < cy1)
    wx = wx * okx.repeat_interleave(spp, dim=0)
    wy = wy * oky.repeat_interleave(spp, dim=0)
    if mask is not None:
        wx = torch.where(mask[:, None], wx, 0.0)

    lw = torch.cat([radiance, torch.ones(n, 1, device=dev)], -1)
    wxs = wx.reshape(n_pix, spp, nt)
    wys = wy.reshape(n_pix, spp, nt)
    lws = lw.reshape(n_pix, spp, 4)
    # plane[j, dy, dx, c] = sum_s wy[j,s,dy] * wx[j,s,dx] * lw[j,s,c]
    plane = torch.einsum("jsd,jse,jsc->jdec", wys, wxs, lws)

    local = torch.zeros(n_pix + 2 * padf, 4, device=dev)
    for dy in range(nt):
        for dx in range(nt):
            off = (dy - p) * w + (dx - p) + padf
            local[off:off + n_pix] += plane[:, dy, dx, :]
    start = int(pix0)
    state.rgb[start:start + n_pix + 2 * padf] += local[:, :3]
    state.weight[start:start + n_pix + 2 * padf] += local[:, 3]
    return state


def film_add_splat(config: FilmConfig, state: FilmState, praster,
                   radiance, mask: Optional[torch.Tensor] = None) \
        -> FilmState:
    """Add N light-tracing splats (praster [N,2] raster positions,
    radiance [N,3]) to the splat plane, each to its nearest pixel, those
    outside the crop window dropped (twin: film.film_add_splat).  They
    are measurement-equation densities: summed, not averaged; the
    render scales the plane by 1/spp at film_finalize."""
    w, h = config.resolution
    (cx0, cy0), (cx1, cy1) = config.crop()
    ix = torch.floor(praster[:, 0]).to(torch.int32)
    iy = torch.floor(praster[:, 1]).to(torch.int32)
    inside = (ix >= cx0) & (ix < cx1) & (iy >= cy0) & (iy < cy1)
    if mask is not None:
        inside = inside & mask
    flat_idx = torch.clamp(iy, 0, h - 1) * w + torch.clamp(ix, 0, w - 1)
    contrib = torch.where(inside[:, None], radiance, 0.0)
    if state.splat is None:
        state.splat = torch.zeros(h * w, 3, dtype=torch.float32,
                                  device=praster.device)
    state.splat.index_add_(0, flat_idx.long(), contrib)
    return state


def film_finalize(state: FilmState, config: FilmConfig,
                  splat_scale: float = 0.0) -> torch.Tensor:
    """sum / weight per pixel, black where weight == 0 (ref:
    TilePixel::finalize, film.rs:338-345), plus splat_scale times the
    splat plane.  Returns [H, W, 3]."""
    w, h = config.resolution
    rgb_sum, wgt_sum = state.rgb, state.weight
    if state.padded:
        padf = _pad_flat(config)
        rgb_sum = rgb_sum[padf:padf + h * w]
        wgt_sum = wgt_sum[padf:padf + h * w]
    safe = torch.where(wgt_sum > 0.0, wgt_sum, 1.0)
    img = torch.where((wgt_sum > 0.0)[:, None],
                      rgb_sum / safe[:, None], 0.0)
    if state.splat is not None and splat_scale != 0.0:
        img = img + splat_scale * state.splat
    return img.reshape(h, w, 3)


def to_srgb_u8(img) -> np.ndarray:
    """Clamp to [0,1] and quantize to 8 bits (ref: film.rs:380-391)."""
    arr = img.detach().cpu().numpy() if isinstance(img, torch.Tensor) \
        else np.asarray(img)
    return (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def save_png(img, path: str):
    from PIL import Image
    Image.fromarray(to_srgb_u8(img), mode="RGB").save(path)
