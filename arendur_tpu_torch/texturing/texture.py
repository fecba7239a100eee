"""Image textures with mipmap pyramids and trilinear / anisotropic
filtering (port of arendur_tpu/texturing/texture.py; ref:
src/texturing/textures/image.rs).

Host side (NumPy, the JAX package's arithmetic op for op, so the built
arrays are equal): ``AtlasBuilder`` decodes images, builds each full
pyramid down to 1x1 with separable Lanczos3 halving, and packs every
texture of a scene into one flat texel pool of 4-float rows with
per-texture, per-level (offset, width, height) tables.

Device side (plain PyTorch, as the JAX package leaves these lookups to
XLA outside its kernels): ``sample_texture`` gathers by texture id with
Repeat / Black / Clamp wrap modes, trilinear between two levels with a
lod from the uv footprint, or the line-probe approximation of EWA.
Texel indices are computed in int32, as in the JAX package, and widened
to int64 only to index.

``texture_distribution_2d`` builds a 2-D importance distribution over a
texture's texels (sampling/distribution.py); ``transformed_mapping_3d``
maps points and their derivatives through a 4x4 transform.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

WRAP_REPEAT = 0
WRAP_BLACK = 1
WRAP_CLAMP = 2
_THIRD = float(np.float32(1.0 / 3.0))


def _lanczos3_taps():
    """12 taps of the factor-2 Lanczos3 decimation kernel: output texel
    o reads input texels 2o + r for r in [-5, 6] (image.rs:216-260)."""
    r = np.arange(-5, 7)
    x = (r - 0.5) / 2.0
    w = np.sinc(x) * np.sinc(x / 3.0)
    w[np.abs(x) >= 3.0] = 0.0
    return r, (w / w.sum()).astype(np.float32)


def _taken_spec(ndim: int, ax: int) -> str:
    """einsum spec contracting the taps axis (ax+1) of an ndim array
    against the 1-D kernel."""
    letters = "abcdefgh"[:ndim]
    out = letters[:ax + 1] + letters[ax + 2:]
    return f"{letters},{letters[ax + 1]}->{out}"


def _downsample2(img: np.ndarray) -> np.ndarray:
    """Halve each axis (>1) with separable Lanczos3 (clamped
    boundaries); axes too small for the 12-tap window use a box."""
    r, w = _lanczos3_taps()
    out = img
    for ax in (0, 1):
        n = out.shape[ax]
        if n <= 1:
            continue
        n2 = max(1, n // 2)
        if n < 4:
            sl = [slice(None)] * out.ndim
            sl[ax] = slice(0, 2 * n2)
            a2 = out[tuple(sl)]
            shape = list(a2.shape)
            shape[ax:ax + 1] = [n2, 2]
            out = a2.reshape(shape).mean(ax + 1)
        else:
            idx = np.clip(2 * np.arange(n2)[:, None] + r[None, :], 0, n - 1)
            taken = np.take(out, idx, axis=ax)   # [..., n2, 12, ...]
            out = np.einsum(_taken_spec(taken.ndim, ax), taken,
                            w).astype(np.float32)
    return np.ascontiguousarray(out.astype(np.float32))


@dataclasses.dataclass(frozen=True, eq=False)
class TextureAtlas:
    """All image textures of a scene in one flat [P, 4] texel pool
    (rgb + a pad float).  Per texture t and level l < n_levels[t]:
    offset / width / height [T, L] (padded with the last level).
    ``meta6`` and ``tmeta`` are the two packed tables the lookups
    gather from: per (texture, level) row t*L+l its (offset, width,
    height) and the next level's, and per texture (uv_scale, uv_shift,
    n_levels, wrap, scale)."""
    texels: torch.Tensor    # [P,4] float32
    offset: torch.Tensor    # [T,L] int32
    width: torch.Tensor     # [T,L] int32
    height: torch.Tensor    # [T,L] int32
    n_levels: torch.Tensor  # [T] int32
    wrap: torch.Tensor      # [T] int32
    scale: torch.Tensor     # [T] float32
    uv_scale: torch.Tensor  # [T,2] float32 (UVMapping scaling)
    uv_shift: torch.Tensor  # [T,2] float32
    meta6: torch.Tensor     # [T*L,6] int32
    tmeta: torch.Tensor     # [T,7] float32

    @property
    def count(self):
        return self.n_levels.shape[0]

    def to(self, device) -> "TextureAtlas":
        device = torch.device(device)
        if self.texels.device == device:
            return self
        return TextureAtlas(**{f.name: getattr(self, f.name).to(device)
                               for f in dataclasses.fields(self)})

    @staticmethod
    def from_arrays(texels, offset, width, height, n_levels, wrap, scale,
                    uv_scale, uv_shift, device="cpu") -> "TextureAtlas":
        """The atlas from its NumPy arrays (the packed tables derived
        here, once)."""
        offset, width, height = (np.asarray(a, np.int32)
                                 for a in (offset, width, height))
        meta3 = np.stack([offset, width, height], -1)          # [T,L,3]
        # each row also carries the NEXT level's (off, w, h), so one
        # gather serves both trilinear levels; the last row points at
        # itself, which is safe because f == 0 whenever l0 == max_level
        nxt = np.concatenate([meta3[:, 1:], meta3[:, -1:]], 1)
        meta6 = np.concatenate([meta3, nxt], -1).reshape(-1, 6)
        n_levels = np.asarray(n_levels, np.int32)
        wrap = np.asarray(wrap, np.int32)
        scale = np.asarray(scale, np.float32)
        uv_scale = np.asarray(uv_scale, np.float32)
        uv_shift = np.asarray(uv_shift, np.float32)
        tmeta = np.concatenate([
            uv_scale, uv_shift, n_levels.astype(np.float32)[:, None],
            wrap.astype(np.float32)[:, None], scale[:, None]], 1)
        t = lambda a: torch.tensor(np.asarray(a), device=device)
        return TextureAtlas(
            texels=t(np.asarray(texels, np.float32)), offset=t(offset),
            width=t(width), height=t(height), n_levels=t(n_levels),
            wrap=t(wrap), scale=t(scale), uv_scale=t(uv_scale),
            uv_shift=t(uv_shift), meta6=t(meta6), tmeta=t(tmeta))


class AtlasBuilder:
    def __init__(self):
        self.images: List[dict] = []

    def add_image(self, rgb: np.ndarray, wrap: int = WRAP_REPEAT,
                  gamma: bool = False, scale: float = 1.0,
                  uv_scale=(1.0, 1.0), uv_shift=(0.0, 0.0)) -> int:
        """rgb: [H,W,3] float in [0,1] (or uint8).  Returns texture id."""
        img = np.asarray(rgb)
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        img = img.astype(np.float32)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, -1)
        if gamma:
            # sRGB decode (ref: image.rs:621-627)
            img = np.where(img <= 0.04045, img / 12.92,
                           ((img + 0.055) / 1.055) ** 2.4)
        levels = [img]
        while levels[-1].shape[0] > 1 or levels[-1].shape[1] > 1:
            # clamp the Lanczos3 undershoot below zero at hard edges: a
            # negative kd / ks texel would become negative radiance
            levels.append(np.maximum(_downsample2(levels[-1]), 0.0))
        self.images.append(dict(levels=levels, wrap=wrap, scale=scale,
                                uv_scale=uv_scale, uv_shift=uv_shift))
        return len(self.images) - 1

    @staticmethod
    def _resample_bilinear(img: np.ndarray, h: int, w: int) -> np.ndarray:
        """Bilinearly resample [H0,W0,3] -> [h,w,3] (texel centers)."""
        h0, w0 = img.shape[:2]
        if (h0, w0) == (h, w):
            return img
        fy = (np.arange(h) + 0.5) * h0 / h - 0.5
        fx = (np.arange(w) + 0.5) * w0 / w - 0.5
        y0 = np.clip(np.floor(fy).astype(int), 0, h0 - 1)
        x0 = np.clip(np.floor(fx).astype(int), 0, w0 - 1)
        y1 = np.minimum(y0 + 1, h0 - 1)
        x1 = np.minimum(x0 + 1, w0 - 1)
        wy = np.clip(fy - y0, 0.0, 1.0)[:, None, None]
        wx = np.clip(fx - x0, 0.0, 1.0)[None, :, None]
        r0 = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
        r1 = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
        return (r0 * (1 - wy) + r1 * wy).astype(np.float32)

    def add_product(self, ta: int, tb=None, const=None) -> int:
        """Product texture (ref: textures/mod.rs ProductTexture), baked
        on the host: ta's level-0 image times `const` [3] and / or
        texture tb bilinearly resampled to ta's resolution; tb's scale
        multiplies in, wrap and uv mapping are ta's."""
        base = self.images[ta]["levels"][0]
        out = np.array(base, np.float32)
        scale = self.images[ta]["scale"]
        if const is not None:
            out = out * np.asarray(const, np.float32).reshape(1, 1, 3)
        if tb is not None:
            imb = self.images[tb]
            h, w = out.shape[:2]
            out = out * self._resample_bilinear(imb["levels"][0], h, w)
            scale = scale * imb["scale"]
        im = self.images[ta]
        return self.add_image(out, wrap=im["wrap"], scale=scale,
                              uv_scale=im["uv_scale"],
                              uv_shift=im["uv_shift"])

    def add_mix(self, t0: int, t1: int, l=None, l_tex: int = None) -> int:
        """Mix texture t0 * (1 - l) + t1 * l, `l` a constant or a gray
        texture id (ref: textures/mod.rs:62-94), baked on the host at
        t0's resolution."""
        im0 = self.images[t0]
        a = np.array(im0["levels"][0], np.float32)
        h, w = a.shape[:2]
        b = self._resample_bilinear(self.images[t1]["levels"][0], h, w)
        if l_tex is not None:
            lv = self._resample_bilinear(
                self.images[l_tex]["levels"][0], h, w)
            lv = lv.mean(-1, keepdims=True)
        else:
            lv = np.float32(0.5 if l is None else l)
        out = a * (1.0 - lv) + b * lv
        return self.add_image(out, wrap=im0["wrap"], scale=im0["scale"],
                              uv_scale=im0["uv_scale"],
                              uv_shift=im0["uv_shift"])

    def build(self, device="cpu") -> Optional[TextureAtlas]:
        if not self.images:
            return None
        max_l = max(len(im["levels"]) for im in self.images)
        texels = []
        offset = np.zeros((len(self.images), max_l), np.int32)
        width = np.zeros_like(offset)
        height = np.zeros_like(offset)
        n_levels = np.zeros(len(self.images), np.int32)
        cursor = 0
        for t, im in enumerate(self.images):
            n_levels[t] = len(im["levels"])
            for l in range(max_l):
                lev = im["levels"][min(l, len(im["levels"]) - 1)]
                if l < len(im["levels"]):
                    offset[t, l] = cursor
                    height[t, l], width[t, l] = lev.shape[:2]
                    # texel rows of 4 floats (16-byte aligned rows)
                    flat = lev.reshape(-1, 3)
                    texels.append(np.concatenate(
                        [flat, np.zeros_like(flat[:, :1])], 1))
                    cursor += lev.shape[0] * lev.shape[1]
                else:
                    offset[t, l] = offset[t, l - 1]
                    width[t, l] = width[t, l - 1]
                    height[t, l] = height[t, l - 1]
        return TextureAtlas.from_arrays(
            np.concatenate(texels, 0), offset, width, height, n_levels,
            [im["wrap"] for im in self.images],
            [im["scale"] for im in self.images],
            [im["uv_scale"] for im in self.images],
            [im["uv_shift"] for im in self.images], device=device)


# ---------------------------------------------------------------------------
# device-side lookups
# ---------------------------------------------------------------------------

def _floor_i32(x: torch.Tensor) -> torch.Tensor:
    return torch.floor(x).to(torch.int32)


def _wrap_coords(i, n, mode):
    """Wrapped integer texel coordinate and its out-of-range mask.
    torch.remainder follows Python's sign rule, as jnp.mod does, so
    negative coordinates wrap to [0, n)."""
    rep = torch.remainder(i, torch.clamp(n, min=1))
    clp = torch.minimum(torch.clamp(i, min=0), n - 1)
    out = torch.where(mode == WRAP_REPEAT, rep, clp)
    oob = (i < 0) | (i >= n)
    return out, oob


def _fetch_level(atlas: TextureAtlas, tex_id, level, x, y):
    """Texels at integer (x, y) of a level [N,3]; applies wrap."""
    tex_id, level = tex_id.long(), level.long()
    off = atlas.offset[tex_id, level]
    w = atlas.width[tex_id, level]
    h = atlas.height[tex_id, level]
    mode = atlas.wrap[tex_id]
    xi, oob_x = _wrap_coords(x, w, mode)
    yi, oob_y = _wrap_coords(y, h, mode)
    texel = atlas.texels[(off + yi * w + xi).long()][..., :3]
    black = (mode == WRAP_BLACK) & (oob_x | oob_y)
    return torch.where(black[..., None], 0.0, texel)


def _level_corners(mode, off, w, h, su, sv):
    """Bilinear corner indices and weights of one level from its packed
    (offset, width, height): (idx [N,4] int32, wt [N,4])."""
    wf = w.to(torch.float32)
    hf = h.to(torch.float32)
    x = su * wf - 0.5
    y = sv * hf - 0.5
    x0 = _floor_i32(x)
    y0 = _floor_i32(y)
    fx = x - x0.to(torch.float32)
    fy = y - y0.to(torch.float32)
    idx, wt = [], []
    for dx, dy, wgt in ((0, 0, (1 - fx) * (1 - fy)),
                        (1, 0, fx * (1 - fy)),
                        (0, 1, (1 - fx) * fy),
                        (1, 1, fx * fy)):
        xi, ox = _wrap_coords(x0 + dx, w, mode)
        yi, oy = _wrap_coords(y0 + dy, h, mode)
        black = (mode == WRAP_BLACK) & (ox | oy)
        idx.append(off + yi * w + xi)
        wt.append(torch.where(black, 0.0, wgt))
    return torch.stack(idx, -1), torch.stack(wt, -1)


def _trilinear_packed(atlas: TextureAtlas, tex_id, lod, su, sv, mode,
                      max_level):
    """Trilinear lookup with one gather of the packed level table and
    one [N,8] texel gather; the bilinear and level-lerp weights fold
    into one weighted sum."""
    n_lv = atlas.offset.shape[1]
    l = torch.minimum(torch.clamp(lod, min=0.0),
                      max_level.to(torch.float32))
    l0 = _floor_i32(l)
    f = l - l0.to(torch.float32)
    m = atlas.meta6[(tex_id * n_lv + l0).long()]            # [N,6]
    idx0, wt0 = _level_corners(mode, m[:, 0], m[:, 1], m[:, 2], su, sv)
    idx1, wt1 = _level_corners(mode, m[:, 3], m[:, 4], m[:, 5], su, sv)
    idx = torch.cat([idx0, idx1], -1)                       # [N,8]
    wts = torch.cat([wt0 * (1.0 - f)[:, None], wt1 * f[:, None]], -1)
    tex = atlas.texels[idx.long()][..., :3]                 # [N,8,3]
    terms = wts[..., None] * tex
    # summed in corner order, as XLA reduces the JAX package's sum
    out = terms[:, 0]
    for k in range(1, 8):
        out = out + terms[:, k]
    return out


MAX_ANISO = 8.0       # ref: image.rs max_aniso clamp
_EWA_ALPHA = 2.0      # gaussian falloff exponent (image.rs:629-641)
# the ellipse is integrated by MAX_PROBES bilinear probes along its
# clamped major axis (the line-probe approximation of the reference's
# texel-by-texel EWA, image.rs:514-532; static bounds, as in the JAX
# package)
MAX_PROBES = 8


def _bilinear_texel(atlas, tex_id, level, x, y):
    """Bilinear fetch at continuous texel coords (x, y) of a level."""
    x0 = _floor_i32(x)
    y0 = _floor_i32(y)
    fx = (x - x0.to(torch.float32))[..., None]
    fy = (y - y0.to(torch.float32))[..., None]
    c00 = _fetch_level(atlas, tex_id, level, x0, y0)
    c10 = _fetch_level(atlas, tex_id, level, x0 + 1, y0)
    c01 = _fetch_level(atlas, tex_id, level, x0, y0 + 1)
    c11 = _fetch_level(atlas, tex_id, level, x0 + 1, y0 + 1)
    return ((1 - fx) * (1 - fy) * c00 + fx * (1 - fy) * c10
            + (1 - fx) * fy * c01 + fx * fy * c11)


def _ewa_level(atlas, tex_id, level, su, sv, d0, d1):
    """Anisotropic filter at one level: gaussian-weighted bilinear
    probes along the major axis d0 (image.rs:489-532); the minor axis
    d1 is covered by each probe's bilinear footprint."""
    w = atlas.width[tex_id, level.long()].to(torch.float32)
    h = atlas.height[tex_id, level.long()].to(torch.float32)
    px = su * w - 0.5
    py = sv * h - 0.5
    mjx = d0[..., 0] * w
    mjy = d0[..., 1] * h
    mnx = d1[..., 0] * w
    mny = d1[..., 1] * h
    mj_len = torch.sqrt(torch.clamp(mjx * mjx + mjy * mjy, min=1e-20))
    mn_len = torch.sqrt(torch.clamp(mnx * mnx + mny * mny, min=1e-20))
    aniso = torch.clamp(mj_len / torch.clamp(mn_len, min=1e-8), 1.0,
                        MAX_ANISO)
    # probe half-extent: the end probes' footprints stay inside the
    # ellipse; 0 when isotropic
    half = 1.0 - 1.0 / aniso
    acc = torch.zeros(su.shape + (3,), dtype=torch.float32,
                      device=su.device)
    wsum = torch.zeros_like(su)
    for i in range(MAX_PROBES):
        s = ((i + 0.5) / MAX_PROBES * 2.0 - 1.0) * half
        tx = px + s * mjx
        ty = py + s * mjy
        wgt = torch.exp(-_EWA_ALPHA * s * s) - float(np.exp(-_EWA_ALPHA))
        wgt = torch.clamp(wgt, min=1e-6)
        texel = _bilinear_texel(atlas, tex_id, level, tx, ty)
        acc = acc + wgt[..., None] * texel
        wsum = wsum + wgt
    return acc / wsum[..., None]


def _ewa(atlas, tex_id, su, sv, duvdx, duvdy):
    """Anisotropic lookup (ref: image.rs:448-487): major / minor axes,
    clamped anisotropy, EWA blended between two levels."""
    sc = atlas.uv_scale[tex_id]
    d0 = duvdx * sc
    d1 = duvdy * sc
    len0 = torch.sqrt(torch.sum(d0 * d0, -1))
    len1 = torch.sqrt(torch.sum(d1 * d1, -1))
    swap = len0 < len1
    major = torch.where(swap[..., None], d1, d0)
    minor_v = torch.where(swap[..., None], d0, d1)
    major_l = torch.maximum(len0, len1)
    minor_l = torch.minimum(len0, len1)
    # clamp anisotropy (image.rs:472-479)
    need = (minor_l * MAX_ANISO < major_l) & (minor_l > 0.0)
    scale_f = torch.where(need, major_l / (minor_l * MAX_ANISO + 1e-20),
                          1.0)
    minor_v = minor_v * scale_f[..., None]
    minor_l = minor_l * scale_f
    n_levels = atlas.n_levels[tex_id].to(torch.float32)
    # lod from the minor axis length (image.rs:481-487)
    lod = torch.clamp(torch.log2(torch.clamp(minor_l, min=1e-8))
                      + n_levels - 1.0, min=0.0)
    max_level = atlas.n_levels[tex_id] - 1
    lod = torch.minimum(torch.clamp(lod, min=0.0),
                        max_level.to(torch.float32))
    l0 = _floor_i32(lod)
    l1 = torch.minimum(l0 + 1, max_level)
    f = (lod - l0.to(torch.float32))[..., None]
    return ((1 - f) * _ewa_level(atlas, tex_id, l0, su, sv, major, minor_v)
            + f * _ewa_level(atlas, tex_id, l1, su, sv, major, minor_v))


def sample_texture(atlas: TextureAtlas, tex_id, uv, lod=None,
                   duvdx=None, duvdy=None, filter: str = "trilinear"):
    """Batched lookup [N,3]: tex_id [N] integer, uv [N,2].

    lod [N] sets the trilinear level directly; duvdx / duvdy [N,2]
    (uv derivatives) derive it (trilinear) or drive the anisotropic
    filter (filter="ewa")."""
    tex_id = tex_id.to(torch.int32)
    tmeta = atlas.tmeta[tex_id.long()]                      # [N,7]
    su = uv[..., 0] * tmeta[:, 0] + tmeta[:, 2]
    sv = uv[..., 1] * tmeta[:, 1] + tmeta[:, 3]
    n_levels = tmeta[:, 4]
    mode = tmeta[:, 5].to(torch.int32)
    max_level = n_levels.to(torch.int32) - 1
    if duvdx is not None and filter == "ewa":
        out = _ewa(atlas, tex_id.long(), su, sv, duvdx, duvdy)
    elif duvdx is not None:
        # isotropic width = 2 * max |derivative| (image.rs:411-420)
        sc = tmeta[:, 0:2]
        width = 2.0 * torch.maximum(
            torch.amax(torch.abs(duvdx * sc), -1),
            torch.amax(torch.abs(duvdy * sc), -1))
        lod_w = n_levels - 1.0 + torch.log2(torch.clamp(width, min=1e-8))
        out = _trilinear_packed(atlas, tex_id, torch.clamp(lod_w, min=0.0),
                                su, sv, mode, max_level)
    else:
        out = _trilinear_packed(
            atlas, tex_id, torch.zeros_like(su) if lod is None else lod,
            su, sv, mode, max_level)
    return out * tmeta[:, 6][..., None]


def eval_rgb(atlas: Optional[TextureAtlas], tex_id, uv, fallback,
             duvdx=None, duvdy=None, filter: str = "trilinear"):
    """Image lookup where tex_id >= 0, else the constant fallback
    color [N,3]."""
    if atlas is None:
        return fallback
    tex = sample_texture(atlas, torch.clamp(tex_id, min=0), uv,
                         duvdx=duvdx, duvdy=duvdy, filter=filter)
    return torch.where((tex_id >= 0)[..., None], tex, fallback)


def eval_gray(atlas: Optional[TextureAtlas], tex_id, uv, fallback,
              duvdx=None, duvdy=None):
    """Scalar lookup (mean of rgb) with constant fallback [N]."""
    if atlas is None:
        return fallback
    tex = sample_texture(atlas, torch.clamp(tex_id, min=0), uv,
                         duvdx=duvdx, duvdy=duvdy)
    # the mean as XLA takes it, sum * (1/3): bump mapping divides the
    # difference of two such means by a step as small as 5e-4
    mean = (tex[:, 0] + tex[:, 1] + tex[:, 2]) * _THIRD
    return torch.where(tex_id >= 0, mean, fallback)


# ---------------------------------------------------------------------------
# image-texture importance distribution (ref: ImageTexture::distribution,
# texturing/textures/image.rs:47-55) and 3D transformed mapping
# (ref: texturing/mappings.rs:34-47)
# ---------------------------------------------------------------------------

def texture_distribution_2d(atlas: TextureAtlas, tex_id: int, f=None):
    """A Distribution2D (sampling/distribution.py, host-built) over a
    texture's level-0 texels, weighted by f(rgb) (default: luminance),
    the reference's ``ImageTexture::distribution`` (image.rs:47-55).
    Sampling it (sample_continuous_2d) yields uv with density
    proportional to the texture, e.g. to importance-sample a textured
    emitter."""
    from arendur_tpu_torch.sampling.distribution import build_distribution_2d
    off = int(atlas.offset[tex_id, 0])
    w = int(atlas.width[tex_id, 0])
    h = int(atlas.height[tex_id, 0])
    tex = atlas.texels[off:off + w * h, :3].cpu().numpy().reshape(h, w, 3)
    if f is None:
        weights = (0.212671 * tex[..., 0] + 0.715160 * tex[..., 1]
                   + 0.072169 * tex[..., 2])
    else:
        weights = np.apply_along_axis(f, -1, tex)
    return build_distribution_2d(np.maximum(weights, 0.0))


def transformed_mapping_3d(transform, pos, dpdx=None, dpdy=None):
    """3D texture mapping through a 4x4 transform (ref:
    texturing/mappings.rs:34-47 TransformedMapping): (p, dpdx, dpdy),
    the position [N,3] transformed as a point and the screen-space
    derivatives as vectors (None stays None).  transform: [4,4] in the
    row-vector convention (p' = p @ M[:3,:3] + M[3,:3])."""
    m = torch.as_tensor(np.asarray(transform, np.float32), device=pos.device)
    p = pos @ m[:3, :3] + m[3, :3]
    tx = dpdx @ m[:3, :3] if dpdx is not None else None
    ty = dpdy @ m[:3, :3] if dpdy is not None else None
    return p, tx, ty
