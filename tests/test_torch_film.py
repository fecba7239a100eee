"""Camera rays and the film (splat + finalize) of the port against
arendur_tpu.filming on identical inputs."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from arendur_tpu.filming import camera as jcam
from arendur_tpu.filming import film as jflm
from arendur_tpu.geometry import transform as jtf
from arendur_tpu.sampling import filters as jfilt
from arendur_tpu_torch import convert
from arendur_tpu_torch.filming import camera as tcam
from arendur_tpu_torch.filming import film as tflm

torch.set_num_threads(2)

RES = (24, 16)
RAY_TOL = 1e-6       # rtol and atol of camera rays (f32 transforms)
FILM_RTOL = 1e-5     # splat sums taken in another order


def _cameras():
    pv = np.asarray(jtf.look_at([0.5, 1.0, -3.0], [0, 0.5, 0.0],
                                [0, 1, 0.0]))
    yield "perspective", jcam.make_perspective(
        parent_view=pv, screen_min=(-1, -0.75), screen_max=(1, 0.7),
        znear=0.1, zfar=1000.0, fov=1.27, lens=None, resolution=RES)
    yield "thin-lens", jcam.make_perspective(
        parent_view=pv, screen_min=(-1, -0.75), screen_max=(1, 0.7),
        znear=0.1, zfar=1000.0, fov=0.9, lens=(0.05, 3.0), resolution=RES)
    yield "ortho", jcam.make_ortho(
        parent_view=pv, screen_min=(-2, -1.5), screen_max=(2, 1.5),
        znear=0.1, zfar=100.0, lens=None, resolution=RES)


@pytest.mark.parametrize("name", ["perspective", "thin-lens", "ortho"])
def test_camera_rays_match(name):
    jc = dict(_cameras())[name]
    tc = convert.camera_from_numpy(jc)
    rng = np.random.default_rng(0)
    pfilm = rng.uniform(0, 1, (2048, 2)).astype(np.float32) \
        * np.asarray(RES, np.float32)
    plens = rng.uniform(0, 1, (2048, 2)).astype(np.float32)
    jo, jd = jcam.generate_rays(jc, jnp.asarray(pfilm), jnp.asarray(plens))
    to, td = tcam.generate_rays(tc, torch.tensor(pfilm), torch.tensor(plens))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=RAY_TOL,
                               atol=RAY_TOL)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RAY_TOL,
                               atol=RAY_TOL)


FILTERS = [("lanczos", (4.0, 4.0)), ("box", (0.5, 0.5)),
           ("triangle", (1.5, 1.5)), ("gaussian", (2.0, 2.0)),
           ("mitchell", (2.0, 1.5))]


def _films(kind, radius):
    jcfg = jflm.FilmConfig(resolution=RES,
                           filter=jfilt.FilterSpec(kind=kind, radius=radius))
    return jcfg, convert.film_from_numpy(jcfg)


def _samples(spp, seed=0):
    rng = np.random.default_rng(seed)
    n = RES[0] * RES[1] * spp
    jit = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    rad = rng.uniform(0, 2, (n, 3)).astype(np.float32)
    return jit, rad


@pytest.mark.parametrize("kind,radius", FILTERS)
def test_splat_pixmajor_and_finalize_match(kind, radius):
    jcfg, tcfg = _films(kind, radius)
    spp = 4
    jit, rad = _samples(spp)
    npix = RES[0] * RES[1]
    mask = np.ones(npix * spp, bool)
    mask[-7:] = False
    js = jflm.film_init(jcfg, padded=True)
    ts = tflm.film_init(tcfg, "cpu", padded=True)
    half = npix // 2 * spp
    for lo, hi in ((0, half), (half, npix * spp)):
        js = jflm.film_splat_pixmajor(
            jcfg, js, jnp.asarray(jit[lo:hi]), jnp.asarray(rad[lo:hi]),
            jnp.int32(lo // spp), spp, mask=jnp.asarray(mask[lo:hi]))
        ts = tflm.film_splat_pixmajor(
            tcfg, ts, torch.tensor(jit[lo:hi]), torch.tensor(rad[lo:hi]),
            lo // spp, spp, mask=torch.tensor(mask[lo:hi]))
    np.testing.assert_allclose(ts.rgb.numpy(), np.asarray(js.rgb),
                               rtol=FILM_RTOL, atol=1e-6)
    np.testing.assert_allclose(ts.weight.numpy(), np.asarray(js.weight),
                               rtol=FILM_RTOL, atol=1e-6)
    np.testing.assert_allclose(
        tflm.film_finalize(ts, tcfg).numpy(),
        np.asarray(jflm.film_finalize(js, jcfg)), rtol=FILM_RTOL,
        atol=1e-6)


@pytest.mark.parametrize("kind,radius", FILTERS[:3])
def test_scatter_splat_matches(kind, radius):
    jcfg, tcfg = _films(kind, radius)
    rng = np.random.default_rng(1)
    n = 3000
    pfilm = (rng.uniform(0, 1, (n, 2)) * np.asarray(RES)).astype(np.float32)
    rad = rng.uniform(0, 2, (n, 3)).astype(np.float32)
    js = jflm.film_splat(jcfg, jflm.film_init(jcfg), jnp.asarray(pfilm),
                         jnp.asarray(rad))
    ts = tflm.film_splat(tcfg, tflm.film_init(tcfg, "cpu"),
                         torch.tensor(pfilm), torch.tensor(rad))
    np.testing.assert_allclose(
        tflm.film_finalize(ts, tcfg).numpy(),
        np.asarray(jflm.film_finalize(js, jcfg)), rtol=FILM_RTOL,
        atol=1e-6)


def test_save_png_roundtrip(tmp_path):
    from PIL import Image
    img = torch.linspace(0, 1.2, 4 * 3 * 3).reshape(4, 3, 3)
    path = str(tmp_path / "x.png")
    tflm.save_png(img, path)
    got = np.asarray(Image.open(path))
    np.testing.assert_array_equal(got, tflm.to_srgb_u8(img))
    np.testing.assert_array_equal(
        got, jflm.to_srgb_u8(jnp.asarray(img.numpy())))
