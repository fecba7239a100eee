"""The slice as a whole: the port's render of the Cornell box on the
CPU (the plain versions of the three kernels) against
arendur_tpu.render.integrator.render on its default CPU path, same
scene, same seed.  Plus the CLI surface."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from arendur_tpu.io import scenedesc as jsd
from arendur_tpu.render import integrator as jint
from arendur_tpu_torch import cli
from arendur_tpu_torch import convert
from arendur_tpu_torch import scene as tsc
from arendur_tpu_torch.io import scenedesc as tsd
from arendur_tpu_torch.render import integrator as tint

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CB = os.path.join(REPO, "examples/cornellbox/cb.json")
RES, SPP, DEPTH = (32, 24), 4, 3
# per pixel: the JAX package's own gate between its fused and composed
# paths (tests/test_cbounce.py); image mean: 1e-3
PIXEL_ATOL = 3e-3
MEAN_ATOL = 1e-3


@pytest.fixture(scope="module")
def jax_image():
    js, jcam, jfilm, jcfg, _ = jsd.parse_scene(
        CB, spp_override=SPP, resolution_override=RES)
    jcfg = dataclasses.replace(jcfg, max_depth=DEPTH)
    img = np.asarray(jint.render(js, jcam, jfilm, jcfg))
    return img, (js, jcam, jfilm, jcfg)


def _port_render(config_changes=None):
    ts, tcam, tfilm, tcfg, _ = tsd.parse_scene(
        CB, spp_override=SPP, resolution_override=RES)
    tcfg = dataclasses.replace(tcfg, max_depth=DEPTH,
                               **(config_changes or {}))
    ds = tsc.DeviceScene.build(ts, "cpu")
    return tint.render(ds, tcam, tfilm, tcfg).numpy()


def test_render_matches_jax(jax_image):
    ref, _ = jax_image
    img = _port_render()
    assert img.shape == (RES[1], RES[0], 3)
    assert np.isfinite(img).all() and ref.max() > 0.05
    np.testing.assert_allclose(img, ref, rtol=0.0, atol=PIXEL_ATOL)
    assert abs(img.mean() - ref.mean()) <= MEAN_ATOL


def test_render_from_converted_jax_scene(jax_image):
    """scene_from_numpy: the JAX package's own scene objects, rendered
    by the port, give the same image."""
    ref, (js, jcam, jfilm, jcfg) = jax_image
    ds = convert.scene_from_numpy(js, "cpu")
    cfg = tint.RenderConfig(max_depth=jcfg.max_depth, spp=jcfg.spp,
                            sample_dx=jcfg.sample_dx,
                            sample_dy=jcfg.sample_dy, seed=jcfg.seed,
                            wave_size=jcfg.wave_size)
    img = tint.render(ds, convert.camera_from_numpy(jcam),
                      convert.film_from_numpy(jfilm), cfg).numpy()
    np.testing.assert_allclose(img, ref, rtol=0.0, atol=PIXEL_ATOL)


@pytest.mark.parametrize("changes", [{"compact": False},
                                     {"wave_size": 1000}])
def test_compaction_and_scatter_splat_agree(jax_image, changes):
    """Dead-lane compaction only reorders lanes, and the scatter splat
    (waves that do not tile the frame) matches the dense one."""
    ref, _ = jax_image
    img = _port_render(changes)
    np.testing.assert_allclose(img, ref, rtol=0.0, atol=PIXEL_ATOL)


def test_cli_renders_png(tmp_path):
    out = str(tmp_path / "cb.png")
    rc = cli.main([CB, "--device", "cpu", "--res", "16x12", "--spp", "1",
                   "--depth", "2", "-o", out])
    assert rc == 0
    from PIL import Image
    assert Image.open(out).size == (16, 12)


@pytest.mark.parametrize("flags", [["--intersector", "naive"],
                                   ["--bvh"],
                                   ["--intersector", "bvh"],
                                   ["--resume"]])
def test_cli_unported_paths_exit_with_error(flags, tmp_path, capsys):
    """The CLI's paths that once refused (the name is theirs) now render:
    the brute-force and BVH intersectors and checkpoint / resume each
    write an image and exit 0 (tests/test_torch_intersectors_render.py
    and tests/test_torch_checkpoint.py hold them against the JAX
    package)."""
    out = str(tmp_path / "cb.png")
    assert cli.main([CB, "--device", "cpu", "--res", "8x6", "--spp", "1",
                     "--depth", "2", "-o", out] + flags) == 0
    from PIL import Image
    assert Image.open(out).size == (8, 6)
    assert "not yet ported" not in capsys.readouterr().err
    assert os.path.exists(out + ".ckpt.npz") == (flags == ["--resume"])
