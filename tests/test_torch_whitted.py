"""The port's Whitted renderer (arendur_tpu_torch/render/whitted.py, the
plain versions of K1, K2 and K9 on the CPU) against the JAX package's
(render/whitted.py, rendered by its CLI's _render_whitted) at 16x12,
4 spp: on cb.json (two sphere lights) and on cb_etex.json (their
emission through textures, which Whitted reads at the camera hit only:
the light samples carry no texture, as in the reference).

Gates: one wave's radiance per lane within L_RTOL / L_ATOL (measured:
2.4e-7 on cb.json, 2.2e-8 on cb_etex.json), the image per pixel within
PIXEL_ATOL (the port's path-tracer gate, tests/test_torch_render.py;
measured: 2.4e-7 and 2.4e-8), and the CLI's image equal to
render_whitted's."""

import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from arendur_tpu import cli as jcli
from arendur_tpu.io import scenedesc as jsd
from arendur_tpu.render import whitted as jwhitted
from arendur_tpu.sampling import sampler as jsmp
from arendur_tpu_torch import scene as tsc
from arendur_tpu_torch.io import scenedesc as tsd
from arendur_tpu_torch.render import whitted as twhitted
from arendur_tpu_torch.sampling import sampler as tsmp

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = {"cb": os.path.join(REPO, "examples/cornellbox/cb.json"),
          "cb_etex": os.path.join(REPO, "examples/cornellbox/cb_etex.json")}
RES, SPP = (16, 12), 4
PIXEL_ATOL = 3e-3
L_RTOL, L_ATOL = 1e-4, 1e-5


def _load(name):
    j = jsd.parse_scene(SCENES[name], spp_override=SPP,
                        resolution_override=RES)
    t = tsd.parse_scene(SCENES[name], spp_override=SPP,
                        resolution_override=RES)
    return j, t


@pytest.mark.parametrize("name", ["cb", "cb_etex"])
def test_whitted_wave_matches_jax(name):
    (js, jc, _, jcfg, _), (ts, tc, _, tcfg, _) = _load(name)
    n = RES[0] * RES[1] * SPP
    ri = np.arange(n, dtype=np.int32)
    pid, sid = ri // SPP, ri % SPP
    pxy = np.stack([pid % RES[0], pid // RES[0]], -1).astype(np.float32)
    pf_j, l_j = jwhitted.whitted_wave(js, jc, jcfg, jnp.asarray(pxy),
                                      jnp.asarray(pid), jnp.asarray(sid),
                                      jsmp.make_base_key(0))
    ds = tsc.DeviceScene.build(ts, "cpu")
    pf_t, l_t = twhitted.whitted_wave(ds, tc, tcfg, torch.tensor(pxy),
                                      torch.tensor(pid).long(),
                                      torch.tensor(sid).long(),
                                      tsmp.make_base_key(0))
    l_j, l_t = np.asarray(l_j), l_t.numpy()
    print(f"{name} wave: max |dL| {np.abs(l_t - l_j).max():.3e}, max L "
          f"{l_j.max():.3e}")
    np.testing.assert_array_equal(pf_t.numpy(), np.asarray(pf_j))
    np.testing.assert_allclose(l_t, l_j, rtol=L_RTOL, atol=L_ATOL)
    assert l_j.max() > 0.1


@pytest.mark.parametrize("name", ["cb", "cb_etex"])
def test_render_and_cli_match_jax(name, tmp_path):
    (js, jc, jf, jcfg, _), (ts, tc, tf_, tcfg, _) = _load(name)
    ref = np.asarray(jcli._render_whitted(js, jc, jf, jcfg))
    img = twhitted.render_whitted(tsc.DeviceScene.build(ts, "cpu"), tc, tf_,
                                  tcfg).numpy()
    print(f"{name} image: max |port - JAX| {np.abs(img - ref).max():.3e}, "
          f"mean {ref.mean():.3e}")
    assert img.shape == (RES[1], RES[0], 3) and ref.max() > 0.05
    np.testing.assert_allclose(img, ref, rtol=0.0, atol=PIXEL_ATOL)
    # the CLI writes the same image (8-bit)
    from arendur_tpu_torch import cli
    from arendur_tpu_torch.filming import film as tflm
    from PIL import Image
    out = str(tmp_path / "w.png")
    assert cli.main([SCENES[name], "--device", "cpu", "--renderer",
                     "whitted", "--res", "16x12", "--spp", str(SPP), "-o",
                     out]) == 0
    np.testing.assert_array_equal(np.asarray(Image.open(out)),
                                  tflm.to_srgb_u8(img))
