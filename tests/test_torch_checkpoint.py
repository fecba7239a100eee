"""Checkpoint / resume of the port's render (arendur_tpu_torch/utils.py,
render(checkpoint_path=, checkpoint_every=)) to the letter of the JAX
package's (arendur_tpu/utils.py, render/integrator.py:606-688): a
render resumed after 2 of 4 waves equals the uninterrupted one to the
bit; the .npz files of both packages have one layout and each reads
the other's; a checkpoint of another seed, wave size or film shape is
ignored; the CLI's --resume writes and reads <output>.ckpt.npz.

Tolerance: none, the images are compared bit for bit."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from arendur_tpu import utils as jutils
from arendur_tpu.filming import film as jflm
from arendur_tpu_torch import cli
from arendur_tpu_torch import scene as tsc
from arendur_tpu_torch import utils as tutils
from arendur_tpu_torch.io import scenedesc as tsd
from arendur_tpu_torch.render import integrator as tint

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CB = os.path.join(REPO, "examples/cornellbox/cb.json")
RES, SPP, DEPTH = (16, 12), 4, 2
WAVE = RES[0] * RES[1] * SPP // 4          # four pixel-major waves


@pytest.fixture(scope="module")
def setup():
    ts, tcam, tfilm, tcfg, _ = tsd.parse_scene(
        CB, spp_override=SPP, resolution_override=RES)
    tcfg = dataclasses.replace(tcfg, max_depth=DEPTH, wave_size=WAVE)
    ds = tsc.DeviceScene.build(ts, "cpu")
    ref = tint.render(ds, tcam, tfilm, tcfg)
    return (ds, tcam, tfilm, tcfg), ref


def _first_waves(args, k):
    ds, tcam, tfilm, tcfg = args
    state, wave, n_waves = tint.render_film_init(ds, tfilm, tcfg)
    assert (wave, n_waves) == (WAVE, 4) and state.padded
    for i in range(k):
        tint.render_wave(ds, tcam, tfilm, tcfg, state, i)
    return state


def test_resume_is_bit_identical(setup, tmp_path):
    args, ref = setup
    ckpt = str(tmp_path / "render.ckpt.npz")
    tutils.save_checkpoint(ckpt, _first_waves(args, 2), 2 * WAVE,
                           args[3].seed, meta={"wave": WAVE})
    resumed = tint.render(*args, checkpoint_path=ckpt, checkpoint_every=1)
    assert torch.equal(resumed, ref)
    st, next_ray, seed, meta = tutils.load_checkpoint(ckpt)
    assert next_ray == 4 * WAVE and seed == args[3].seed
    assert meta == {"wave": WAVE, "padded": True}


def test_checkpoint_layout_matches_jax(setup, tmp_path):
    """The keys, dtypes and meta of the two packages' files agree, and
    each package loads the other's."""
    args, _ = setup
    state = _first_waves(args, 1)
    pt, pj = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    tutils.save_checkpoint(pt, state, WAVE, 7, meta={"wave": WAVE})
    jstate = jflm.FilmState(rgb=state.rgb.numpy(),
                            weight=state.weight.numpy(), padded=True)
    jutils.save_checkpoint(pj, jstate, WAVE, 7, meta={"wave": WAVE})
    a, b = np.load(pt), np.load(pj)
    assert sorted(a.files) == sorted(b.files) == [
        "meta", "next_ray", "rgb", "seed", "weight"]
    for k in a.files:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        if k != "meta":
            np.testing.assert_array_equal(a[k], b[k])
    assert json.loads(str(a["meta"])) == json.loads(str(b["meta"]))
    js, jn, jseed, jmeta = jutils.load_checkpoint(pt)
    np.testing.assert_array_equal(np.asarray(js.rgb), state.rgb.numpy())
    assert (jn, jseed, jmeta, js.padded) == (WAVE, 7, {"wave": WAVE,
                                                       "padded": True}, True)
    ts_, tn, tseed, tmeta = tutils.load_checkpoint(pj)
    assert torch.equal(ts_.weight, state.weight) and ts_.padded
    assert (tn, tseed, tmeta) == (WAVE, 7, {"wave": WAVE, "padded": True})


@pytest.mark.parametrize("other", ["seed", "wave", "shape"])
def test_mismatched_checkpoint_is_ignored(setup, tmp_path, other):
    """A checkpoint whose seed, wave size or film shape differs from the
    render's is not resumed from (a film of ones would show)."""
    args, ref = setup
    state = _first_waves(args, 0)
    state.rgb.fill_(1.0)
    state.weight.fill_(1.0)
    if other == "shape":
        state.rgb = state.rgb[:-1]
    ckpt = str(tmp_path / "other.ckpt.npz")
    tutils.save_checkpoint(ckpt, state, 4 * WAVE,
                           args[3].seed + (other == "seed"),
                           meta={"wave": WAVE + (other == "wave")})
    img = tint.render(*args, checkpoint_path=ckpt)
    assert torch.equal(img, ref)


def test_cli_resume_writes_and_reads(tmp_path):
    out = str(tmp_path / "cb.png")
    argv = [CB, "--device", "cpu", "--res", "16x12", "--spp", "2",
            "--depth", "2", "--wave", "96", "--resume",
            "--checkpoint-every", "1", "-o", out]
    assert cli.main(argv) == 0
    ckpt = out + ".ckpt.npz"
    st, next_ray, seed, meta = tutils.load_checkpoint(ckpt)
    assert next_ray == 16 * 12 * 2 and seed == 0 and meta["wave"] == 96
    # a finished checkpoint whose film is all ones: the CLI renders no
    # wave and finalizes it (white)
    st.rgb.fill_(1.0)
    st.weight.fill_(1.0)
    tutils.save_checkpoint(ckpt, st, next_ray, seed, meta=meta)
    assert cli.main(argv) == 0
    from PIL import Image
    assert (np.asarray(Image.open(out)) == 255).all()
