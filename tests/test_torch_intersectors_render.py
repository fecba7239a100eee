"""The port's renders with the world triangles met by the BVH walk and by
the brute-force test (``--intersector bvh`` / ``naive``): cb.json at
16x12, 2 spp, depth 3 through the port's plain path against the JAX
package's render with the same intersector (tests/torch_oracles.py
``cb_bvh`` / ``cb_naive``), and against the port's cluster render; the
scene queries of the three intersectors on the same rays; the BPT and
Whitted renderers with ``--intersector bvh`` through the CLI.

Tolerances: PIXEL_ATOL per pixel, the JAX package's own gate between
its fused and composed paths (measured: 6.0e-7 against JAX for both
intersectors); the three intersectors' queries agree in hit / miss and
occluded on every lane, in the primitive on at least 0.999 of lanes,
and in t within T_RTOL relative plus T_ATOL (the cluster kernels take t
from a determinant product, not the watertight shear: measured 7.7e-7
absolute)."""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from arendur_tpu_torch import cli
from arendur_tpu_torch import scene as tsc
from arendur_tpu_torch.io import scenedesc as tsd
from arendur_tpu_torch.render import integrator as tint

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_oracles as orc  # noqa: E402

torch.set_num_threads(2)

PIXEL_ATOL = 3e-3
T_RTOL, T_ATOL = 1e-5, 1e-6


def _scene(intersector, res=orc.RENDER_RES, spp=orc.RENDER_SPP):
    ts, tcam, tfilm, tcfg, _ = tsd.parse_scene(
        orc.CB, spp_override=spp, resolution_override=res,
        intersector=intersector)
    tcfg = dataclasses.replace(tcfg, max_depth=orc.RENDER_DEPTH)
    return tsc.DeviceScene.build(ts, "cpu"), tcam, tfilm, tcfg


@pytest.fixture(scope="module")
def cluster_image():
    return tint.render(*_scene("cluster")).numpy()


@pytest.mark.parametrize("intersector", ["bvh", "naive"])
def test_render_matches_jax(intersector, cluster_image):
    ds, tcam, tfilm, tcfg = _scene(intersector)
    assert ds.intersector == intersector and ds.composed_only
    assert ds.cw.shape[0] == 0
    img = tint.render(ds, tcam, tfilm, tcfg).numpy()
    ref = orc.load("cb_" + intersector,
                   orc.render_inputs(intersector))["img"]
    assert np.isfinite(img).all() and ref.max() > 0.05
    np.testing.assert_allclose(img, ref, rtol=0.0, atol=PIXEL_ATOL)
    # the same scene through the cluster tables (and the fused bounce)
    np.testing.assert_allclose(img, cluster_image, rtol=0.0,
                               atol=PIXEL_ATOL)


def test_queries_agree_across_intersectors():
    """scene.intersect / occluded on 768 random rays inside the box: the
    BVH walk, the brute force and the cluster kernels' plain versions
    find the same closest hit, and the same occluders."""
    rng = np.random.default_rng(3)
    n = 768
    o = torch.tensor(rng.uniform([-1.9, -1.4, 2.1], [1.9, 2.4, 5.9],
                                 (n, 3)), dtype=torch.float32)
    d = torch.tensor(rng.normal(size=(n, 3)), dtype=torch.float32)
    d = d / d.norm(dim=-1, keepdim=True)
    tmax = torch.tensor(rng.uniform(0.5, 3.0, n), dtype=torch.float32)
    hits, blocked = {}, {}
    for isec in ("cluster", "bvh", "naive"):
        ds = _scene(isec)[0]
        hits[isec] = tsc.intersect(ds, o, d)
        blocked[isec] = tsc.occluded(ds, o, d, tmax)
    ref = hits["cluster"]
    assert ref.hit.float().mean() > 0.3   # the box is open to the camera
    for isec in ("bvh", "naive"):
        h = hits[isec]
        assert torch.equal(h.hit, ref.hit)
        assert torch.equal(blocked[isec], blocked["cluster"])
        np.testing.assert_allclose(h.t[h.hit].numpy(), ref.t[ref.hit].numpy(),
                                   rtol=T_RTOL, atol=T_ATOL)
        same = (h.prim == ref.prim).float().mean().item()
        assert same >= 0.999, same
        for f in ("pos", "ng", "uv"):
            np.testing.assert_allclose(getattr(h, f).numpy(),
                                       getattr(ref, f).numpy(), atol=1e-4)


@pytest.mark.parametrize("renderer", ["bpt", "whitted"])
def test_cli_renderers_with_bvh(renderer, tmp_path, capsys):
    out = str(tmp_path / f"{renderer}.png")
    rc = cli.main([orc.CB, "--device", "cpu", "--renderer", renderer,
                   "--intersector", "bvh", "--res", "8x6", "--spp", "2",
                   "--depth", "2", "-o", out])
    assert rc == 0
    assert "intersector=bvh" in capsys.readouterr().out
    from PIL import Image
    assert Image.open(out).size == (8, 6)
