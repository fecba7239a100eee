"""The port's render of an instanced scene against the JAX package's:
tests/test_instancing.py's three instanced quads under a point light,
24x24, 4 spp, depth 2, through the port's fused bounce on the CPU (the
plain versions of K1 with the [I * N]-lane instanced launch, K2 and K3)
and through arendur_tpu.render.integrator.render on its default CPU
path, within the JAX package's own gate between its fused and XLA
renders of this scene (atol 2e-3, tests/test_instancing.py
TestInstancedMegaPath)."""

import numpy as np
import torch

from arendur_tpu import materials as jmats
from arendur_tpu import scene as jsc
from arendur_tpu.filming import camera as jcam
from arendur_tpu.filming import film as jflm
from arendur_tpu.geometry import transform as jtf
from arendur_tpu.render import integrator as jint
from arendur_tpu.sampling import filters as jfilt
from arendur_tpu_torch import convert
from arendur_tpu_torch.render import integrator as tint

torch.set_num_threads(2)

RES, SPP = 24, 4
PIXEL_ATOL = 2e-3


def _translate(x, y, z):
    m = np.eye(4, dtype=np.float32)
    m[3, :3] = (x, y, z)
    return m


def test_instanced_render_matches_jax():
    b = jsc.SceneBuilder()
    m = b.add_material(mtype=jmats.M_MATTE, kd=(0.7, 0.4, 0.3), sigma=0.0)
    v = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]],
                 np.float32)
    f = np.array([[0, 1, 2], [0, 2, 3]], np.int64)
    b.add_instanced_mesh([dict(vertices=v, faces=f, mat_id=m)],
                         [_translate(-1.6, 0.0, 0.0),
                          _translate(1.6, 0.0, -1.0),
                          _translate(0.0, 1.6, -2.0)])
    b.add_point_light((0, 0, 5.0), (30.0, 30.0, 30.0))
    js = b.build()
    camera = jcam.make_perspective(
        parent_view=np.asarray(jtf.look_at([0, 0, 6.0], [0, 0, 0.0],
                                           [0, 1, 0.0])),
        screen_min=(-1, -1), screen_max=(1, 1), znear=0.1, zfar=100.0,
        fov=1.2, lens=None, resolution=(RES, RES))
    film = jflm.FilmConfig(resolution=(RES, RES),
                           filter=jfilt.FilterSpec("box", (0.5, 0.5)))
    jcfg = jint.RenderConfig(max_depth=2, spp=SPP, sample_dx=2, sample_dy=2,
                             wave_size=RES * RES * SPP)
    ref = np.asarray(jint.render(js, camera, film, jcfg))

    ds = convert.scene_from_numpy(js, "cpu")
    assert ds.n_tris == 0 and len(ds.inst) == 1 and not ds.composed_only
    tcfg = tint.RenderConfig(max_depth=2, spp=SPP, sample_dx=2, sample_dy=2,
                             wave_size=RES * RES * SPP)
    img = tint.render(ds, convert.camera_from_numpy(camera),
                      convert.film_from_numpy(film), tcfg).numpy()
    assert ref.max() > 0.01 and np.isfinite(img).all()
    np.testing.assert_allclose(img, ref, rtol=0.0, atol=PIXEL_ATOL)
