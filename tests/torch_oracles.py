"""JAX oracles of the port's tests whose JAX side takes longer to compile
than a test file's budget: the scenes, the JAX computations, and the
stored results (tests/data/torch_oracles/<name>.npz, written by
tools/make_torch_oracles.py; each file also records the inputs it was
made from, which the tests check).

* ``cb_<intersector>``: cb.json at 16x12, 2 spp, depth 3 rendered by
  arendur_tpu.render.integrator.render with ``--intersector bvh`` /
  ``naive`` (tests/test_torch_intersectors_render.py);
* ``sobol_plane``: tests/test_sobol.py's Sobol render of the plane
  scene (8x8, 16 spp, depth 1, a build_sobol_table(16, 80));
* ``train_<scene>``: one sharded_train_step_fn step on a one-device CPU
  mesh (16x12, 2 spp, depth 2, kd / ks / roughness, lr 1e3) of
  cb_etex.json and of cb.json with the BVH intersector: the loss and
  the parameter gradients (tests/test_torch_train_composed.py);
* ``texel_grad``: jax.grad of the mean squared finalized film with
  respect to the atlas texels on tests/test_cbounce.py's textured quad
  (the XLA composition, that test's reference);
* ``inst_etex``: a textured scene with an emission-textured sphere light
  and an instanced glass mesh (the composed bounce on instanced hits),
  rendered at 16x12, 4 spp, depth 4 (tests/test_torch_inst_curvature.py);
* ``inst_etex_lanes``: the radiance of each lane of inst_etex's one wave,
  traced by the JAX package op by op and jitted (the two differ on a
  lane, and the render is the jitted one), and the op-by-op trace's hit
  primitive and cone spread at each bounce, by original lane;
* ``par_render_<scene>``: arendur_tpu.parallel.mesh.render_sharded on a
  2-device CPU mesh and the single-process integrator.render of the same
  frame, for tests/test_parallel.py's tiny scene (8x8, 8 spp, depth 2:
  parallel/distributed.py _tiny_setup) and cb.json (32x24, 4 spp, depth
  3) (tests/test_torch_parallel.py);
* ``big_lights``: cb.json with BIG_LIGHTS small sphere lights over
  BIG_MATERIALS new matte materials (tools/make_cb_big_tables.py
  lights_desc, seed 0), past the tables K3, K4 and K6 stage whole,
  rendered at 16x12, 2 spp, depth 3 (tests/test_torch_big_tables.py);
* ``par_train_<scene>``: one sharded_train_step_fn step on a 2-device
  CPU mesh, the loss and the parameter gradients read back from the new
  parameters: the tiny scene (8x8, 4 spp, depth 1, a bare kd, lr 1,
  target 0) and cb.json (32x24, 4 spp, depth 3, kd / ks / roughness,
  lr 1e3, target uniform(0, 0.5) seed 0);
* ``area_<what>``: the JAX package with area-uniform sphere-light
  sampling (ARENDUR_SPHERE_THETA=area, read at its import, so these are
  made in a process of their own): the render of cb.json and the
  composed render of cb_etex.json (16x12, 2 spp, depth 3), BPT on
  cb.json (AREA_BPT), Whitted on cb.json (16x12, 2 spp) and one
  train step on cb.json (as ``train_<scene>``)
  (tests/test_torch_sphere_area.py).
"""

import dataclasses
import os

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data", "torch_oracles")
CB = os.path.join(REPO, "examples/cornellbox/cb.json")
CB_ETEX = os.path.join(REPO, "examples/cornellbox/cb_etex.json")

RENDER_RES, RENDER_SPP, RENDER_DEPTH = (16, 12), 2, 3
BIG_LIGHTS, BIG_MATERIALS = 1200, 48
TRAIN_RES, TRAIN_SPP, TRAIN_DEPTH, TRAIN_LR = (16, 12), 2, 2, 1e3
TRAIN_SCENES = {"cb_etex": (CB_ETEX, "cluster"), "cb_bvh": (CB, "bvh")}
SOBOL_SPP, SOBOL_DIMS = 16, 80
INST_RES, INST_SPP, INST_DEPTH = (16, 12), 4, 4
PARAM_KEYS = ("kd", "ks", "roughness")
# the area-mode oracles: the renders' scenes, and BPT's frame
AREA_RENDERS = {"area_render": CB, "area_etex": CB_ETEX}
AREA_BPT = dict(res=(8, 6), spp=4, depth=2)
# the sharded oracles: a 2-device mesh; per scene the render's and the
# train step's resolution, spp, stratification grid and depth
PAR_DEVICES = 2
PAR_RENDER = {"tiny": dict(res=(8, 8), spp=8, grid=(4, 2), depth=2),
              "cb": dict(res=(32, 24), spp=4, grid=(2, 2), depth=3)}
PAR_TRAIN = {"tiny": dict(res=(8, 8), spp=4, grid=(2, 2), depth=1, lr=1.0,
                          target="zeros", keys=("kd",)),
             "cb": dict(res=(32, 24), spp=4, grid=(2, 2), depth=3, lr=1e3,
                        target="uniform(0, 0.5) seed 0", keys=PARAM_KEYS)}


def path(name):
    return os.path.join(DATA, name + ".npz")


def save(name, inputs: dict, **arrays):
    os.makedirs(DATA, exist_ok=True)
    np.savez_compressed(path(name), inputs=np.asarray(repr(inputs)),
                        **arrays)


def load(name, inputs: dict):
    """The stored oracle; fails where it was made from other inputs."""
    data = np.load(path(name), allow_pickle=False)
    got = str(data["inputs"])
    if got != repr(inputs):
        raise AssertionError(f"{name}: oracle made from {got}, the test "
                             f"asks {inputs!r}; rerun "
                             "tools/make_torch_oracles.py")
    return {k: data[k] for k in data.files if k != "inputs"}


# ---------------------------------------------------------------------------
# inputs: what each oracle is made from
# ---------------------------------------------------------------------------

def render_inputs(intersector):
    return dict(scene="cb.json", intersector=intersector, res=RENDER_RES,
                spp=RENDER_SPP, depth=RENDER_DEPTH, seed=0)


def sobol_inputs():
    return dict(scene="test_sobol plane", res=(8, 8), spp=SOBOL_SPP,
                dims=SOBOL_DIMS, depth=1)


def train_inputs(name):
    scene, isec = TRAIN_SCENES[name]
    return dict(scene=os.path.basename(scene), intersector=isec,
                res=TRAIN_RES, spp=TRAIN_SPP, depth=TRAIN_DEPTH, lr=TRAIN_LR,
                target="uniform(0, 0.5) seed 0", keys=PARAM_KEYS)


def texel_inputs():
    return dict(scene="test_cbounce textured quad", res=(16, 16), spp=4,
                depth=2, loss="mean(img ** 2)")


def inst_inputs():
    return dict(scene="inst_etex_scene", res=INST_RES, spp=INST_SPP,
                depth=INST_DEPTH, seed=0)


def big_inputs():
    return dict(scene="make_cb_big_tables lights_desc", spheres=BIG_LIGHTS,
                materials=BIG_MATERIALS, res=RENDER_RES, spp=RENDER_SPP,
                depth=RENDER_DEPTH, seed=0)


def area_inputs(name):
    if name == "area_bpt":
        return dict(scene="cb.json", renderer="bpt", theta="area", seed=0,
                    **AREA_BPT)
    if name == "area_train":
        return dict(train_inputs("cb_etex"), scene="cb.json",
                    intersector="cluster", theta="area")
    scene = os.path.basename(AREA_RENDERS.get(name, CB))
    renderer = "whitted" if name == "area_whitted" else "pt"
    return dict(scene=scene, renderer=renderer, theta="area",
                res=RENDER_RES, spp=RENDER_SPP,
                depth=None if renderer == "whitted" else RENDER_DEPTH, seed=0)


def big_lights_scene(directory):
    """The big_lights scene file, written into `directory`."""
    import sys
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import make_cb_big_tables as mbt
    return mbt.write(os.path.join(directory, "big_lights.json"),
                     mbt.lights_desc(BIG_LIGHTS, BIG_MATERIALS))


def train_target(res=TRAIN_RES, kind="uniform(0, 0.5) seed 0"):
    w, h = res
    if kind == "zeros":
        return np.zeros((w * h, 3), np.float32)
    return np.random.default_rng(0).uniform(
        0.0, 0.5, (w * h, 3)).astype(np.float32)


def par_render_inputs(name):
    return dict(scene=name, devices=PAR_DEVICES, seed=0, **PAR_RENDER[name])


def par_train_inputs(name):
    return dict(scene=name, devices=PAR_DEVICES, **PAR_TRAIN[name])


def par_setup(name, what, sc_mod, parse_scene, tiny_setup):
    """(scene, camera, film_cfg, config) of a sharded oracle for either
    package: `what` "render" or "train" picks PAR_RENDER / PAR_TRAIN;
    sc_mod, parse_scene and tiny_setup are that package's scene module,
    io.scenedesc.parse_scene and parallel.distributed._tiny_setup (the
    tiny scene of tests/test_parallel.py with its camera and film).  One
    wave holds the whole frame."""
    p = (PAR_RENDER if what == "render" else PAR_TRAIN)[name]
    w, h = p["res"]
    if name == "tiny":
        scene, camera, film_cfg, config = tiny_setup()
    else:
        scene, camera, film_cfg, config, _ = parse_scene(
            CB, spp_override=p["spp"], resolution_override=p["res"])
    config = dataclasses.replace(
        config, max_depth=p["depth"], spp=p["spp"], sample_dx=p["grid"][0],
        sample_dy=p["grid"][1], wave_size=w * h * p["spp"])
    return scene, camera, film_cfg, config


# ---------------------------------------------------------------------------
# scenes, built with the JAX package's builders (NumPy, no compile); the
# port takes them through arendur_tpu_torch.convert
# ---------------------------------------------------------------------------

def textured_quad_scene():
    """tests/test_cbounce.py's _textured_quad_scene: a camera staring at
    a kd-textured quad, a point light and a matte sphere.  Returns the
    JAX (scene, camera, film_cfg, config, textures)."""
    from arendur_tpu import materials as mats
    from arendur_tpu import scene as sc_
    from arendur_tpu.filming import camera as cam
    from arendur_tpu.filming import film as flm
    from arendur_tpu.geometry import transform as tf
    from arendur_tpu.render import integrator as integ
    from arendur_tpu.sampling import filters as filt
    rng = np.random.RandomState(0)
    img = rng.uniform(0.2, 0.9, (8, 8, 3)).astype(np.float32)
    b = sc_.SceneBuilder()
    tex_id = b.atlas.add_image(img, wrap=2, gamma=False)
    m = b.add_material(mtype=mats.M_MATTE, kd=(1.0, 1.0, 1.0), sigma=0.0,
                       kd_tex=tex_id)
    ms = b.add_material(mtype=mats.M_MATTE, kd=(0.6, 0.5, 0.4), sigma=0.0)
    v = np.array([[-2, -2, 0], [2, -2, 0], [2, 2, 0], [-2, 2, 0]],
                 np.float32)
    f = np.array([[0, 1, 2], [0, 2, 3]], np.int64)
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    b.add_mesh(v, f, m, uvs=uv)
    b.add_sphere(radius=0.5, zmin=-0.5, zmax=0.5, phimax=2.0 * np.pi,
                 mat_id=ms,
                 transform=np.array([[1, 0, 0, 0], [0, 1, 0, 0],
                                     [0, 0, 1, 0], [0.8, 0.0, 0.7, 1]],
                                    np.float32))
    b.add_point_light((0, 0, 3.0), (20.0, 20.0, 20.0))
    scene = b.build()
    textures = b.build_textures()
    pv = np.asarray(tf.look_at([0, 0, 2.5], [0, 0, 0.0], [0, 1, 0.0]))
    camera = cam.make_perspective(
        parent_view=pv, screen_min=(-1, -1), screen_max=(1, 1),
        znear=0.1, zfar=100.0, fov=1.2, lens=None, resolution=(16, 16))
    film_cfg = flm.FilmConfig(
        resolution=(16, 16), filter=filt.FilterSpec("box", (0.5, 0.5)))
    config = integ.RenderConfig(max_depth=2, spp=4, sample_dx=2,
                                sample_dy=2, wave_size=16 * 16 * 4,
                                rr_threshold=0.0, textures=textures)
    return scene, camera, film_cfg, config, textures


def _box(lo, hi):
    """An axis-aligned box's 8 corners and 12 outward triangles."""
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    v = np.array([[x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0],
                  [x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1]],
                 np.float32)
    f = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7],
                  [0, 1, 5], [0, 5, 4], [1, 2, 6], [1, 6, 5],
                  [2, 3, 7], [2, 7, 6], [3, 0, 4], [3, 4, 7]], np.int64)
    return v, f


def inst_etex_scene():
    """A textured floor and back wall (bench.py's checkerboard pattern,
    64 texels, as kd),
    a sphere light whose emission is textured (so the composed bounce
    serves the scene), a small glass sphere, and a glass box placed
    three times by one instanced mesh: specular bounces off instanced
    triangles, whose cone spread the JAX package grows as if they were
    spheres.  Returns the JAX (scene, camera, film_cfg, config)."""
    from arendur_tpu import materials as mats
    from arendur_tpu import scene as sc_
    from arendur_tpu.filming import camera as cam
    from arendur_tpu.filming import film as flm
    from arendur_tpu.geometry import transform as tf
    from arendur_tpu.render import integrator as integ
    from arendur_tpu.sampling import filters as filt
    from arendur_tpu_torch.render.fuzz import checker_image
    w, h = INST_RES
    b = sc_.SceneBuilder()
    chk = b.atlas.add_image(checker_image(64, 8), wrap=0, gamma=False)
    etex = b.atlas.add_image(np.random.RandomState(1).uniform(
        0.3, 1.0, (4, 8, 3)).astype(np.float32), wrap=0, gamma=False)
    floor = b.add_material(mtype=mats.M_MATTE, kd=(1.0, 1.0, 1.0),
                           sigma=0.0, kd_tex=chk)
    glass = b.add_material(mtype=mats.M_GLASS, kd=(1.0, 1.0, 1.0),
                           ks=(1.0, 1.0, 1.0), eta=1.5, roughness=0.0)
    lmat = b.add_material(mtype=mats.M_MATTE, kd=(0.0, 0.0, 0.0))
    quad_f = np.array([[0, 1, 2], [0, 2, 3]], np.int64)
    uv = np.array([[0, 0], [4, 0], [4, 4], [0, 4]], np.float32)
    b.add_mesh(np.array([[-4, -4, 0], [4, -4, 0], [4, 4, 0], [-4, 4, 0]],
                        np.float32), quad_f, floor, uvs=uv)
    b.add_mesh(np.array([[-4, 4, 0], [4, 4, 0], [4, 4, 5], [-4, 4, 5]],
                        np.float32), quad_f, floor, uvs=uv)
    b.add_sphere(radius=0.6, zmin=-0.6, zmax=0.6, phimax=2.0 * np.pi,
                 mat_id=lmat, emission=(6.0, 6.0, 6.0), emission_tex=etex,
                 emission_tex_mean=0.65,
                 transform=np.array([[1, 0, 0, 0], [0, 1, 0, 0],
                                     [0, 0, 1, 0], [0.0, 0.5, 3.6, 1]],
                                    np.float32))
    b.add_sphere(radius=0.4, zmin=-0.4, zmax=0.4, phimax=2.0 * np.pi,
                 mat_id=glass,
                 transform=np.array([[1, 0, 0, 0], [0, 1, 0, 0],
                                     [0, 0, 1, 0], [1.6, -0.6, 0.4, 1]],
                                    np.float32))
    v, f = _box((-0.5, -0.5, 0.0), (0.5, 0.5, 1.0))
    shift = lambda x, y, s: np.array(  # noqa: E731
        [[s, 0, 0, 0], [0, s, 0, 0], [0, 0, s, 0], [x, y, 0, 1]],
        np.float32)
    b.add_instanced_mesh([dict(vertices=v, faces=f, mat_id=glass)],
                         [shift(-1.5, 0.0, 1.0), shift(0.0, -0.8, 0.8),
                          shift(0.9, 1.0, 1.2)])
    scene = b.build()
    textures = b.build_textures()
    pv = np.asarray(tf.look_at([0, -6.0, 2.5], [0, 0, 0.8], [0, 0, 1.0]))
    camera = cam.make_perspective(
        parent_view=pv, screen_min=(-1, -0.75), screen_max=(1, 0.75),
        znear=0.1, zfar=100.0, fov=0.9, lens=None, resolution=(w, h))
    film_cfg = flm.FilmConfig(resolution=(w, h),
                              filter=filt.FilterSpec("box", (0.5, 0.5)))
    config = integ.RenderConfig(max_depth=INST_DEPTH, spp=INST_SPP,
                                sample_dx=2, sample_dy=2,
                                wave_size=w * h * INST_SPP, textures=textures)
    return scene, camera, film_cfg, config


# ---------------------------------------------------------------------------
# the JAX computations (run by tools/make_torch_oracles.py)
# ---------------------------------------------------------------------------

def jax_intersector_render(intersector):
    from arendur_tpu.io import scenedesc as jsd
    from arendur_tpu.render import integrator as jint
    js, jcam, jfilm, jcfg, _ = jsd.parse_scene(
        CB, spp_override=RENDER_SPP, resolution_override=RENDER_RES,
        intersector=intersector)
    jcfg = dataclasses.replace(jcfg, max_depth=RENDER_DEPTH)
    return dict(img=np.asarray(jint.render(js, jcam, jfilm, jcfg)))


def jax_big_lights():
    import tempfile
    from arendur_tpu.io import scenedesc as jsd
    from arendur_tpu.render import integrator as jint
    with tempfile.TemporaryDirectory() as tmp:
        js, jcam, jfilm, jcfg, _ = jsd.parse_scene(
            big_lights_scene(tmp), spp_override=RENDER_SPP,
            resolution_override=RENDER_RES)
    jcfg = dataclasses.replace(jcfg, max_depth=RENDER_DEPTH)
    return dict(img=np.asarray(jint.render(js, jcam, jfilm, jcfg)))


def sobol_plane_setup():
    """test_sobol.py's plane scene, camera, film and Sobol config."""
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_integrator import look_down_camera, plane_scene
    from arendur_tpu.filming import film as flm
    from arendur_tpu.render import integrator as integ
    from arendur_tpu.sampling import filters as filt
    from arendur_tpu.sampling import sobol
    film_cfg = flm.FilmConfig(resolution=(8, 8),
                              filter=filt.FilterSpec("box", (0.5, 0.5)))
    config = integ.RenderConfig(
        max_depth=1, spp=SOBOL_SPP, sample_dx=4, sample_dy=4,
        wave_size=8 * 8 * SOBOL_SPP, sampler="sobol",
        sobol_table=sobol.build_sobol_table(SOBOL_SPP, SOBOL_DIMS))
    return plane_scene(), look_down_camera(res=8), film_cfg, config


def jax_sobol_plane():
    from arendur_tpu.render import integrator as integ
    scene, camera, film_cfg, config = sobol_plane_setup()
    return dict(img=np.asarray(integ.render(scene, camera, film_cfg,
                                            config)))


def jax_train_step(name):
    return _jax_train(*TRAIN_SCENES[name])


def _jax_train(scene_path, isec):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from arendur_tpu.io import scenedesc as jsd
    from arendur_tpu.parallel import mesh as jmesh
    w, h = TRAIN_RES
    n = w * h * TRAIN_SPP
    js, jcam, jfilm, jcfg, _ = jsd.parse_scene(
        scene_path, spp_override=TRAIN_SPP, resolution_override=TRAIN_RES,
        intersector=isec)
    jcfg = dataclasses.replace(jcfg, max_depth=TRAIN_DEPTH, wave_size=n)
    mesh = Mesh(np.array(jax.devices()[:1]), (jmesh.AXIS,))
    params = {k: np.asarray(getattr(js.materials, k)) for k in PARAM_KEYS}
    step = jmesh.sharded_train_step_fn(js, jcam, jfilm, jcfg, mesh,
                                       lr=TRAIN_LR)
    new, loss = step({k: jnp.asarray(v) for k, v in params.items()},
                     jnp.asarray(train_target()),
                     jnp.arange(n, dtype=jnp.int32))
    return dict(loss=np.asarray(loss),
                **{k: (params[k] - np.asarray(new[k])) / TRAIN_LR
                   for k in PARAM_KEYS})


def _jax_par(name, what):
    import jax
    from jax.sharding import Mesh
    from arendur_tpu import scene as jsc
    from arendur_tpu.io import scenedesc as jsd
    from arendur_tpu.parallel import distributed as jdist
    from arendur_tpu.parallel import mesh as jmesh
    mesh = Mesh(np.array(jax.devices()[:PAR_DEVICES]), (jmesh.AXIS,))
    return par_setup(name, what, jsc, jsd.parse_scene,
                     jdist._tiny_setup), mesh


def jax_par_render(name):
    from arendur_tpu.parallel import mesh as jmesh
    from arendur_tpu.render import integrator as jint
    (scene, camera, film_cfg, config), mesh = _jax_par(name, "render")
    return dict(
        sharded=np.asarray(jmesh.render_sharded(scene, camera, film_cfg,
                                                config, mesh)),
        single=np.asarray(jint.render(scene, camera, film_cfg, config)))


def jax_par_train(name):
    import jax.numpy as jnp
    from arendur_tpu.parallel import mesh as jmesh
    (scene, camera, film_cfg, config), mesh = _jax_par(name, "train")
    p = PAR_TRAIN[name]
    w, h = p["res"]
    n = w * h * p["spp"]
    params = {k: np.asarray(getattr(scene.materials, k)) for k in p["keys"]}
    step = jmesh.sharded_train_step_fn(scene, camera, film_cfg, config, mesh,
                                       lr=p["lr"])
    arg = {k: jnp.asarray(v) for k, v in params.items()}
    if p["keys"] == ("kd",):
        arg = arg["kd"]           # the bare [M,3] form
    new, loss = step(arg, jnp.asarray(train_target(p["res"], p["target"])),
                     jnp.arange(n, dtype=jnp.int32))
    if p["keys"] == ("kd",):
        new = {"kd": new}
    return dict(loss=np.asarray(loss),
                **{k: (params[k] - np.asarray(new[k])) / p["lr"]
                   for k in p["keys"]})


def jax_texel_grad():
    import jax
    import jax.numpy as jnp
    from arendur_tpu.filming import film as flm
    from arendur_tpu.render import integrator as integ
    scene, camera, film_cfg, config, textures = textured_quad_scene()
    w, h = film_cfg.resolution
    total = w * h * config.spp

    def loss_of(texels):
        cfg = dataclasses.replace(config,
                                  textures=textures.replace(texels=texels))
        ray_idx = jnp.arange(total, dtype=jnp.int32)
        pixel_id = ray_idx // cfg.spp
        sample_id = ray_idx % cfg.spp
        pxy = jnp.stack([(pixel_id % w).astype(jnp.float32),
                         (pixel_id // w).astype(jnp.float32)], -1)
        pfilm, L = integ.trace_wave(scene, camera, cfg, pxy, pixel_id,
                                    sample_id,
                                    integ.smp.make_base_key(cfg.seed))
        state = flm.film_splat(film_cfg, flm.film_init(film_cfg), pfilm, L,
                               mask=ray_idx < total)
        return jnp.mean(flm.film_finalize(state, film_cfg) ** 2)

    loss, g = jax.value_and_grad(loss_of)(jnp.asarray(textures.texels))
    return dict(loss=np.asarray(loss), grad=np.asarray(g))


def jax_inst_etex():
    from arendur_tpu.render import integrator as integ
    scene, camera, film_cfg, config = inst_etex_scene()
    return dict(img=np.asarray(integ.render(scene, camera, film_cfg,
                                            config)))


def inst_wave():
    """(pixel_xy [N,2] f32, pixel_id [N], sample_id [N]) of inst_etex's
    one wave, in the render's pixel-major order."""
    w, h = INST_RES
    ray = np.arange(w * h * INST_SPP)
    pid, sid = ray // INST_SPP, ray % INST_SPP
    return (np.stack([pid % w, pid // w], -1).astype(np.float32),
            pid.astype(np.int32), sid.astype(np.int32))


def jax_inst_etex_lanes():
    """inst_etex's wave traced by the JAX package op by op (eager) and
    as one jitted function (as its render runs it): the radiance of each
    lane, [N, 3] each; and, from the op-by-op trace, each bounce's hit
    primitive and the cone spread after the bounce (prim, cone_g
    [depth, N], by original lane), which its bounce loop (a lax.scan)
    hands out as extra outputs: the loop and the scene query are
    wrapped, not changed."""
    from unittest import mock
    import jax
    import jax.numpy as jnp
    from arendur_tpu import scene as sc_
    from arendur_tpu.render import integrator as integ
    from arendur_tpu.sampling import sampler as smp_
    scene, camera, _, config = inst_etex_scene()
    args = [jnp.asarray(a) for a in inst_wave()] + [smp_.make_base_key(0)]
    scan, intersect, hits, bounces = jax.lax.scan, sc_.intersect, [], []

    def recording_intersect(*a, **k):
        hit = intersect(*a, **k)
        hits.append(hit.prim)
        return hit

    def recording_scan(f, init, xs, **kw):
        if not (isinstance(init, dict) and "cone_g" in init):
            return scan(f, init, xs, **kw)

        def body(c, x):
            del hits[:]
            c2, _ = f(c, x)
            return c2, (c2["st"]["orig"], hits[0], c2["cone_g"])
        carry, ys = scan(body, init, xs, **kw)
        bounces.append(ys)
        return carry, None

    def trace(*a):
        return integ.trace_wave(scene, camera, config, *a)[1]
    with mock.patch.object(jax.lax, "scan", recording_scan), \
            mock.patch.object(integ.sc, "intersect", recording_intersect):
        eager = np.asarray(trace(*args))
    (orig, prim, g), = bounces
    orig, prim, g = np.asarray(orig), np.asarray(prim), np.asarray(g)
    by_lane = dict(prim=np.full(prim.shape, -2, np.int32),
                   cone_g=np.full(g.shape, np.nan, np.float32))
    for b in range(g.shape[0]):
        by_lane["prim"][b, orig[b]] = prim[b]
        by_lane["cone_g"][b, orig[b]] = g[b]
    return dict(eager=eager, jit=np.asarray(jax.jit(trace)(*args)),
                **by_lane)


def _area_mode():
    """Fails unless the JAX package was imported in area mode."""
    from arendur_tpu.shapes import sphere as jsph
    if jsph.THETA_UNIFORM_COMPAT:
        raise RuntimeError("the area_* oracles need ARENDUR_SPHERE_THETA="
                           "area at the JAX package's import")


def jax_area(name):
    from arendur_tpu import cli as jcli
    from arendur_tpu.io import scenedesc as jsd
    from arendur_tpu.render import bpt as jbpt
    from arendur_tpu.render import integrator as jint
    _area_mode()
    if name == "area_train":
        return _jax_train(CB, "cluster")
    if name == "area_bpt":
        p = AREA_BPT
        js, jcam, jfilm, jcfg, _ = jsd.parse_scene(
            CB, spp_override=p["spp"], resolution_override=p["res"])
        jcfg = dataclasses.replace(jcfg, max_depth=p["depth"])
        return dict(img=np.asarray(jbpt.render_bpt(js, jcam, jfilm, jcfg)))
    js, jcam, jfilm, jcfg, _ = jsd.parse_scene(
        AREA_RENDERS.get(name, CB), spp_override=RENDER_SPP,
        resolution_override=RENDER_RES)
    if name == "area_whitted":
        return dict(img=np.asarray(jcli._render_whitted(js, jcam, jfilm,
                                                        jcfg)))
    jcfg = dataclasses.replace(jcfg, max_depth=RENDER_DEPTH)
    return dict(img=np.asarray(jint.render(js, jcam, jfilm, jcfg)))


ORACLES = {
    "cb_bvh": (lambda: render_inputs("bvh"),
               lambda: jax_intersector_render("bvh")),
    "cb_naive": (lambda: render_inputs("naive"),
                 lambda: jax_intersector_render("naive")),
    "sobol_plane": (sobol_inputs, jax_sobol_plane),
    "train_cb_etex": (lambda: train_inputs("cb_etex"),
                      lambda: jax_train_step("cb_etex")),
    "train_cb_bvh": (lambda: train_inputs("cb_bvh"),
                     lambda: jax_train_step("cb_bvh")),
    "texel_grad": (texel_inputs, jax_texel_grad),
    "inst_etex": (inst_inputs, jax_inst_etex),
    "inst_etex_lanes": (inst_inputs, jax_inst_etex_lanes),
    "big_lights": (big_inputs, jax_big_lights),
}
for _name in tuple(AREA_RENDERS) + ("area_bpt", "area_whitted",
                                    "area_train"):
    ORACLES[_name] = (lambda n=_name: area_inputs(n),
                      lambda n=_name: jax_area(n))
for _name in PAR_RENDER:
    ORACLES["par_render_" + _name] = (
        lambda n=_name: par_render_inputs(n), lambda n=_name: jax_par_render(n))
    ORACLES["par_train_" + _name] = (
        lambda n=_name: par_train_inputs(n), lambda n=_name: jax_par_train(n))
