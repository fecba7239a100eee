"""JSON scene description, schema-compatible with the reference CLI
(port of arendur_tpu/io/scenedesc.py; ref: examples/arencli.rs:206-509,
e.g. examples/cornellbox/cb.json).

parse_scene(path) returns (SceneData, CameraData, FilmConfig,
RenderConfig, outputfilename); the scene's image textures ride the
RenderConfig as a TextureAtlas, emission profiles of sphere lights
included.  Meshes are deferred to the end: a "Transformed" component
over a Mesh makes it an instanced mesh (one shared copy placed by the
mesh's transform and by each "Transformed" composed after it), a Mesh
that none names is baked into the world pool.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np

from arendur_tpu_torch import scene as sc
from arendur_tpu_torch import materials as mats
from arendur_tpu_torch.filming import camera as cam
from arendur_tpu_torch.filming import film as flm
from arendur_tpu_torch.sampling import filters as filt
from arendur_tpu_torch.render.integrator import RenderConfig
from arendur_tpu_torch.io.objloader import (load_obj_groups, load_obj_into,
                                            texture_id_for)


def _mat4(obj) -> np.ndarray:
    """JSON matrix: list of 4 columns, or {x,y,z,w} columns."""
    if obj is None:
        return np.eye(4, dtype=np.float32)
    if isinstance(obj, dict):
        rows = [obj["x"], obj["y"], obj["z"], obj["w"]]
    else:
        rows = obj
    return np.asarray(rows, np.float32)


def _rgb(obj) -> Tuple[float, float, float]:
    if isinstance(obj, dict):
        inner = obj.get("inner", obj)
        return tuple(float(x) for x in inner)
    return tuple(float(x) for x in obj)


class _Named:
    """Named<T> dedup helper (ref: arencli.rs:235-255): a later desc
    can reference an earlier one by name alone."""

    def __init__(self):
        self.values: Dict[str, object] = {}

    def resolve(self, named, build):
        name = named["name"]
        value = named.get("value")
        if value is not None:
            self.values[name] = build(value)
        return self.values.get(name)


class _TextureRegistry:
    """Named RGB / gray textures with Constant, Image, Product and Mix
    descs (ref: arencli.rs:376-440).  An RGB texture resolves to a
    (constant rgb, atlas texture id) pair, the material table's channel
    form (id -1: the constant is used)."""

    def __init__(self, builder, base):
        self.builder = builder
        self.base = base
        self.rgb = _Named()
        self.gray = _Named()

    def _image(self, desc) -> int:
        body = desc["Image"]
        return texture_id_for(self.builder.atlas, self.builder.tex_cache,
                              self.base,
                              body.get("path", body.get("filename", "")),
                              gamma=bool(body.get("gamma", True)))

    def _build_rgb(self, desc):
        if "Constant" in desc:
            return _rgb(desc["Constant"]["value"]), -1
        if "Image" in desc:
            return (1.0, 1.0, 1.0), self._image(desc)
        atlas = self.builder.atlas
        if "Product" in desc:
            body = desc["Product"]
            ta = self.rgb.values.get(body["ta"])
            tb = self.rgb.values.get(body["tb"])
            if ta is None or tb is None:
                # the reference drops a product of unknown operands
                # (arencli.rs:417-426); mirrored as neutral white
                return (1.0, 1.0, 1.0), -1
            (ca, ia), (cb, ib) = ta, tb
            if ia < 0 and ib < 0:
                return tuple(a * b for a, b in zip(ca, cb)), -1
            if ia >= 0 and ib >= 0:
                return (1.0, 1.0, 1.0), atlas.add_product(ia, tb=ib)
            img, const = (ia, cb) if ia >= 0 else (ib, ca)
            if all(abs(c - 1.0) < 1e-9 for c in const):
                return (1.0, 1.0, 1.0), img
            return (1.0, 1.0, 1.0), atlas.add_product(img, const=const)
        if "Mix" in desc:
            # {"Mix": {"ta", "tb", "l": float}} over named textures (the
            # reference's MixTexture, textures/mod.rs:62-94)
            body = desc["Mix"]
            ta = self.rgb.values.get(body["ta"])
            tb = self.rgb.values.get(body["tb"])
            if ta is None or tb is None:
                return (1.0, 1.0, 1.0), -1
            lv = float(body.get("l", 0.5))
            (ca, ia), (cb, ib) = ta, tb
            if ia < 0 and ib < 0:
                return tuple(a * (1 - lv) + b * lv
                             for a, b in zip(ca, cb)), -1
            mk = lambda c: atlas.add_image(
                np.broadcast_to(np.asarray(c, np.float32), (1, 1, 3)))
            i0 = ia if ia >= 0 else mk(ca)
            i1 = ib if ib >= 0 else mk(cb)
            return (1.0, 1.0, 1.0), atlas.add_mix(i0, i1, l=lv)
        raise NotImplementedError(
            f"texture desc {list(desc.keys())} is not supported")

    def resolve_rgb(self, named, default=(0.0, 0.0, 0.0)):
        out = self.rgb.resolve(named, self._build_rgb)
        return out if out is not None else (default, -1)

    def _build_gray(self, desc):
        if "Constant" in desc:
            return float(desc["Constant"]["value"])
        if "Image" in desc:
            return None  # a gray image channel keeps its default
        if "Product" in desc:
            body = desc["Product"]
            ta = self.gray.values.get(body["ta"])
            tb = self.gray.values.get(body["tb"])
            if ta is None or tb is None:
                return None
            return ta * tb
        raise NotImplementedError(
            f"texture desc {list(desc.keys())} is not supported")

    def resolve_gray(self, named, default=0.0):
        if named is None:
            return default
        out = self.gray.resolve(named, self._build_gray)
        return out if out is not None else default


def _material_row(desc, textures: _TextureRegistry) -> dict:
    rgb = textures.resolve_rgb
    gray = textures.resolve_gray
    (kind, body), = desc.items()
    if kind == "Matte":
        kd, kd_tex = rgb(body["kd"])
        return dict(mtype=mats.M_MATTE, kd=kd, kd_tex=kd_tex,
                    sigma=gray(body["sigma"], 0.0))
    if kind not in ("Plastic", "Glass", "Translucent"):
        raise ValueError(f"unknown material kind {kind}")
    kd, kd_tex = rgb(body["diffuse"])
    ks, ks_tex = rgb(body["specular"])
    texes = dict(kd=kd, kd_tex=kd_tex, ks=ks, ks_tex=ks_tex)
    if kind == "Plastic":
        return dict(mtype=mats.M_PLASTIC,
                    roughness=gray(body["roughness"], 0.5), **texes)
    if kind == "Glass":
        return dict(mtype=mats.M_GLASS,
                    roughness=gray(body["roughness"], 0.0),
                    eta=float(body.get("eta", 1.5)), **texes)
    if kind == "Translucent":
        return dict(mtype=mats.M_TRANSLUCENT,
                    roughness=gray(body["roughness"], 0.5),
                    dissolve=float(body.get("dissolve", 1.0)), **texes)


def parse_scene(path: str, spp_override: Optional[int] = None,
                resolution_override=None, intersector: str = "cluster"):
    """(SceneData, CameraData, FilmConfig, RenderConfig, output name) of
    a JSON scene description; intersector as SceneBuilder.build's."""
    with open(path) as f:
        desc = json.load(f)
    base = os.path.dirname(os.path.abspath(path))

    builder = sc.SceneBuilder()
    textures = _TextureRegistry(builder, base)
    named_mats = _Named()
    mat_ids: Dict[str, int] = {}
    sphere_specs: Dict[str, dict] = {}
    mesh_specs: Dict[str, dict] = {}
    mesh_instances: Dict[str, list] = {}

    for light in desc.get("lights", []):
        (kind, body), = light.items()
        if kind == "Point":
            builder.add_point_light(body["position"],
                                    _rgb(body["intensity"]))
        elif kind == "Spot":
            builder.add_spot_light(
                body["position"], body.get("direction", (0, 0, 1)),
                _rgb(body["intensity"]),
                float(body.get("cos_total", 0.5)),
                float(body.get("cos_falloff", 0.8)))
        elif kind == "Distant":
            builder.add_distant_light(
                body.get("direction", (0, 0, 1)), _rgb(body["radiance"]))

    for comp in desc.get("components", []):
        name = comp["name"]
        value = comp.get("value")
        if value is None:
            continue
        (kind, body), = value.items()
        if kind == "Mesh":
            fname = body["filename"]
            if not os.path.isabs(fname) and not os.path.exists(fname):
                # the reference resolves relative to the CWD; fall back
                # to the scene file's directory
                for cand in (os.path.join(base, fname),
                             os.path.join(base, os.path.basename(fname))):
                    if os.path.exists(cand):
                        fname = cand
                        break
            mesh_specs[name] = dict(fname=fname,
                                    transform=_mat4(body.get("transform")))
        elif kind == "Shaped":
            (sk, sphere), = body["shape"].items()
            if sk != "Sphere":
                raise NotImplementedError(f"shape {sk} is not supported")
            mat_named = body["material"]
            mname = mat_named["name"]
            if mat_named.get("value") is not None or mname not in mat_ids:
                row = named_mats.resolve(
                    mat_named, lambda v: _material_row(v, textures))
                if mname not in mat_ids:
                    mat_ids[mname] = builder.add_material(**row)
            mat_id = mat_ids[mname]
            light_named = body.get("light")
            emission = None
            etex, etex_mean = -1, 1.0
            if light_named is not None:
                # emission profile: the constant part times an optional
                # image texture at the surface point (ref:
                # component/shape.rs:91-130); lights and materials share
                # one namespace of named textures (arencli.rs:90,125-127)
                resolved = textures.rgb.resolve(light_named,
                                                textures._build_rgb)
                if resolved is not None:
                    emission, etex = resolved
                    if etex >= 0:
                        # the 1x1 mip level is the texture's mean: the
                        # power weight (ref: shape.rs:160-167)
                        etex_mean = float(builder.atlas.images[etex]
                                          ["levels"][-1].mean())
            transform = _mat4(body.get("transform"))
            spec = dict(radius=float(sphere["radius"]),
                        zmin=float(sphere["zmin"]),
                        zmax=float(sphere["zmax"]),
                        phimax=float(sphere["phimax"]),
                        mat_id=mat_id, emission=emission,
                        emission_tex=etex, emission_tex_mean=etex_mean)
            sphere_specs[name] = dict(spec=spec, transform=transform)
            builder.add_sphere(spec["radius"], spec["zmin"], spec["zmax"],
                               spec["phimax"], mat_id,
                               transform=transform, emission=emission,
                               emission_tex=etex,
                               emission_tex_mean=etex_mean)
        elif kind == "Transformed":
            if body["original"] in mesh_specs:
                # mesh instancing: the geometry is shared, the mesh's own
                # transform applies first, then this one
                mesh_instances.setdefault(body["original"], []).append(
                    mesh_specs[body["original"]]["transform"]
                    @ _mat4(body["transform"]))
                continue
            orig = sphere_specs.get(body["original"])
            if orig is None:
                continue
            composed = orig["transform"] @ _mat4(body["transform"])
            s = orig["spec"]
            builder.add_sphere(s["radius"], s["zmin"], s["zmax"],
                               s["phimax"], s["mat_id"],
                               transform=composed, emission=s["emission"],
                               emission_tex=s["emission_tex"],
                               emission_tex_mean=s["emission_tex_mean"])

    # the deferred meshes: baked where placed once, instanced (one shared
    # copy, the mesh's own placement first) where a "Transformed" names it
    for mname, spec in mesh_specs.items():
        extra = mesh_instances.get(mname, [])
        if not extra:
            load_obj_into(builder, spec["fname"], transform=spec["transform"])
        else:
            builder.add_instanced_mesh(
                load_obj_groups(builder, spec["fname"]),
                [spec["transform"]] + extra)

    scene = builder.build(intersector=intersector)

    cam_desc = desc["camera"]
    film_desc = cam_desc["film"]
    res = (int(film_desc["resolution"]["x"]),
           int(film_desc["resolution"]["y"]))
    if resolution_override is not None:
        res = tuple(resolution_override)
    fr = film_desc.get("filter_radius", {"x": 4.0, "y": 4.0})
    film_cfg = flm.FilmConfig(
        resolution=res,
        filter=filt.FilterSpec(
            kind="lanczos", radius=(float(fr["x"]), float(fr["y"])),
            tau=3.0))
    camera = cam.make_perspective(
        parent_view=_mat4(cam_desc.get("transform")),
        screen_min=(cam_desc["screen"]["pmin"]["x"],
                    cam_desc["screen"]["pmin"]["y"]),
        screen_max=(cam_desc["screen"]["pmax"]["x"],
                    cam_desc["screen"]["pmax"]["y"]),
        znear=float(cam_desc.get("znear", 0.1)),
        zfar=float(cam_desc.get("zfar", 1000.0)),
        fov=float(cam_desc.get("fov", 1.0)),
        lens=cam_desc.get("lens"),
        resolution=res)

    sampler_desc = desc.get("sampler", {})
    dx = int(sampler_desc.get("sampledx", 4))
    dy = int(sampler_desc.get("sampledy", 4))
    spp = dx * dy
    if spp_override is not None:
        spp = spp_override
        dx = max(1, int(np.sqrt(spp)))
        dy = max(1, spp // dx)
    config = RenderConfig(max_depth=int(desc.get("max_depth", 8)),
                          spp=spp, sample_dx=dx, sample_dy=dy,
                          textures=builder.build_textures(),
                          tex_filter=str(desc.get("tex_filter",
                                                  "trilinear")))
    return scene, camera, film_cfg, config, desc.get(
        "outputfilename", "out.png")
