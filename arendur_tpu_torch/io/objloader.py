"""Wavefront .obj/.mtl loader (port of arendur_tpu/io/objloader.py)
with the reference's material-inference rules (ref:
src/component/mod.rs:65-185).

Parses obj geometry into indexed (v, vt, vn)-deduplicated meshes (what
tobj does for the reference), groups triangles per material, and maps
each mtl onto a material-table row:

* illum containing "4"      -> Glass(diffuse, specular, roughness, Ni)
* dissolve != 1             -> Translucent(..., dissolve)
* specular mean == 0        -> Matte(diffuse, sigma=0)
* otherwise                 -> Plastic(diffuse, specular, roughness)

roughness = clamp((1000 - Ns) / 1000, 0, 1)  (mod.rs:121-123).
map_Kd / map_Ks / map_bump images go into the builder's texture atlas.
A default Matte(kd=(0.5, 0.6, 0.7)) backs faces without a material
(mod.rs:166-172).  Ke is ignored, as in the reference.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass
class Mtl:
    name: str
    diffuse: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    specular: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    shininess: float = 0.0
    dissolve: float = 1.0
    optical_density: float = 1.0
    illum: str = "2"
    diffuse_texture: str = ""
    specular_texture: str = ""
    bump_texture: str = ""


@dataclass
class ObjMesh:
    """One (object, material) group with re-indexed buffers."""
    name: str
    vertices: np.ndarray          # [V,3]
    normals: Optional[np.ndarray]  # [V,3] or None
    uvs: Optional[np.ndarray]      # [V,2] or None
    faces: np.ndarray             # [F,3] int
    material: Optional[Mtl]


def parse_mtl(path: str) -> Dict[str, Mtl]:
    mtls: Dict[str, Mtl] = {}
    cur: Optional[Mtl] = None
    if not os.path.exists(path):
        return mtls
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split("#")[0].split()
            if not parts:
                continue
            key = parts[0]
            if key == "newmtl":
                cur = Mtl(name=parts[1] if len(parts) > 1 else "")
                mtls[cur.name] = cur
            elif cur is None:
                continue
            elif key == "Kd" and len(parts) >= 4:
                cur.diffuse = tuple(float(x) for x in parts[1:4])
            elif key == "Ks" and len(parts) >= 4:
                cur.specular = tuple(float(x) for x in parts[1:4])
            elif key == "Ns":
                cur.shininess = float(parts[1])
            elif key == "d":
                cur.dissolve = float(parts[1])
            elif key == "Ni":
                cur.optical_density = float(parts[1])
            elif key == "illum":
                cur.illum = parts[1]
            elif key == "map_Kd":
                cur.diffuse_texture = parts[-1]
            elif key == "map_Ks":
                cur.specular_texture = parts[-1]
            elif key in ("map_bump", "bump"):
                cur.bump_texture = parts[-1]
    return mtls


def parse_obj(path: str) -> List[ObjMesh]:
    positions: List[List[float]] = []
    normals: List[List[float]] = []
    uvs: List[List[float]] = []
    mtls: Dict[str, Mtl] = {}

    # corner key -> new index, per active group
    groups: Dict[Tuple[str, str], dict] = {}

    def group_for(obj_name: str, mtl_name: str) -> dict:
        key = (obj_name, mtl_name)
        if key not in groups:
            groups[key] = dict(index={}, verts=[], norms=[], uvs=[],
                               faces=[], any_n=False, any_uv=False)
        return groups[key]

    obj_name = ""
    mtl_name = ""
    base = os.path.dirname(path)

    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split("#")[0].split()
            if not parts:
                continue
            key = parts[0]
            if key == "v":
                positions.append([float(x) for x in parts[1:4]])
            elif key == "vn":
                normals.append([float(x) for x in parts[1:4]])
            elif key == "vt":
                uvs.append([float(x) for x in parts[1:3]])
            elif key == "mtllib":
                mtls.update(parse_mtl(os.path.join(base, parts[1])))
            elif key in ("o", "g"):
                obj_name = parts[1] if len(parts) > 1 else ""
            elif key == "usemtl":
                mtl_name = parts[1] if len(parts) > 1 else ""
            elif key == "f":
                g = group_for(obj_name, mtl_name)
                corner_ids = []
                for corner in parts[1:]:
                    toks = corner.split("/")
                    vi = int(toks[0])
                    vi = vi - 1 if vi > 0 else len(positions) + vi
                    ti = ni = -1
                    if len(toks) > 1 and toks[1]:
                        ti = int(toks[1])
                        ti = ti - 1 if ti > 0 else len(uvs) + ti
                    if len(toks) > 2 and toks[2]:
                        ni = int(toks[2])
                        ni = ni - 1 if ni > 0 else len(normals) + ni
                    ck = (vi, ti, ni)
                    if ck not in g["index"]:
                        g["index"][ck] = len(g["verts"])
                        g["verts"].append(positions[vi])
                        g["norms"].append(
                            normals[ni] if ni >= 0 else [0.0, 0.0, 0.0])
                        g["uvs"].append(uvs[ti] if ti >= 0 else [0.0, 0.0])
                        g["any_n"] = g["any_n"] or ni >= 0
                        g["any_uv"] = g["any_uv"] or ti >= 0
                    corner_ids.append(g["index"][ck])
                # fan-triangulate polygons
                for i in range(1, len(corner_ids) - 1):
                    g["faces"].append(
                        [corner_ids[0], corner_ids[i], corner_ids[i + 1]])

    meshes = []
    for (oname, mname), g in groups.items():
        if not g["faces"]:
            continue
        meshes.append(ObjMesh(
            name=oname or mname,
            vertices=np.asarray(g["verts"], np.float32),
            normals=(np.asarray(g["norms"], np.float32)
                     if g["any_n"] else None),
            uvs=np.asarray(g["uvs"], np.float32) if g["any_uv"] else None,
            faces=np.asarray(g["faces"], np.int64),
            material=mtls.get(mname)))
    return meshes


def load_image(path: str) -> Optional[np.ndarray]:
    """Decode an image file to [H,W,3] float32 in [0,1] (the `image`
    crate analogue).  Returns None if the file is missing or
    unreadable."""
    try:
        from PIL import Image
        with Image.open(path) as im:
            arr = np.asarray(im.convert("RGB"), np.float32) / 255.0
        return arr
    except Exception:
        return None


def texture_id_for(atlas_builder, tex_cache: Dict, base: str,
                   fname: str, gamma: bool) -> int:
    """Load and register an image texture, deduplicated by (path,
    gamma) as the reference's shared mipmap cache is
    (component/mod.rs:105-148).  -1 where there is no file name, no
    atlas, or the file cannot be read."""
    if not fname or atlas_builder is None:
        return -1
    path = fname if os.path.isabs(fname) else os.path.join(base, fname)
    key = (os.path.normpath(path), gamma)
    if key in tex_cache:
        return tex_cache[key]
    img = load_image(path)
    tid = -1 if img is None else atlas_builder.add_image(img, gamma=gamma)
    tex_cache[key] = tid
    return tid


def material_row_from_mtl(mtl: Optional[Mtl], atlas_builder=None,
                          tex_cache=None, base: str = "") -> dict:
    """Apply the reference's inference rules (component/mod.rs:139-172),
    loading the diffuse / specular / bump image maps when an atlas
    builder is given (sRGB-decoded color maps, linear bump,
    mod.rs:108-137)."""
    from arendur_tpu_torch import materials as mats
    if mtl is None:
        return dict(mtype=mats.M_MATTE, kd=(0.5, 0.6, 0.7), sigma=0.0)
    tex_cache = tex_cache if tex_cache is not None else {}
    kd_tex = texture_id_for(atlas_builder, tex_cache, base,
                            mtl.diffuse_texture, gamma=True)
    ks_tex = texture_id_for(atlas_builder, tex_cache, base,
                            mtl.specular_texture, gamma=True)
    bump_tex = texture_id_for(atlas_builder, tex_cache, base,
                              mtl.bump_texture, gamma=False)
    # a textured channel keeps a white constant fallback, as the
    # reference's ImageTexture-or-Constant arms do (mod.rs:110-120)
    kd = (1.0, 1.0, 1.0) if kd_tex >= 0 else mtl.diffuse
    ks = (1.0, 1.0, 1.0) if ks_tex >= 0 else mtl.specular
    texes = dict(kd_tex=kd_tex, ks_tex=ks_tex, bump_tex=bump_tex)
    roughness = float(np.clip((1000.0 - mtl.shininess) / 1000.0, 0.0, 1.0))
    dissolve = float(np.clip(mtl.dissolve, 0.0, 1.0))
    spec_mean = float(np.mean(mtl.specular))
    if "4" in mtl.illum:
        return dict(mtype=mats.M_GLASS, kd=kd, ks=ks,
                    roughness=roughness, eta=mtl.optical_density, **texes)
    if abs(dissolve - 1.0) > 1e-6:
        return dict(mtype=mats.M_TRANSLUCENT, kd=kd,
                    ks=ks, roughness=roughness, dissolve=dissolve, **texes)
    if (spec_mean == 0.0 or not np.isfinite(spec_mean)) and ks_tex < 0:
        return dict(mtype=mats.M_MATTE, kd=kd, sigma=0.0, **texes)
    return dict(mtype=mats.M_PLASTIC, kd=kd, ks=ks, roughness=roughness,
                **texes)


def load_obj_groups(builder, path: str):
    """Parse an .obj, register its materials and image maps on the
    builder, and return its (object, material) groups as dicts (vertices,
    faces, normals, uvs, mat_id) without adding geometry: the form
    SceneBuilder.add_instanced_mesh takes, so that the mesh is loaded once
    however many instances place it (ref: component/transformed.rs:20)."""
    mat_ids: Dict[str, int] = {}
    atlas_builder = getattr(builder, "atlas", None)
    tex_cache = getattr(builder, "tex_cache", {})
    base = os.path.dirname(os.path.abspath(path))
    groups = []
    for mesh in parse_obj(path):
        key = mesh.material.name if mesh.material else "<default>"
        if key not in mat_ids:
            mat_ids[key] = builder.add_material(**material_row_from_mtl(
                mesh.material, atlas_builder=atlas_builder,
                tex_cache=tex_cache, base=base))
        groups.append(dict(vertices=mesh.vertices, faces=mesh.faces,
                           normals=mesh.normals, uvs=mesh.uvs,
                           mat_id=mat_ids[key]))
    return groups


def load_obj_into(builder, path: str, transform=None):
    """component::load_obj analogue: parse, infer materials, append
    all (object, material) groups to a SceneBuilder, baked by
    `transform`.  Image maps are registered on the builder's atlas."""
    for g in load_obj_groups(builder, path):
        builder.add_mesh(g["vertices"], g["faces"], g["mat_id"],
                         normals=g["normals"], uvs=g["uvs"],
                         transform=transform)
