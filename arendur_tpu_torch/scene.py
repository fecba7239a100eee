"""Scene: triangle and sphere pools, materials, lights (port of
arendur_tpu/scene.py; ref: src/renderer/scene.rs, src/component/).

``SceneBuilder`` accumulates geometry on the host and freezes it into a
``SceneData`` of NumPy arrays (meshes, spheres, lights, materials, and
instanced meshes: one local-space copy of a mesh placed by I
transforms, ``InstancedMesh``); its image textures, material maps and
emission profiles alike, go into an atlas of their own
(``build_textures``), which the render takes through its config.
``DeviceScene.build`` moves the tables the render reads onto one device
and computes, once and from NumPy, the host-static sets the bounce
shade is specialised on (slot presence, distribution presence, the
light column map, the light types present, full-phi spheres).  A scene
may have no world triangle at all (pure-instanced or triangle-less):
its world pool then holds no cluster.  Primitive ids: [0, T) world
triangles, [T, T+S) spheres, then each instanced mesh's T_m local
triangles in order (the winning instance is not part of the id).

The world triangles meet one of three intersectors, chosen at build
(``SceneBuilder.build(intersector=)``, the CLI's ``--intersector``):
the SAH cluster tables of kernels K1 / K2 (``"cluster"``, the default),
the per-ray BVH walk (``"bvh"``, accel/bvh.py) or the brute-force test
(``"naive"``, shapes/triangle.py); the last two are plain PyTorch, as
the JAX package runs them in XLA, and the spheres of such a scene go
through K1 / K2 with no cluster.  With the cluster tables the closest
hit over the world pool and the spheres is one K1 launch; each
instanced mesh adds one K1 launch over its [I * N] lanes (the rays
taken into each instance's frame, ``period`` N), bounded by the hit so
far, and the winning instance per lane (``closest_hits``).  For the
composed bounce, ``intersect`` returns the full closest-hit record
``Hit`` and ``light_emission`` / ``emission_tex_factor`` read an area
light's radiance through its emission texture.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from arendur_tpu_torch import materials as mats
from arendur_tpu_torch.shapes import sphere as sph

# light types
L_AREA_SPHERE = 0
L_AREA_TRI = 1
L_POINT = 2
L_SPOT = 3
L_DISTANT = 4


@dataclasses.dataclass(frozen=True, eq=False)
class LightTable:
    ltype: np.ndarray     # [L] int32
    prim: np.ndarray      # [L] int32: sphere idx / tri idx for area
    emission: np.ndarray  # [L,3] radiance (area) / intensity (point)
    pos: np.ndarray       # [L,3] position (point/spot) or direction
    aux: np.ndarray       # [L,3] spot axis / distant world center
    params: np.ndarray    # [L,4] cos_total/cos_falloff (spot), wradius
    emission_tex: np.ndarray = None   # [L] int32, -1 = constant
    types_present: tuple = None

    @property
    def count(self):
        return self.ltype.shape[0]


@dataclasses.dataclass(frozen=True, eq=False)
class Distribution1D:
    """Piecewise-constant 1D distribution (ref: distribution.rs)."""
    func: np.ndarray      # [n]
    cdf: np.ndarray       # [n+1]
    func_int: np.float32


def build_distribution_1d(func) -> Distribution1D:
    """Host-side CDF build (ref: distribution.rs:23-56)."""
    f = np.asarray(func, np.float32)
    n = len(f)
    cdf = np.zeros(n + 1, np.float32)
    cdf[1:] = np.cumsum(f / n)
    func_int = cdf[-1]
    if func_int == 0.0:
        cdf = np.arange(n + 1, dtype=np.float32) / n
    else:
        cdf = cdf / func_int
    return Distribution1D(func=f, cdf=cdf, func_int=np.float32(func_int))


@dataclasses.dataclass(frozen=True, eq=False)
class InstancedMesh:
    """One mesh kept in local space, placed I times by per-instance
    transforms (twin: scene.InstancedMesh; ref:
    component/transformed.rs:20).  Rays go into each instance's frame
    (the direction by the linear part alone, so t is unchanged), meet the
    shared cluster tables, and the winning hit's shading frame comes back
    to world space (normals by the inverse-transpose)."""
    cw: np.ndarray      # [C,16,4K] cluster determinant weights (local)
    cbox: np.ndarray    # [C,8] cluster AABBs (local)
    remap: np.ndarray   # [C*K] slot -> local triangle id
    attr: np.ndarray    # [T,26] packed v/n/uv/mat/light rows (local)
    o2w: np.ndarray     # [I,4,4] row-vector convention
    w2o: np.ndarray     # [I,4,4]
    nrm: np.ndarray     # [I,3,3] inverse-transpose of the linear part

    @property
    def n_instances(self):
        return self.o2w.shape[0]


@dataclasses.dataclass(frozen=True, eq=False)
class SceneData:
    tri_v0: np.ndarray
    tri_v1: np.ndarray
    tri_v2: np.ndarray
    tri_n0: np.ndarray
    tri_n1: np.ndarray
    tri_n2: np.ndarray
    tri_uv0: np.ndarray
    tri_uv1: np.ndarray
    tri_uv2: np.ndarray
    tri_mat: np.ndarray
    tri_light: np.ndarray
    spheres: sph.SphereSoA
    materials: mats.MaterialTable
    lights: LightTable
    # cluster intersector tables (accel/clusters.py): tri_cw
    # [C,16,4K] determinant weights, tri_cbox [C,8] AABBs, tri_remap
    # [C*K] slot -> original triangle id
    tri_cw: Optional[np.ndarray] = None
    tri_cbox: Optional[np.ndarray] = None
    tri_remap: Optional[np.ndarray] = None
    light_distribution: Distribution1D = None
    # instanced meshes (shared local-space geometry, per-instance
    # transforms)
    inst: tuple = ()
    # the world triangles' BVH (accel/bvh.py): the intersector where no
    # cluster tables were built (intersector "bvh")
    bvh: Optional[object] = None

    @property
    def n_tris(self):
        return self.tri_v0.shape[0]


def light_types_present(lights: LightTable):
    """Host-static sorted tuple of the light types in the scene."""
    if lights.types_present is not None:
        return tuple(lights.types_present)
    return tuple(sorted(int(t) for t in np.unique(np.asarray(
        lights.ltype))))


def light_pack(scene: SceneData):
    """One packed [L, C] float32 row per light + the column map.

    Every per-light attribute NEE needs, including the area light's
    resolved geometry, lives in one row; blocks for light types absent
    from the scene are omitted.  Returns (pack, idx: name -> (lo, hi),
    present)."""
    lights = scene.lights
    present = light_types_present(lights)
    nl = lights.ltype.shape[0]
    cols, idx = [], {}
    ofs = 0

    def add(name, arr):
        nonlocal ofs
        arr = np.asarray(arr).astype(np.float32)
        if arr.ndim == 1:
            arr = arr[:, None]
        arr = arr.reshape(nl, -1)
        idx[name] = (ofs, ofs + arr.shape[1])
        cols.append(arr)
        ofs += arr.shape[1]

    has = lambda t: t in present
    add("ltype", lights.ltype)
    add("emission", lights.emission)
    add("pos", lights.pos)
    add("aux", lights.aux)
    add("params", lights.params)
    if lights.emission_tex is not None:
        add("emission_tex", lights.emission_tex)
    prim = np.maximum(np.asarray(lights.prim), 0)
    if has(L_AREA_TRI) and scene.n_tris > 0:
        tp = np.minimum(prim, scene.n_tris - 1)
        for name in ("tri_v0", "tri_v1", "tri_v2", "tri_n0", "tri_n1",
                     "tri_n2", "tri_uv0", "tri_uv1", "tri_uv2"):
            add(name, np.asarray(getattr(scene, name))[tp])
    if has(L_AREA_SPHERE):
        s = scene.spheres
        sp = np.minimum(prim, s.count - 1)
        add("s_o2w", np.asarray(s.o2w)[sp].reshape(nl, 16))
        add("s_w2o", np.asarray(s.w2o)[sp].reshape(nl, 16))
        add("s_radius", np.asarray(s.radius)[sp])
        add("s_zmin", np.asarray(s.zmin)[sp])
        add("s_zmax", np.asarray(s.zmax)[sp])
        add("s_thetamin", np.asarray(s.thetamin)[sp])
        add("s_thetamax", np.asarray(s.thetamax)[sp])
        add("s_phimax", np.asarray(s.phimax)[sp])
    return np.concatenate(cols, axis=1), idx, present


def tri_pack(scene: SceneData) -> np.ndarray:
    """[T,26] packed per-triangle attribute rows (v0 v1 v2 n0 n1 n2
    uv0 uv1 uv2 mat light): one gather resolves a hit."""
    if scene.n_tris == 0:
        return np.zeros((1, 26), np.float32)
    return np.concatenate([
        scene.tri_v0, scene.tri_v1, scene.tri_v2,
        scene.tri_n0, scene.tri_n1, scene.tri_n2,
        scene.tri_uv0, scene.tri_uv1, scene.tri_uv2,
        np.asarray(scene.tri_mat).astype(np.float32)[:, None],
        np.asarray(scene.tri_light).astype(np.float32)[:, None],
    ], axis=1).astype(np.float32)


def _tri_rows(v, f, normals=None, uvs=None):
    """Per-triangle corner rows of faces f [F,3] over vertices v [V,3]:
    (p0, p1, p2, n0, n1, n2, uv0, uv1, uv2), the face normal where the
    mesh has no normals and the reference's default uvs where it has no
    uvs (ref: triangle.rs:292-296)."""
    p0, p1, p2 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    nf = len(f)
    if normals is not None and len(normals):
        nn = np.asarray(normals, np.float32)
        n0, n1, n2 = nn[f[:, 0]], nn[f[:, 1]], nn[f[:, 2]]
    else:
        face_n = np.cross(p1 - p0, p2 - p0)
        norm = np.linalg.norm(face_n, axis=-1, keepdims=True)
        face_n = face_n / np.maximum(norm, 1e-20)
        n0 = n1 = n2 = face_n
    if uvs is not None and len(uvs):
        uu = np.asarray(uvs, np.float32)
        uv0, uv1, uv2 = uu[f[:, 0]], uu[f[:, 1]], uu[f[:, 2]]
    else:
        uv0 = np.tile(np.array([0.0, 0.0], np.float32), (nf, 1))
        uv1 = np.tile(np.array([1.0, 0.0], np.float32), (nf, 1))
        uv2 = np.tile(np.array([1.0, 1.0], np.float32), (nf, 1))
    return p0, p1, p2, n0, n1, n2, uv0, uv1, uv2


class SceneBuilder:
    """Host-side accumulation of meshes, spheres, lights and
    materials, frozen into a SceneData (the arencli parse_input
    analogue)."""

    def __init__(self):
        self.tv0: List[np.ndarray] = []
        self.tv1: List[np.ndarray] = []
        self.tv2: List[np.ndarray] = []
        self.tn0: List[np.ndarray] = []
        self.tn1: List[np.ndarray] = []
        self.tn2: List[np.ndarray] = []
        self.tuv0: List[np.ndarray] = []
        self.tuv1: List[np.ndarray] = []
        self.tuv2: List[np.ndarray] = []
        self.tmat: List[np.ndarray] = []
        self.tlight: List[np.ndarray] = []
        self.sphere_rows = []
        self.material_rows = []
        self.light_rows = []
        self.instanced = []           # add_instanced_mesh records
        from arendur_tpu_torch.texturing.texture import AtlasBuilder
        self.atlas = AtlasBuilder()   # image textures (obj / JSON maps)
        self.tex_cache = {}           # (path, gamma) -> texture id

    def build_textures(self, device="cpu"):
        """Freeze the image-texture atlas (None if no textures)."""
        return self.atlas.build(device)

    def add_material(self, **kw) -> int:
        self.material_rows.append(kw)
        return len(self.material_rows) - 1

    def add_mesh(self, vertices, faces, mat_id: int, normals=None,
                 uvs=None, transform=None, emission=None,
                 emission_tex: int = -1, emission_tex_mean=1.0):
        """Add a triangle mesh: vertices [V,3], faces [F,3] int;
        transform: optional 4x4 (row layout, projective divide).  An
        emissive mesh's radiance is emission times the atlas texture
        emission_tex at the surface uv (-1: constant); emission_tex_mean
        (the texture's mean) weighs its power for light selection."""
        v = np.asarray(vertices, np.float32)
        f = np.asarray(faces, np.int64)
        if transform is not None:
            m = np.asarray(transform, np.float32)
            h = v @ m[:3, :3] + m[3, :3]
            w = v @ m[:3, 3] + m[3, 3]
            v = h / w[:, None]
            if normals is not None:
                inv = np.linalg.inv(m[:3, :3])
                normals = np.asarray(normals, np.float32) @ inv.T
        p0, p1, p2, n0, n1, n2, uv0, uv1, uv2 = _tri_rows(v, f, normals,
                                                         uvs)
        nf = len(f)
        light_ids = np.full(nf, -1, np.int32)
        if emission is not None:
            base_tri = sum(len(a) for a in self.tv0)
            for i in range(nf):
                light_ids[i] = len(self.light_rows)
                self.light_rows.append(dict(
                    ltype=L_AREA_TRI, prim=base_tri + i,
                    emission=tuple(emission), emission_tex=emission_tex,
                    tex_mean=emission_tex_mean))
        self.tv0.append(p0)
        self.tv1.append(p1)
        self.tv2.append(p2)
        self.tn0.append(n0)
        self.tn1.append(n1)
        self.tn2.append(n2)
        self.tuv0.append(uv0)
        self.tuv1.append(uv1)
        self.tuv2.append(uv2)
        self.tmat.append(np.full(nf, mat_id, np.int32))
        self.tlight.append(light_ids)

    def add_instanced_mesh(self, groups, transforms):
        """Add a mesh placed by several instance transforms that share
        one copy of its geometry (ref: component/transformed.rs:20).

        groups: dicts with keys vertices [V,3], faces [F,3], mat_id and
        optional normals / uvs, the (object, material) groups of one
        source mesh, kept in local space.  transforms: [I,4,4]
        object-to-world matrices (row-vector convention; only the linear
        part and the translation row are read).  Instanced triangles are
        never lights (their light column is -1)."""
        cols = [[] for _ in range(10)]
        for g in groups:
            f = np.asarray(g["faces"], np.int64)
            rows = _tri_rows(np.asarray(g["vertices"], np.float32), f,
                             g.get("normals"), g.get("uvs"))
            for lst, a in zip(cols, rows + (np.full((len(f), 1), g["mat_id"],
                                                    np.float32),)):
                lst.append(a)
        cat = [np.concatenate(lst, 0) for lst in cols]
        attr = np.concatenate(
            cat + [np.full((len(cat[0]), 1), -1.0, np.float32)], axis=1)
        ts = np.stack([np.asarray(t, np.float32) for t in transforms])
        self.instanced.append(dict(attr=attr.astype(np.float32),
                                   transforms=ts))

    def add_sphere(self, radius, zmin, zmax, phimax, mat_id: int,
                   transform=None, emission=None, emission_tex: int = -1,
                   emission_tex_mean=1.0):
        """Add a sphere (emission and its texture as in add_mesh)."""
        o2w = (np.eye(4, dtype=np.float32) if transform is None
               else np.asarray(transform, np.float32))
        light_id = -1
        if emission is not None:
            light_id = len(self.light_rows)
            self.light_rows.append(dict(
                ltype=L_AREA_SPHERE, prim=len(self.sphere_rows),
                emission=tuple(emission), emission_tex=emission_tex,
                tex_mean=emission_tex_mean))
        self.sphere_rows.append(dict(
            o2w=o2w, radius=radius, zmin=zmin, zmax=zmax, phimax=phimax,
            mat_id=mat_id, light_id=light_id))

    def add_point_light(self, pos, intensity):
        self.light_rows.append(dict(
            ltype=L_POINT, prim=-1, emission=tuple(intensity),
            pos=tuple(pos)))

    def add_spot_light(self, pos, direction, intensity, cos_total,
                       cos_falloff):
        self.light_rows.append(dict(
            ltype=L_SPOT, prim=-1, emission=tuple(intensity),
            pos=tuple(pos), aux=tuple(direction),
            params=(cos_total, cos_falloff, 0.0, 0.0)))

    def add_distant_light(self, direction, radiance, world_radius=None):
        """world_radius=None resolves to the scene's bounding sphere at
        build() (ref: distantlight.rs:43-50)."""
        self.light_rows.append(dict(
            ltype=L_DISTANT, prim=-1, emission=tuple(radiance),
            pos=tuple(direction),
            params=(-1.0 if world_radius is None else float(world_radius),
                    0.0, 0.0, 0.0)))

    def _world_bsphere(self):
        """Scene bounding sphere over triangles, transformed spheres and
        instanced meshes (their local box corners through each transform;
        ref: distantlight.rs:43-50)."""
        pts = []
        for lst in (self.tv0, self.tv1, self.tv2):
            for a in lst:
                if len(a):
                    pts.append(np.min(a, 0))
                    pts.append(np.max(a, 0))
        for row in self.sphere_rows:
            m = np.asarray(row["o2w"], np.float32)
            c = m[3, :3]
            r = float(row["radius"]) * float(
                np.linalg.norm(m[:3, :3], 2))
            pts.append(c - r)
            pts.append(c + r)
        for rec in self.instanced:
            a = rec["attr"]
            v = np.concatenate([a[:, 0:3], a[:, 3:6], a[:, 6:9]], 0)
            lo, hi = v.min(0), v.max(0)
            corners = np.array([[x, y, z] for x in (lo[0], hi[0])
                                for y in (lo[1], hi[1])
                                for z in (lo[2], hi[2])], np.float32)
            for t in rec["transforms"]:
                m = np.asarray(t, np.float32)
                w = corners @ m[:3, :3] + m[3, :3]
                pts.append(w.min(0))
                pts.append(w.max(0))
        if not pts:
            return np.zeros(3, np.float32), 1.0
        lo = np.min(np.stack(pts), 0)
        hi = np.max(np.stack(pts), 0)
        center = 0.5 * (lo + hi)
        radius = float(np.linalg.norm(hi - center))
        return center.astype(np.float32), max(radius, 1e-6)

    def _light_power(self, row, tri_areas, sphere_areas) -> float:
        """Power for the light-selection distribution (ref:
        scene.rs:36-44; area power = mean*area*pi, the mean of a
        textured emission scaled by the texture's mean)."""
        e = np.asarray(row["emission"], np.float32) \
            * float(row.get("tex_mean", 1.0))
        lum = float(e @ np.asarray([0.212671, 0.715160, 0.072169],
                                   np.float32))
        lt = row["ltype"]
        if lt == L_AREA_SPHERE:
            return lum * sphere_areas[row["prim"]] * np.pi
        if lt == L_AREA_TRI:
            return lum * tri_areas[row["prim"]] * np.pi
        if lt == L_POINT:
            return lum * 4.0 * np.pi
        if lt == L_SPOT:
            ct, cf = row["params"][0], row["params"][1]
            return lum * 2.0 * np.pi * (1 - 0.5 * (cf - ct))
        if lt == L_DISTANT:
            wr = row["params"][0]
            return lum * np.pi * wr * wr
        return lum

    def build(self, intersector: str = "cluster") -> SceneData:
        """Freeze the scene.  intersector selects the structure the world
        triangles are tested with: "cluster" (the SAH cluster tables of
        K1 / K2, default), "bvh" (the per-ray BVH walk) or "naive" (the
        brute-force test); only that structure is built.  Instanced
        meshes always get their cluster tables."""
        from arendur_tpu_torch.accel import bvh as bvhmod
        from arendur_tpu_torch.accel.clusters import build_clusters
        if intersector not in ("cluster", "bvh", "naive"):
            raise ValueError(f"unknown intersector {intersector!r}")
        cat = lambda lst, d: (np.concatenate(lst, 0) if lst
                              else np.zeros((0,) + d, np.float32))
        v0 = cat(self.tv0, (3,))
        v1 = cat(self.tv1, (3,))
        v2 = cat(self.tv2, (3,))
        tri_areas = 0.5 * np.linalg.norm(
            np.cross(v1 - v0, v2 - v0), axis=-1) if len(v0) else np.zeros(0)

        # distant lights: world bounds from the scene's bounding sphere,
        # resolved before the placeholder sphere below is appended
        if any(r["ltype"] == L_DISTANT for r in self.light_rows):
            wc, wrad = self._world_bsphere()
            resolved = []
            for row in self.light_rows:
                if row["ltype"] == L_DISTANT:
                    row = dict(row)
                    p = row.get("params", (-1.0, 0, 0, 0))
                    wr = p[0] if p[0] > 0.0 else wrad
                    row["params"] = (wr, 0.0, 0.0, 0.0)
                    row["aux"] = tuple(float(x) for x in wc)
                resolved.append(row)
            self.light_rows = resolved

        if not self.sphere_rows:
            # one degenerate far-away sphere keeps shapes static
            self.sphere_rows.append(dict(
                o2w=np.diag([1, 1, 1, 1]).astype(np.float32) +
                np.array([[0, 0, 0, 0]] * 3 + [[1e8, 1e8, 1e8, 0]],
                         np.float32),
                radius=1e-6, zmin=-1e-6, zmax=1e-6, phimax=2 * np.pi,
                mat_id=0, light_id=-1))
        cols = {k: [] for k in ("o2w", "w2o", "radius", "zmin", "zmax",
                                "thetamin", "thetamax", "phimax",
                                "mat_id", "light_id")}
        sphere_areas = []
        for row in self.sphere_rows:
            r, zn, zx, tmin, tmax_, pm = sph.make_sphere_params(
                row["radius"], row["zmin"], row["zmax"], row["phimax"])
            for k, v in (("o2w", row["o2w"]),
                         ("w2o", np.linalg.inv(row["o2w"])),
                         ("radius", r), ("zmin", zn), ("zmax", zx),
                         ("thetamin", tmin), ("thetamax", tmax_),
                         ("phimax", pm), ("mat_id", row["mat_id"]),
                         ("light_id", row["light_id"])):
                cols[k].append(v)
            sphere_areas.append(pm * r * (zx - zn))
        f32 = lambda k: np.asarray(cols[k], np.float32)
        spheres = sph.SphereSoA(
            o2w=np.stack(cols["o2w"]), w2o=np.stack(cols["w2o"]),
            radius=f32("radius"), zmin=f32("zmin"), zmax=f32("zmax"),
            thetamin=f32("thetamin"), thetamax=f32("thetamax"),
            phimax=f32("phimax"),
            mat_id=np.asarray(cols["mat_id"], np.int32),
            light_id=np.asarray(cols["light_id"], np.int32),
            phi_full=bool((f32("phimax") >= 2.0 * np.pi - 1e-5).all()))

        nl = max(1, len(self.light_rows))
        lt = np.zeros(nl, np.int32)
        lprim = np.full(nl, -1, np.int32)
        lem = np.zeros((nl, 3), np.float32)
        lpos = np.zeros((nl, 3), np.float32)
        laux = np.zeros((nl, 3), np.float32)
        lpar = np.zeros((nl, 4), np.float32)
        letex = np.full(nl, -1, np.int32)
        powers = np.zeros(nl, np.float32)
        for i, row in enumerate(self.light_rows):
            lt[i] = row["ltype"]
            lprim[i] = row.get("prim", -1)
            lem[i] = row["emission"]
            lpos[i] = row.get("pos", (0, 0, 0))
            laux[i] = row.get("aux", (0, 0, 1))
            lpar[i] = row.get("params", (0, 0, 0, 0))
            letex[i] = row.get("emission_tex", -1)
            powers[i] = self._light_power(row, tri_areas, sphere_areas)
        lights = LightTable(
            ltype=lt, prim=lprim, emission=lem, pos=lpos,
            aux=laux, params=lpar, emission_tex=letex,
            types_present=tuple(sorted(set(int(t) for t in lt))))

        if not self.material_rows:
            self.material_rows.append(dict(mtype=0, kd=(0.5, 0.5, 0.5)))
        catf = lambda lst, d, dt=np.float32: (
            np.concatenate(lst, 0).astype(dt) if lst
            else np.zeros((0,) + d, dt))
        bvh = None
        if intersector == "bvh" and len(v0) > 0:
            bvh = bvhmod.build_bvh(v0, v1, v2)
        cw = cbox = remap = None
        if intersector == "cluster" and len(v0) > 0:
            tabs = build_clusters(v0, v1, v2)
            cw, cbox, remap = (tabs["w_chunks"], tabs["cbox"],
                               tabs["remap"])
        inst = []
        for rec in self.instanced:
            a = rec["attr"]
            itabs = build_clusters(a[:, 0:3], a[:, 3:6], a[:, 6:9])
            ts = rec["transforms"]
            inst.append(InstancedMesh(
                cw=itabs["w_chunks"], cbox=itabs["cbox"],
                remap=itabs["remap"], attr=a, o2w=ts,
                w2o=np.stack([np.linalg.inv(t) for t in ts]),
                nrm=np.stack([np.linalg.inv(m).T for m in ts[:, :3, :3]])))
        return SceneData(
            bvh=bvh, tri_cw=cw, tri_cbox=cbox, tri_remap=remap,
            inst=tuple(inst),
            tri_v0=v0, tri_v1=v1, tri_v2=v2,
            tri_n0=catf(self.tn0, (3,)),
            tri_n1=catf(self.tn1, (3,)),
            tri_n2=catf(self.tn2, (3,)),
            tri_uv0=catf(self.tuv0, (2,)),
            tri_uv1=catf(self.tuv1, (2,)),
            tri_uv2=catf(self.tuv2, (2,)),
            tri_mat=catf(self.tmat, (), np.int32),
            tri_light=catf(self.tlight, (), np.int32),
            spheres=spheres,
            materials=mats.make_material_table(self.material_rows),
            lights=lights,
            light_distribution=build_distribution_1d(
                powers if len(powers) else [1.0]))


@dataclasses.dataclass(frozen=True)
class ShadeStatic:
    """Host-static configuration of the bounce shade, computed once
    from the NumPy scene (never from device tensors)."""
    presence: tuple     # per slot column: sorted BSDF type ids
    dist_sets: tuple    # ((slot type, (dist ids...)), ...)
    lcidx: tuple        # sorted ((column name, (lo, hi)), ...)
    lpresent: tuple     # light types present
    emi_cols: tuple     # (lo, hi) of the emission columns
    full_phi: bool      # every sphere light is full-phi


def shade_static(scene: SceneData) -> ShadeStatic:
    _, cidx, present = light_pack(scene)
    lt = np.asarray(scene.lights.ltype)
    prim = np.asarray(scene.lights.prim)
    phimax = np.asarray(scene.spheres.phimax)
    sl_rows = lt == L_AREA_SPHERE
    full_phi = True
    if sl_rows.any():
        p = np.clip(prim[sl_rows], 0, len(phimax) - 1)
        full_phi = bool((phimax[p] >= 2.0 * np.pi - 1e-5).all())
    return ShadeStatic(
        presence=mats.slot_presence(scene.materials),
        dist_sets=mats.dist_presence(scene.materials),
        lcidx=tuple(sorted(cidx.items())),
        lpresent=tuple(present),
        emi_cols=tuple(cidx["emission"]),
        full_phi=full_phi)


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceInstances:
    """One instanced mesh's tables on the device."""
    cw: torch.Tensor        # [C,16,4K] local cluster weights
    cbox: torch.Tensor      # [C,8]
    remap: torch.Tensor     # [C*K] int64 slot -> local triangle id
    attr: torch.Tensor      # [T,26] local triangle rows (light -1)
    o2w: torch.Tensor       # [I,4,4]
    w2o: torch.Tensor       # [I,4,4]
    nrm: torch.Tensor       # [I,3,3]
    prim_base: int          # the primitive id of its local triangle 0
    itab: torch.Tensor      # [I,20] the instanced kernels' instance rows
                            # (instance_table)

    @property
    def n_instances(self):
        return self.o2w.shape[0]


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceScene:
    """The tables one render reads, on one device, plus the
    host-static shade configuration."""
    device: torch.device
    n_tris: int
    cw: torch.Tensor        # [C,16,4K] cluster determinant weights (C = 0:
                            # an empty world pool)
    cbox: torch.Tensor      # [C,8] cluster AABBs
    remap: torch.Tensor     # [C*K] int64 slot -> triangle id ([-1] for an
                            # empty world pool)
    tpack: torch.Tensor     # [T,26] triangle attribute rows
    ltab: torch.Tensor      # [L,Cl] light_pack rows
    mtab: torch.Tensor      # [M,16] material rows
    stab: torch.Tensor      # [S,24] sphere shade rows
    ktab: torch.Tensor      # [S,24] sphere rows of the intersect kernels
    full_phi: bool          # every sphere is full-phi (no phi clip)
    light_cdf: torch.Tensor       # [L+1]
    light_func: torch.Tensor      # [L]
    light_func_int: float
    static: ShadeStatic
    materials: mats.MaterialTable  # the NumPy rows mtab was packed from
    emission_textured: bool = False  # some light has an emission texture
    inst: tuple = ()        # DeviceInstances, one per instanced mesh
    intersector: str = "cluster"  # the world triangles' intersector:
                            # "cluster" (cw / cbox / remap), "bvh" or
                            # "naive" (then cw holds no cluster)
    bvh: Optional[object] = None  # accel.bvh.DeviceBVH ("bvh")
    tri_v: tuple = ()       # (v0, v1, v2) [T,3] world corners ("naive")

    @property
    def light_distribution(self) -> Distribution1D:
        """The power-weighted light-selection distribution, its leaves
        on the device (sampling/distribution.py reads it)."""
        return Distribution1D(func=self.light_func, cdf=self.light_cdf,
                              func_int=self.light_func_int)

    @property
    def composed_only(self) -> bool:
        """Whether only the composed bounce serves the scene (twin:
        integrator._mega_eligible): a light carries an emission texture,
        the scene has no triangle, world or instanced, or its world
        triangles have no cluster tables (the BVH walk or the brute
        force)."""
        return self.emission_textured or (self.n_tris == 0
                                          and not self.inst) \
            or (self.n_tris > 0 and self.intersector != "cluster")

    @staticmethod
    def build(scene: SceneData, device) -> "DeviceScene":
        """The scene's tables on `device`.  Its world triangles take
        the cluster tables where it has them, else its BVH, else the
        brute-force test (the JAX package's order, scene.py:890-895)."""
        etex = scene.lights.emission_tex
        device = torch.device(device)
        t = lambda a, dt=torch.float32: torch.as_tensor(
            np.ascontiguousarray(a), dtype=dt, device=device)
        intersector, dbvh, tri_v = "cluster", None, ()
        if scene.tri_cw is None and scene.n_tris:
            from arendur_tpu_torch.accel import bvh as bvhmod
            if scene.bvh is not None:
                intersector = "bvh"
                dbvh = bvhmod.device_bvh(scene.bvh, scene.tri_v0,
                                         scene.tri_v1, scene.tri_v2, device)
            else:
                intersector = "naive"
                tri_v = tuple(t(v) for v in (scene.tri_v0, scene.tri_v1,
                                             scene.tri_v2))
        if scene.tri_cw is None:
            # no cluster (an empty world pool, or world triangles met by
            # the BVH walk or the brute force): K1 / K2 test the spheres
            # alone; a slot is never >= 0, so the remap is never read
            cw = np.zeros((0, 16, 4 * 64), np.float32)
            cbox = np.zeros((0, 8), np.float32)
            remap = np.full(1, -1, np.int64)
        else:
            cw, cbox, remap = scene.tri_cw, scene.tri_cbox, scene.tri_remap
        inst, base = [], scene.n_tris + scene.spheres.count
        for im in scene.inst:
            inst.append(DeviceInstances(
                cw=t(im.cw), cbox=t(im.cbox), remap=t(im.remap, torch.int64),
                attr=t(im.attr), o2w=t(im.o2w), w2o=t(im.w2o),
                nrm=t(im.nrm), prim_base=int(base),
                itab=t(instance_table(im.cbox, im.w2o))))
            base += im.attr.shape[0]
        ltab, _, _ = light_pack(scene)
        dist = scene.light_distribution
        return DeviceScene(
            device=device, n_tris=int(scene.n_tris),
            cw=t(cw), cbox=t(cbox), remap=t(remap, torch.int64),
            tpack=t(tri_pack(scene)), ltab=t(ltab),
            mtab=t(mats.param_table(scene.materials)),
            stab=t(sph.shade_table(scene.spheres)),
            ktab=t(sph.kernel_table(scene.spheres)),
            full_phi=bool(scene.spheres.phi_full),
            light_cdf=t(dist.cdf), light_func=t(dist.func),
            light_func_int=float(dist.func_int),
            static=shade_static(scene), materials=scene.materials,
            emission_textured=bool(etex is not None
                                   and (np.asarray(etex) >= 0).any()),
            inst=tuple(inst), intersector=intersector, bvh=dbvh,
            tri_v=tri_v)


# ---------------------------------------------------------------------------
# the closest hit over the world pool, the spheres and the instanced meshes
# ---------------------------------------------------------------------------

def affine(m, p, point: bool = True):
    """Components p (x, y, z) through row-vector matrices m [..., 4, 4]:
    x m[0] + y m[1] + z m[2], plus the translation row m[3] for a point
    (the projective column is not read, as the JAX package's instanced
    path reads only the linear part and row 3).  m's leading dimensions
    broadcast against the components'."""
    x, y, z = p
    out = tuple(x * m[..., 0, k] + y * m[..., 1, k] + z * m[..., 2, k]
                for k in range(3))
    if point:
        out = tuple(out[k] + m[..., 3, k] for k in range(3))
    return out


# the world box's margin: a share of its extent and of the magnitude of
# its coordinates, so that the world-frame cull stays conservative
# against the local test's other rounding
BOX_MARGIN = 1e-4


def instance_table(cbox, w2o) -> np.ndarray:
    """[I, 20] one row per instance for the instanced kernels
    (kernels/intersect.cuh ITAB_COLS): w2o's rows 0-3, columns x, y, z
    (the linear part, then the translation: the map the rays take), then
    the instance's world box, min xyz and max xyz, then two zeros.  The
    box holds the mesh's local box (the union of its cluster boxes)
    through the inverse of that map (o2w where the transform is affine),
    its 8 corners in float64, widened by BOX_MARGIN (extent + the
    largest |coordinate| + 1) on every side and rounded outward; a
    singular instance gets a box of +-1e30 (never culled)."""
    cbox = np.asarray(cbox, np.float64)
    w2o = np.asarray(w2o, np.float32)
    lo, hi = cbox[:, 0:3].min(0), cbox[:, 3:6].max(0)
    corners = np.array([[(lo, hi)[(k >> a) & 1][a] for a in range(3)]
                        for k in range(8)])
    rows = np.zeros((w2o.shape[0], 20), np.float32)
    rows[:, 0:12] = w2o[:, :, :3].reshape(-1, 12)
    for i, m in enumerate(w2o.astype(np.float64)):
        with np.errstate(all="ignore"):
            try:
                world = (corners - m[3, :3]) @ np.linalg.inv(m[:3, :3])
            except np.linalg.LinAlgError:
                world = np.full((1, 3), np.nan)
        if not np.isfinite(world).all():
            rows[i, 12:18] = (-1e30,) * 3 + (1e30,) * 3
            continue
        wlo, whi = world.min(0), world.max(0)
        pad = BOX_MARGIN * ((whi - wlo).max() + np.abs(world).max() + 1.0)
        rows[i, 12:15] = np.nextafter((wlo - pad).astype(np.float32),
                                      np.float32(-np.inf))
        rows[i, 15:18] = np.nextafter((whi + pad).astype(np.float32),
                                      np.float32(np.inf))
    return rows


def instance_rays(im: DeviceInstances, o, d):
    """Rays o, d [N,3] in each instance's frame: (o, d) [I * N, 3], lane
    i * N + n ray n in instance i's frame (twin: the ol / dl of
    scene.intersect, scene.py:952-956), by scene.affine's products and
    sums: the instanced kernels' local rays to the bit.  For the
    [I * N]-lane launches (period N), which no scene query makes."""
    from arendur_tpu_torch.shapes import cluster_intersect as ci
    ol, dl = ci.instance_frame(im.itab[:, None], o[None], d[None])
    return ol.reshape(-1, 3), dl.reshape(-1, 3)


def instance_closest(im: DeviceInstances, o, d, bound, n_alive=None,
                     closest_hit_instanced=None):
    """The closest hit of N rays o, d [N,3] against every instance of one
    instanced mesh, bounded by `bound` [N]: one launch of the instanced
    K1 (or the given entry), which takes each ray into the instances'
    frames and keeps the instance with the least t (the first at equal
    t).  Returns (t [N], inf where no instance is hit, local triangle id
    [N] int64 or -1, instance [N] int64, 0 on a miss)."""
    from arendur_tpu_torch.shapes import cluster_intersect as ci
    t, slot, inst = (closest_hit_instanced or ci.intersect_instanced)(
        im.cw, im.cbox, im.itab, o, d, bound, n_alive)
    li = torch.where(slot >= 0, im.remap[torch.clamp(slot, min=0).long()],
                     -1)
    return torch.where(li >= 0, t, float("inf")), li, inst.long()


@dataclasses.dataclass(frozen=True, eq=False)
class Closest:
    """The closest hit of N rays over the whole scene before any shading
    (twin: the shared first half of scene.intersect / intersect_raw under
    ARENDUR_SPHERES=kernel)."""
    t_k: torch.Tensor       # [N] the world K1's t (its tmax on a miss)
    slot: torch.Tensor      # [N] the world K1's slot / sphere code
    tri_idx: torch.Tensor   # [N] int64 world triangle, -1 = none
    t_tri: torch.Tensor     # [N] the nearest triangle hit's t, inf = none
    tri_hit: torch.Tensor   # [N] bool: some triangle, world or instanced
    wins: tuple             # per instanced mesh: (mesh, hit [N] bool: it
                            # holds the nearest triangle, local triangle
                            # id [N], instance [N]); a later mesh's
                            # win replaces an earlier one's
    use_sphere: torch.Tensor  # [N] bool: a sphere is the closest hit
    b0: Optional[torch.Tensor] = None  # [N] the world triangle's
    b1: Optional[torch.Tensor] = None  # barycentrics, from the BVH walk
                                       # or the brute force (None: the
                                       # cluster kernels give none)

    @property
    def hit(self):
        return self.tri_hit | self.use_sphere

    @property
    def t(self):
        """[N] the closest hit's t, inf on a miss."""
        return torch.where(self.hit, torch.where(self.use_sphere, self.t_k,
                                                 self.t_tri), float("inf"))


def _pad_rows(x, n: int, fill):
    """x [na, ...] padded to n rows with `fill`."""
    if x.shape[0] == n:
        return x
    return torch.cat([x, torch.full((n - x.shape[0],) + x.shape[1:], fill,
                                    dtype=x.dtype, device=x.device)])


def world_closest(scene: DeviceScene, o, d, tmax, n_alive=None):
    """The closest world triangle of N rays by the scene's BVH walk or
    brute force (twin: the bvh / naive branches of scene.intersect,
    scene.py:891-895): (t [N], inf on a miss, tri_idx [N] int64 or -1,
    b0, b1).  Only the first n_alive rays are traced (one host read of
    the count); the rest miss, as the cluster kernels report them."""
    from arendur_tpu_torch.accel import bvh as bvhmod
    from arendur_tpu_torch.shapes import triangle as tri
    n = o.shape[0]
    na = n if n_alive is None else int(n_alive)
    o, d, tmax = o[:na], d[:na], tmax[:na]
    if scene.intersector == "bvh":
        t, idx, b0, b1 = bvhmod.intersect_bvh(scene.bvh, o, d, tmax)
    else:
        t, idx, b0, b1 = tri.intersect_scene_tris(o, d, tmax, *scene.tri_v)
    t = torch.where(idx >= 0, t, float("inf"))
    return (_pad_rows(t, n, float("inf")), _pad_rows(idx, n, -1),
            _pad_rows(b0, n, 0.0), _pad_rows(b1, n, 0.0))


def world_occluded(scene: DeviceScene, o, d, tmax, n_alive=None):
    """Whether a world triangle blocks each shadow ray within tmax, by
    the BVH walk (a closest hit, as the JAX package's occluded runs it)
    or the brute force; rays past n_alive are not blocked."""
    from arendur_tpu_torch.shapes import triangle as tri
    if scene.intersector == "bvh":
        return world_closest(scene, o, d, tmax, n_alive)[1] >= 0
    n = o.shape[0]
    na = n if n_alive is None else int(n_alive)
    return _pad_rows(tri.occluded_tris(o[:na], d[:na], tmax[:na],
                                       *scene.tri_v), n, False)


def closest_hits(scene: DeviceScene, o, d, tmax, n_alive=None,
                 closest_hit=None, closest_hit_instanced=None) -> Closest:
    """The closest hit of N rays o, d [N,3] within tmax [N], in the JAX
    package's order of operations (scene.py:932-1012): the world K1 with
    the sphere table (a sphere hit keeps the triangles' t at inf), then
    each instanced mesh's instanced K1 bounded by min(tmax, t_tri),
    then a sphere wins where its t <= the nearest triangle's.  Where the
    world triangles have no cluster tables, the BVH walk or the brute
    force finds the nearest of them and K1 with no cluster tests the
    spheres.  Ray geometry is detached."""
    from arendur_tpu_torch.shapes import cluster_intersect as ci
    o, d, tmax = o.detach(), d.detach(), tmax.detach()
    t_k, slot = (closest_hit or ci.intersect_clusters)(
        scene.cw, scene.cbox, o, d, tmax, n_alive=n_alive,
        sph_tab=scene.ktab, full_phi=scene.full_phi)
    b0 = b1 = None
    if scene.intersector == "cluster":
        tri_hit = slot >= 0
        t_tri = torch.where(tri_hit, t_k, float("inf"))
        tri_idx = torch.where(
            tri_hit, scene.remap[torch.clamp(slot, min=0).long()], -1)
    else:
        t_tri, tri_idx, b0, b1 = world_closest(scene, o, d, tmax, n_alive)
        tri_hit = tri_idx >= 0
    wins = []
    for im in scene.inst:
        t_i, li, best = instance_closest(im, o, d, torch.minimum(tmax, t_tri),
                                         n_alive, closest_hit_instanced)
        hit_i = (li >= 0) & (t_i < t_tri) & torch.isfinite(t_i)
        t_tri = torch.where(hit_i, t_i, t_tri)
        tri_hit = tri_hit | hit_i
        wins.append((im, hit_i, li, best))
    use_sphere = (slot <= -2) & (t_k <= t_tri)
    return Closest(t_k=t_k, slot=slot, tri_idx=tri_idx, t_tri=t_tri,
                   tri_hit=tri_hit, wins=tuple(wins), use_sphere=use_sphere,
                   b0=b0, b1=b1)


def instance_world_rows(im: DeviceInstances, li, best) -> torch.Tensor:
    """[N,26] the winning instance's triangle row in world space (twin:
    the trow_w of scene.intersect_raw, scene.py:788-809): vertices by
    o2w, normals by the inverse-transpose, uv and material as stored,
    light -1; the bounce shade reads it as it reads a world row."""
    irow = im.attr[torch.clamp(li, min=0)]
    o2w, nrm = im.o2w[best], im.nrm[best]
    col = lambda j: irow[:, j]  # noqa: E731
    tp = lambda j: affine(o2w, (col(j), col(j + 1), col(j + 2)))  # noqa
    tn = lambda j: affine(nrm, (col(j), col(j + 1), col(j + 2)),  # noqa
                          point=False)
    parts = [c for j in (0, 3, 6) for c in tp(j)] \
        + [c for j in (9, 12, 15) for c in tn(j)]
    return torch.cat([torch.stack(parts, -1), irow[:, 18:25],
                      torch.full_like(irow[:, 25:26], -1.0)], 1)


# ---------------------------------------------------------------------------
# the full closest hit and the emission profile (the composed bounce)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class Hit:
    """Wavefront surface-interaction record (twin: scene.Hit)."""
    hit: torch.Tensor       # [N] bool
    t: torch.Tensor         # [N], inf on misses
    prim: torch.Tensor      # [N] int64, -1 = miss
    pos: torch.Tensor       # [N,3]
    pos_err: torch.Tensor   # [N,3]
    ng: torch.Tensor        # [N,3] geometric normal
    ns: torch.Tensor        # [N,3] shading normal (toward ng)
    dpdu: torch.Tensor      # [N,3]
    dpdv: torch.Tensor      # [N,3]
    uv: torch.Tensor        # [N,2]
    mat_id: torch.Tensor    # [N] int32
    light_id: torch.Tensor  # [N] int32 (-1 if not emissive)


def sphere_uv(p, radius, thetamin, thetamax, phimax):
    """(u, v) at local sphere points p [N,3] (twin: the uv of
    sphere._local_duv, sphere.rs:248-277: polynomial atan2, acos)."""
    from arendur_tpu_torch.render import cmath as cm
    phi = cm.atan2_poly(p[:, 1], p[:, 0])
    phi = torch.where(phi < 0.0, phi + 2.0 * np.pi, phi)
    theta = torch.acos(torch.clamp(p[:, 2] / radius, -1.0 + 1e-7,
                                   1.0 - 1e-7))
    return phi / phimax, (theta - thetamin) / (thetamax - thetamin), theta


def sphere_hit_info(stab: torch.Tensor, s_idx, p_local):
    """Shading info of sphere hits from the shade-table rows (twin:
    sphere.sphere_hit_info): (pos, ng, uv, dpdu, dpdv, pos_err)."""
    from arendur_tpu_torch.render import cmath as cm
    row = stab[s_idx.long()]
    radius, phimax = row[:, 16], row[:, 19]
    thetamin, thetamax = row[:, 17], row[:, 18]
    u, v, theta = sphere_uv(p_local, radius, thetamin, thetamax, phimax)
    p = p_local
    inv_zr = 1.0 / torch.sqrt(torch.clamp(p[:, 0] ** 2 + p[:, 1] ** 2,
                                          min=1e-30))
    cphi, sphi = p[:, 0] * inv_zr, p[:, 1] * inv_zr
    dpdu_l = (-phimax * p[:, 1], phimax * p[:, 0], torch.zeros_like(u))
    dt = thetamax - thetamin
    dpdv_l = (dt * (p[:, 2] * cphi), dt * (p[:, 2] * sphi),
              dt * (-radius * torch.sin(theta)))
    o2w = tuple(row[:, j] for j in range(16))
    st = lambda c: torch.stack(c, -1)
    pos = st(cm.tp16(o2w, (p[:, 0], p[:, 1], p[:, 2])))
    dpdu = cm.tv16(o2w, dpdu_l)
    dpdv = cm.tv16(o2w, dpdv_l)
    ng = st(cm.vnormalize(cm.vcross(dpdu, dpdv)))
    pos_err = pos.abs() * (5.0 * 2.0 ** -24)
    return pos, ng, torch.stack([u, v], -1), st(dpdu), st(dpdv), pos_err


def _instance_shading(im: DeviceInstances, o, d, li, best):
    """The winning instance's hit in world space (twin: the instanced
    block of scene.intersect, scene.py:963-1002): the local ray and
    triangle row give barycentrics and shading info, which go back to
    world space: (pos, pos_err, uv, dpdu, dpdv, ng, ns) as component
    tuples (uv as (u, v)), the shading normal turned toward ng."""
    from arendur_tpu_torch.render import cbounce as cb
    from arendur_tpu_torch.render import cmath as cm
    w2o, o2w, nrm = im.w2o[best], im.o2w[best], im.nrm[best]
    ol = affine(w2o, o.unbind(-1))
    dl = affine(w2o, d.unbind(-1), point=False)
    irow = im.attr[torch.clamp(li, min=0)]
    col = lambda j: irow[:, j]  # noqa: E731
    b0, b1 = cb.bary_from_vertices(ol, dl, (col(0), col(1), col(2)),
                                   (col(3), col(4), col(5)),
                                   (col(6), col(7), col(8)))
    pos_l, perr_l, dpdu_l, dpdv_l, ns_l = cb.tri_shading_from_row(col, b0,
                                                                  b1)
    b2 = 1.0 - b0 - b1
    uv = (b0 * col(18) + b1 * col(20) + b2 * col(22),
          b0 * col(19) + b1 * col(21) + b2 * col(23))
    pos = affine(o2w, pos_l)
    dpdu = affine(o2w, dpdu_l, point=False)
    dpdv = affine(o2w, dpdv_l, point=False)
    ng = cm.vnormalize(cm.vcross(dpdu, dpdv))
    ns = cm.vnormalize(affine(nrm, ns_l, point=False))
    ns = cm.vwhere(cm.vdot(ns, ng) < 0.0, cm.vneg(ns), ns)
    perr = cm.vadd(affine(o2w[:, :3, :3].abs(), perr_l, point=False),
                   cm.vscale(cm.vabs(pos), 1e-7))
    return pos, perr, uv, dpdu, dpdv, ng, ns


def intersect(scene: "DeviceScene", o, d, tmax=None, n_alive=None,
              closest_hit=None, closest_hit_instanced=None) -> Hit:
    """Closest hit of N rays against the scene with full shading info
    (twin: scene.intersect under ARENDUR_SPHERES=kernel): the closest
    hit over the world's triangle clusters and the analytic spheres in
    one call (K1 on CUDA tensors, or the given `closest_hit` entry), one
    more per instanced mesh (closest_hits: the instanced K1, or the
    given `closest_hit_instanced`), then the hit record, with
    benign defaults on miss lanes.  The ray geometry is detached, as in
    the JAX package."""
    from arendur_tpu_torch.render import cbounce as cb
    from arendur_tpu_torch.render import cmath as cm
    o, d = o.detach(), d.detach()
    n = o.shape[0]
    if tmax is None:
        tmax = torch.full((n,), float("inf"), device=o.device)
    c = closest_hits(scene, o, d, tmax, n_alive, closest_hit,
                     closest_hit_instanced)
    trow = scene.tpack[torch.clamp(c.tri_idx, min=0)]
    tcol = lambda j: trow[:, j]
    oc = (o[:, 0], o[:, 1], o[:, 2])
    dc = (d[:, 0], d[:, 1], d[:, 2])
    if c.b0 is None:
        # the cluster kernels give no barycentrics: from the packed
        # vertices (the JAX package's cluster branch)
        b0, b1 = cb.bary_from_vertices(oc, dc, (tcol(0), tcol(1), tcol(2)),
                                       (tcol(3), tcol(4), tcol(5)),
                                       (tcol(6), tcol(7), tcol(8)))
    else:
        b0, b1 = c.b0, c.b1
    pos_t, perr_t, dpdu_t, dpdv_t, ns_raw = cb.tri_shading_from_row(
        tcol, b0, b1)
    b2 = 1.0 - b0 - b1
    uv_t = (b0 * tcol(18) + b1 * tcol(20) + b2 * tcol(22),
            b0 * tcol(19) + b1 * tcol(21) + b2 * tcol(23))
    ng_t = cm.vnormalize(cm.vcross(dpdu_t, dpdv_t))
    # the shading normal turned toward the geometric one (ref:
    # interaction.rs:167-181)
    ns_t = cm.vwhere(cm.vdot(ns_raw, ng_t) < 0.0, cm.vneg(ns_raw), ns_raw)
    tri = [pos_t, perr_t, uv_t, dpdu_t, dpdv_t, ng_t, ns_t]
    mat_t, light_t, prim_t = tcol(24), tcol(25), c.tri_idx
    for im, hit_i, li, best in c.wins:
        got = _instance_shading(im, o, d, li, best)
        tri = [tuple(torch.where(hit_i, a, b) for a, b in zip(x, y))
               for x, y in zip(got, tri)]
        mat_t = torch.where(hit_i, im.attr[torch.clamp(li, min=0), 24],
                            mat_t)
        light_t = torch.where(hit_i, -1.0, light_t)
        prim_t = torch.where(hit_i, im.prim_base + li, prim_t)
    st = lambda v: torch.stack(v, -1)
    pos_t, perr_t, uv_t, dpdu_t, dpdv_t, ng_t, ns_t = (st(v) for v in tri)

    use_sphere = c.use_sphere
    p_local, s_idx = sph.hit_p_local(scene.ktab, c.slot, o, d, c.t_k)
    pos_s, ng_s, uv_s, dpdu_s, dpdv_s, perr_s = sphere_hit_info(
        scene.stab, s_idx, p_local)
    srow = scene.stab[s_idx]
    hit = c.hit
    pick = lambda a, b: torch.where(use_sphere[:, None], a, b)
    hm = hit[:, None]
    z = torch.zeros_like(o)
    axis = lambda j: z + torch.eye(3, device=o.device)[j]
    return Hit(
        hit=hit,
        t=c.t,
        prim=torch.where(hit, torch.where(use_sphere, scene.n_tris + s_idx,
                                          prim_t), -1),
        pos=torch.where(hm, pick(pos_s, pos_t), 0.0),
        pos_err=torch.where(hm, pick(perr_s, perr_t), 0.0),
        ng=torch.where(hm, pick(ng_s, ng_t), axis(2)),
        ns=torch.where(hm, pick(ng_s, ns_t), axis(2)),
        dpdu=torch.where(hm, pick(dpdu_s, dpdu_t), axis(0)),
        dpdv=torch.where(hm, pick(dpdv_s, dpdv_t), axis(1)),
        uv=torch.where(hm, pick(uv_s, uv_t), 0.0),
        mat_id=torch.where(hit, torch.where(use_sphere, srow[:, 20],
                                            mat_t), 0.0).to(torch.int32),
        light_id=torch.where(hit, torch.where(use_sphere, srow[:, 21],
                                              light_t), -1.0).to(torch.int32))


def occluded(scene: "DeviceScene", o, d, tmax, n_alive=None,
             any_hit=None, any_hit_instanced=None) -> torch.Tensor:
    """Shadow any-hit against the world's triangles and the spheres in
    one call (K2 on CUDA tensors, or the given `any_hit` entry; where the
    world has no cluster tables, K2 tests the spheres and world_occluded
    the triangles), then one instanced K2 (or the given
    `any_hit_instanced` entry) per instanced mesh, which starts from the
    flags so far: a ray already blocked costs it nothing.  The ray
    geometry is detached (twin: scene.occluded under
    ARENDUR_SPHERES=kernel)."""
    from arendur_tpu_torch.shapes import cluster_intersect as ci
    any_hit = any_hit or ci.occluded_clusters
    any_hit_instanced = any_hit_instanced or ci.occluded_instanced
    o, d, tmax = o.detach(), d.detach(), tmax.detach()
    blocked = any_hit(scene.cw, scene.cbox, o, d, tmax, n_alive=n_alive,
                      sph_tab=scene.ktab, full_phi=scene.full_phi)
    if scene.intersector != "cluster":
        blocked = blocked | world_occluded(scene, o, d, tmax, n_alive)
    for im in scene.inst:
        blocked = any_hit_instanced(im.cw, im.cbox, im.itab, o, d, tmax,
                                    n_alive, blocked)
    return blocked


def _light_cols(scene: "DeviceScene", name: str) -> slice:
    lo, hi = dict(scene.static.lcidx)[name]
    return slice(lo, hi)


def emission_tex_factor(scene: "DeviceScene", lidx, uv, textures=None):
    """The emission-profile texture of light lidx [N] at uv [N,2]
    (white where the light has none; twin: scene.emission_tex_factor,
    ref: component/shape.rs:115-129)."""
    ones = torch.ones(uv.shape[0], 3, device=uv.device)
    if textures is None:
        return ones
    from arendur_tpu_torch.texturing.texture import eval_rgb
    tex_id = scene.ltab[torch.clamp(lidx, min=0).long(),
                        _light_cols(scene, "emission_tex")]
    return eval_rgb(textures, tex_id[:, 0].to(torch.int32), uv, ones)


def light_emission(scene: "DeviceScene", lidx, uv, textures=None):
    """Emitted radiance of light lidx [N] at surface uv [N,2]: the
    constant part times the emission-profile texture (twin:
    scene.light_emission)."""
    em = scene.ltab[torch.clamp(lidx, min=0).long(),
                    _light_cols(scene, "emission")]
    if textures is None:
        return em
    return em * emission_tex_factor(scene, lidx, uv, textures)
