"""Write a Cornell box that holds a mesh of about a million triangles: a
scanned-object stand-in for the port's scene load and its K1 / K2 at
thousands of clusters.

    python tools/make_big_mesh.py OUT_DIR [--tris N] [--seed S]

The box's short box (the ``shortBox`` group of
examples/cornellbox/CornellBox-Glossy.obj, 12 triangles) is replaced by
a displaced tessellated sphere standing on the floor where the box
stood, in the box's material: a UV sphere of R rings and 2R segments
(4 R (R - 1) triangles, the largest R with at most N; the default
N = 1,000,000 gives R = 500, 998,000 triangles, 499,002 vertices), its
radius displaced by a seeded sum of smooth bumps and a fine ripple, so
that its triangles are neither flat nor alike.  Written into OUT_DIR:

* ``big_mesh.obj``: the box's other groups as they are, then the
  sphere's vertices and faces;
* ``big_mesh.mtl``: the box's materials;
* ``big_mesh.json``: cb.json (the same lights, camera and settings) with
  the mesh's path pointing at big_mesh.obj, absolute, so the scene loads
  from any directory.

NumPy only, deterministic in --seed, nothing downloaded; nothing it
writes is meant to be committed.  Prints the JSON's path.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CB_DIR = os.path.join(REPO, "examples/cornellbox")
OBJ = os.path.join(CB_DIR, "CornellBox-Glossy.obj")
MTL = os.path.join(CB_DIR, "CornellBox-Glossy.mtl")
CB = os.path.join(CB_DIR, "cb.json")
REPLACED = "shortBox"
# in the obj's units: the short box's footprint centre and a radius that
# stays inside it (the box spans x [-0.87, 0.15], z [-0.49, 0.53])
CENTER_XZ = (-0.36, 0.02)
RADIUS = 0.38
BUMPS = 8          # smooth displacement terms
BUMP_AMP = 0.12    # their summed amplitude, relative to the radius
RIPPLE_AMP = 0.01  # the fine ripple's, relative to the radius


def rings_for(tris: int) -> int:
    """The largest ring count R with 4 R (R - 1) <= tris (R >= 3)."""
    r = int((1 + np.sqrt(1 + tris)) / 2)
    while 4 * r * (r - 1) > tris:
        r -= 1
    return max(r, 3)


def sphere_mesh(rings: int, seed: int):
    """(vertices [V, 3] f64, faces [F, 3] int64, 0-based) of the displaced
    UV sphere: two poles and rings - 1 latitude rings of 2 * rings
    vertices each, fans at the poles and two triangles per quad."""
    rng = np.random.default_rng(seed)
    seg = 2 * rings
    theta = np.pi * np.arange(1, rings) / rings             # [R-1]
    phi = 2.0 * np.pi * np.arange(seg) / seg                 # [S]
    th, ph = np.meshgrid(theta, phi, indexing="ij")          # [R-1, S]
    th = np.concatenate([[0.0], th.ravel(), [np.pi]])
    ph = np.concatenate([[0.0], ph.ravel(), [0.0]])
    # smooth bumps: sums of seeded spherical-ish harmonics
    disp = np.zeros_like(th)
    m = rng.integers(1, 7, BUMPS)
    l = rng.integers(1, 7, BUMPS)
    a = rng.uniform(-1.0, 1.0, BUMPS)
    p = rng.uniform(0.0, 2.0 * np.pi, (BUMPS, 2))
    for k in range(BUMPS):
        disp += a[k] * np.sin(m[k] * ph + p[k, 0]) \
            * np.sin(l[k] * th + p[k, 1]) * np.sin(th)
    disp *= BUMP_AMP / np.abs(a).sum()
    disp += RIPPLE_AMP * np.sin(40.0 * ph) * np.sin(37.0 * th) * np.sin(th)
    r = RADIUS * (1.0 + disp)
    st = np.sin(th)
    v = np.stack([r * st * np.cos(ph), -r * np.cos(th), r * st * np.sin(ph)],
                 -1)
    # stand on the floor (y = 0) at the box's footprint
    v[:, 1] -= v[:, 1].min()
    v[:, 0] += CENTER_XZ[0]
    v[:, 2] += CENTER_XZ[1]

    nv = v.shape[0]
    ring = lambda i: 1 + i * seg + np.arange(seg)  # noqa: E731
    nxt = lambda idx: np.roll(idx, -1)             # noqa: E731
    top = np.stack([np.zeros(seg, np.int64), nxt(ring(0)), ring(0)], -1)
    last = ring(rings - 2)
    bottom = np.stack([np.full(seg, nv - 1), last, nxt(last)], -1)
    quads = []
    for i in range(rings - 2):
        a0, b0 = ring(i), ring(i + 1)
        a1, b1 = nxt(a0), nxt(b0)
        quads.append(np.stack([a0, a1, b1], -1))
        quads.append(np.stack([a0, b1, b0], -1))
    faces = np.concatenate([top] + quads + [bottom], 0)
    return v, faces


def write(out_dir: str, tris: int = 1_000_000, seed: int = 0) -> str:
    """Write the scene into out_dir; returns the JSON's path."""
    os.makedirs(out_dir, exist_ok=True)
    obj_path = os.path.join(out_dir, "big_mesh.obj")
    with open(OBJ) as f:
        lines = f.read().splitlines()
    kept, group, n_v = [], None, 0
    for line in lines:
        parts = line.split()
        key = parts[0] if parts else ""
        if key in ("g", "o"):
            group = parts[1] if len(parts) > 1 else ""
        if key == "mtllib":
            line = "mtllib big_mesh.mtl"
        n_v += key == "v"
        # the replaced group's faces and its group lines go; every
        # vertex stays, so the other groups' indices hold
        if group == REPLACED and key in ("f", "g", "o", "usemtl", "s"):
            continue
        kept.append(line)
    v, faces = sphere_mesh(rings_for(tris), seed)
    with open(obj_path, "w") as f:
        f.write("\n".join(kept))
        f.write(f"\n# a displaced sphere of {len(faces)} triangles "
                f"(tools/make_big_mesh.py --seed {seed})\n"
                f"g bigMesh\nusemtl {REPLACED}\n")
        f.write("\n".join(f"v {x:.6f} {y:.6f} {z:.6f}"
                          for x, y, z in v.tolist()))
        f.write("\n")
        fi = faces + 1 + n_v
        f.write("\n".join(f"f {a} {b} {c}" for a, b, c in fi.tolist()))
        f.write("\n")
    with open(MTL) as f:
        mtl = f.read()
    with open(os.path.join(out_dir, "big_mesh.mtl"), "w") as f:
        f.write(mtl)
    with open(CB) as f:
        desc = json.load(f)
    desc["components"][0]["value"]["Mesh"]["filename"] = \
        os.path.abspath(obj_path)
    desc["outputfilename"] = "big_mesh_out.png"
    path = os.path.join(out_dir, "big_mesh.json")
    with open(path, "w") as f:
        json.dump(desc, f)
    return path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out_dir")
    ap.add_argument("--tris", type=int, default=1_000_000,
                    help="at most this many triangles in the sphere")
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    print(write(a.out_dir, a.tris, a.seed))


if __name__ == "__main__":
    main()
