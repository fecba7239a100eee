"""Write examples/cornellbox/cb_inst.json: the Cornell box of cb.json
placed 100 times on a 10 x 10 grid by mesh instancing.

    python tools/make_cb_inst.py [--out PATH] [--departure]

One "Mesh" component (CornellBox-Glossy.obj, 1,112 triangles) and 99
"Transformed" entries over it make one instanced mesh of I = 100
placements of one shared copy (111,200 instanced triangles); each cell's
two sphere lights (cb.json's materials and radiance) are "Transformed"
copies too (200 spheres).  The world pool holds no triangle.  The camera
is cb.json's, pulled back so that the grid fills the frame.  cb.json's
camera sits between its box and its two spheres; a camera pulled back
would see the spheres in front of every box, so here they hang inside
the box's upper half, shrunk to SPHERE_RADIUS.

cb.json's box transform has a 1 in column 3 of row 1: baking a mesh
(SceneBuilder.add_mesh) divides by w, while an instanced mesh reads
only the linear part and the translation row (both packages).  The grid
therefore uses the affine part of that transform.  --departure prints
how far one "Transformed" placement of cb.json's own box lies from the
same box baked: the largest distance between a vertex baked with the
divide and the same vertex through the affine part, and the box's
extent, both in scene units.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CB = os.path.join(REPO, "examples/cornellbox/cb.json")
OUT = os.path.join(REPO, "examples/cornellbox/cb_inst.json")
GRID = 10          # cells a side
STEP = 5.0         # scene units between cells
CAMERA_Z = -45.0   # the camera's distance back from cb.json's
SPHERE_RADIUS = 0.35
SPHERE_AT = {"light_sphere": (-1.0, 0.9, 3.4),   # inside the box
             "blue_sphere": (1.0, 0.9, 3.8)}


def _translate(x, y, z=0.0):
    m = np.eye(4)
    m[3, :3] = (x, y, z)
    return m.tolist()


def scene_desc() -> dict:
    with open(CB) as f:
        desc = json.load(f)
    comps = desc["components"]
    box = comps[0]["value"]["Mesh"]
    # the affine part of cb.json's box transform (column 3 of rows 0-2
    # zeroed; row 3, the translation, kept)
    rows = box["transform"]
    box["transform"] = [[r[0], r[1], r[2], 0.0] for r in rows[:3]] + [rows[3]]
    for c in comps[1:]:
        shaped = c["value"]["Shaped"]
        shaped["shape"]["Sphere"]["radius"] = SPHERE_RADIUS
        shaped["transform"]["w"] = list(SPHERE_AT[c["name"]]) + [1.0]
    names = [c["name"] for c in comps]
    for i in range(GRID * GRID):
        if i == 0:
            continue   # the originals are cell (0, 0)
        t = _translate(STEP * (i % GRID), STEP * (i // GRID))
        for name in names:
            comps.append({"name": f"{name}_{i}", "value": {"Transformed": {
                "original": name, "transform": t}}})
    center = STEP * (GRID - 1) / 2.0
    desc["camera"]["transform"] = _translate(-center, -center, -CAMERA_Z)
    desc["outputfilename"] = "./examples/cornellbox/cb_inst_out.png"
    return desc


def departure():
    """(largest |baked - affine| over the box's vertices, box extent)."""
    import sys
    sys.path.insert(0, REPO)
    from arendur_tpu_torch.io.objloader import parse_obj
    with open(CB) as f:
        m = np.asarray(json.load(f)["components"][0]["value"]["Mesh"]
                       ["transform"], np.float32)
    v = np.concatenate([g.vertices for g in parse_obj(os.path.join(
        REPO, "examples/cornellbox/CornellBox-Glossy.obj"))])
    h = v @ m[:3, :3] + m[3, :3]
    baked = h / (v @ m[:3, 3] + m[3, 3])[:, None]
    gap = np.linalg.norm(baked - h, axis=-1)
    return float(gap.max()), float(np.linalg.norm(h.max(0) - h.min(0)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--departure", action="store_true")
    args = ap.parse_args(argv)
    desc = scene_desc()
    comps = desc.pop("components")
    text = json.dumps(desc, indent=1)
    # one component a line
    text = text[:-2] + ',\n "components": [\n  ' + ",\n  ".join(
        json.dumps(c) for c in comps) + "\n ]\n}\n"
    json.loads(text)
    with open(args.out, "w") as f:
        f.write(text)
    print(f"wrote {args.out}")
    if args.departure:
        gap, extent = departure()
        print(f"cb.json's box, Transformed (affine part) vs baked (divide "
              f"by w): largest vertex distance {gap:.4f}, box diagonal "
              f"{extent:.4f} scene units")


if __name__ == "__main__":
    main()
