"""Write scenes past the shared-memory sizes the port's kernels stage
whole: many small sphere lights in the Cornell box, or cb_inst.json's
box placed on a larger grid.

    python tools/make_cb_big_tables.py OUT.json [--spheres N]
        [--materials M] [--lights K] [--radius R] [--seed S]
    python tools/make_cb_big_tables.py OUT.json --grid G

The first form writes cb.json plus N small spheres (default 2,500,
radius 0.03) at seeded places inside the box, sharing M new matte
materials (default 48, seeded kd) round robin; the first K of them
(default all) are sphere lights of seeded warm radiance, the others
plain matte balls.  With the defaults the scene's tables are
ltab [2502, 53], mtab [57, 16] and ktab [2502, 24]: past what K1 / K2
held in shared memory before they staged a table in chunks (2,250
spheres) and past what K3-K6 stage whole (kernels/ops.py stage_plan),
as users who light a room with strings of small lights or an LED wall
build it.

The second form writes cb_inst.json's scene (tools/make_cb_inst.py)
with the box and its two sphere lights placed on a G x G grid (G = 17:
289 instances, past the instanced kernel's 256 staged instance rows,
and 578 sphere lights), the camera pulled back so that the grid fills
the frame.

The mesh's path is written absolute, so the scene loads from any
directory; nothing it writes is meant to be committed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import make_cb_inst as mci  # noqa: E402

OBJ = os.path.join(REPO, "examples/cornellbox/CornellBox-Glossy.obj")
# the box's inside, in scene units, kept clear of its walls
INSIDE_LO = (-1.8, -1.3, 1.5)
INSIDE_HI = (1.8, 0.45, 5.8)


def _cb_desc() -> dict:
    with open(mci.CB) as f:
        desc = json.load(f)
    desc["components"][0]["value"]["Mesh"]["filename"] = OBJ
    return desc


def _matte(name, kd, sigma=0.0) -> dict:
    return {"name": name, "value": {"Matte": {
        "kd": {"name": name + "_kd", "value": {"Constant": {
            "value": {"inner": [float(c) for c in kd]}}}},
        "sigma": {"name": name + "_sigma", "value": {"Constant": {
            "value": float(sigma)}}}}}}


def lights_desc(spheres: int = 2500, materials: int = 48,
                lights: int = None, radius: float = 0.03,
                seed: int = 0) -> dict:
    """cb.json plus `spheres` small spheres over `materials` new matte
    materials, the first `lights` (all where None) emitting."""
    rng = np.random.default_rng(seed)
    lights = spheres if lights is None else lights
    desc = _cb_desc()
    kd = rng.uniform(0.2, 0.9, (materials, 3))
    pos = rng.uniform(INSIDE_LO, INSIDE_HI, (spheres, 3))
    le = rng.uniform(2.0, 6.0, (spheres, 3)) * [1.0, 0.8, 0.55]
    for i in range(spheres):
        j = i % materials
        name = f"big_mat_{j}"
        shaped = {
            "shape": {"Sphere": {"radius": radius, "zmin": -radius,
                                 "zmax": radius, "phimax": 6.28}},
            # the first sphere of a material defines it, the others name it
            "material": _matte(name, kd[j]) if i < materials
            else {"name": name},
            "transform": {"x": [1.0, 0.0, 0.0, 0.0],
                          "y": [0.0, 1.0, 0.0, 0.0],
                          "z": [0.0, 0.0, 1.0, 0.0],
                          "w": [float(c) for c in pos[i]] + [1.0]}}
        if i < lights:
            shaped["light"] = {"name": f"big_light_{i}", "value": {
                "Constant": {"value": {"inner": [float(c)
                                                 for c in le[i]]}}}}
        desc["components"].append({"name": f"big_sphere_{i}",
                                   "value": {"Shaped": shaped}})
    return desc


def grid_desc(grid: int = 17) -> dict:
    """cb_inst.json's scene on a grid x grid placement of the box."""
    desc = mci.scene_desc()
    comps = [c for c in desc["components"]
             if "Transformed" not in c["value"]]
    names = [c["name"] for c in comps]
    for i in range(1, grid * grid):   # the originals are cell (0, 0)
        t = mci._translate(mci.STEP * (i % grid), mci.STEP * (i // grid))
        comps += [{"name": f"{name}_{i}", "value": {"Transformed": {
            "original": name, "transform": t}}} for name in names]
    comps[0]["value"]["Mesh"]["filename"] = OBJ
    desc["components"] = comps
    center = mci.STEP * (grid - 1) / 2.0
    desc["camera"]["transform"] = mci._translate(
        -center, -center, -mci.CAMERA_Z * grid / mci.GRID)
    desc["outputfilename"] = "cb_grid_out.png"
    return desc


def write(path: str, desc: dict) -> str:
    with open(path, "w") as f:
        json.dump(desc, f)
    return path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out")
    ap.add_argument("--spheres", type=int, default=2500)
    ap.add_argument("--materials", type=int, default=48)
    ap.add_argument("--lights", type=int, default=None,
                    help="the spheres that emit (default: all)")
    ap.add_argument("--radius", type=float, default=0.03)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--grid", type=int, default=None,
                    help="write cb_inst.json's box on a GRID x GRID grid")
    a = ap.parse_args(argv)
    desc = grid_desc(a.grid) if a.grid else lights_desc(
        a.spheres, a.materials, a.lights, a.radius, a.seed)
    print(write(a.out, desc))


if __name__ == "__main__":
    main()
