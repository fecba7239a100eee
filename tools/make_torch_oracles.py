"""Write the JAX oracles of the port's tests (tests/torch_oracles.py)
into tests/data/torch_oracles/: the results of JAX computations that
compile for longer than a test file may take.

    JAX_PLATFORMS=cpu python tools/make_torch_oracles.py [name ...]

With no name, every oracle (tests/torch_oracles.py ORACLES) is made.
Runs the JAX package on the CPU, with two virtual CPU devices for the
sharded oracles (par_*) unless XLA_FLAGS sets a device count.  The
area-mode oracles (area_*) are made in a second process of this script
with ARENDUR_SPHERE_THETA=area, which the JAX package reads at import.
"""

import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))


def main(argv):
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=2").strip()
    import torch_oracles as orc
    names = argv or list(orc.ORACLES)
    area = [n for n in names if n.startswith("area_")]
    if os.environ.get("ARENDUR_SPHERE_THETA") == "area":
        if len(area) != len(names):
            raise SystemExit("with ARENDUR_SPHERE_THETA=area only the "
                             "area_* oracles can be made")
    else:
        if area:
            subprocess.run([sys.executable, os.path.abspath(__file__)]
                           + area, check=True,
                           env=dict(os.environ, ARENDUR_SPHERE_THETA="area"))
        names = [n for n in names if n not in area]
    import jax
    jax.config.update("jax_platforms", "cpu")
    for name in names:
        inputs, run = orc.ORACLES[name]
        t0 = time.perf_counter()
        out = run()
        orc.save(name, inputs(), **out)
        print(f"{name}: {', '.join(f'{k} {v.shape}' for k, v in out.items())}"
              f" in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main(sys.argv[1:])
