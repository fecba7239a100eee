"""Rendering over several processes with torch.distributed (port of
arendur_tpu/parallel/distributed.py; SURVEY.md §2.13/§5.8).

The JAX package forms one runtime over all hosts
(``jax.distributed.initialize``) and shards each wave over the global
device list from every process.  In PyTorch every device is a process
of its own: ``init_distributed`` joins this process to the group (NCCL
where its device is a card, gloo on the CPU), every process builds its
replica of the scene on its device, and ``render_multihost`` shards
each wave over the ranks and sums the film over all of them
(parallel/mesh.py).  Within a host and across hosts the code is the
same; only the transport differs.

A two-process self-test on one machine (CPU, gloo; ``--device cuda:0
--backend gloo`` puts both on one card):

    python -m arendur_tpu_torch.parallel.distributed --selftest --device cpu

and the worker it starts, which torchrun can start too (it reads RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT):

    torchrun --nproc_per_node 2 -m arendur_tpu_torch.parallel.distributed \\
        --worker --out img_{rank}.npy
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from arendur_tpu_torch.parallel import mesh as pmesh

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     init_method: Optional[str] = None,
                     backend: Optional[str] = None, device=None,
                     timeout_s: Optional[float] = None) -> pmesh.RayMesh:
    """Join this process to the process group and return the global ray
    group (global_ray_mesh) on its device.

    The group's rendezvous: `init_method` where given (a ``file://``
    path shared by the processes, or ``tcp://host:port``), else
    ``tcp://{coordinator_address}`` (the JAX package's "host:port" of
    process 0), else torchrun's environment (MASTER_ADDR, MASTER_PORT).
    num_processes / process_id default to WORLD_SIZE / RANK.  device
    defaults to the card of this process's local rank, ``cuda:{LOCAL_RANK}``
    (LOCAL_RANK defaults to process_id modulo the cards of the host).
    backend defaults to "nccl" on a card and "gloo" on the CPU; a named
    backend is used as named.  timeout_s bounds every collective (torch's
    default where None)."""
    env = os.environ
    rank = int(env["RANK"]) if process_id is None else int(process_id)
    world = int(env["WORLD_SIZE"]) if num_processes is None \
        else int(num_processes)
    if device is None:
        n_cards = torch.cuda.device_count()
        local = int(env.get("LOCAL_RANK", rank % n_cards if n_cards else 0))
        device = torch.device("cuda", local)
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if init_method is None:
        init_method = (f"tcp://{coordinator_address}" if coordinator_address
                       else "env://")
    kw = {}
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, **kw)
    return global_ray_mesh(device)


def global_ray_mesh(device=None) -> pmesh.RayMesh:
    """The ray group over every process of the initialised group (every
    host's cards), the multi-host form of parallel/mesh.make_ray_mesh."""
    return pmesh.make_ray_mesh(None, device)


def render_multihost(scene, camera, film_cfg, config, ops=None):
    """Full render sharded over every process of the group.  Every
    process calls it with its own replica of the same scene (a
    DeviceScene on its device) and the same camera, film and config; the
    film is summed over all processes and the finalized [H, W, 3] image,
    the same on every process, is returned as a NumPy array."""
    from arendur_tpu_torch.render import integrator as integ
    mesh = global_ray_mesh(scene.device)
    img = pmesh.render_sharded(scene, camera, film_cfg, config, mesh,
                               ops or integ.KERNEL_OPS)
    return img.cpu().numpy()


# ---------------------------------------------------------------------------
# the worker and the self-test
# ---------------------------------------------------------------------------

def _tiny_setup():
    """tests/test_parallel.py's tiny scene: a matte quad under a point
    light, seen from above at 8x8, 8 spp, depth 2.  Returns the port's
    (SceneData, camera, film_cfg, config)."""
    from arendur_tpu_torch import materials as mats
    from arendur_tpu_torch import scene as sc
    from arendur_tpu_torch.filming import camera as cam
    from arendur_tpu_torch.filming import film as flm
    from arendur_tpu_torch.geometry import transform as tf
    from arendur_tpu_torch.render import integrator as integ
    from arendur_tpu_torch.sampling import filters as filt
    b = sc.SceneBuilder()
    m = b.add_material(mtype=mats.M_MATTE, kd=(0.6, 0.5, 0.4), sigma=0.0)
    v = np.array([[-10, -10, 0], [10, -10, 0], [10, 10, 0],
                  [-10, 10, 0]], np.float32)
    f = np.array([[0, 1, 2], [0, 2, 3]], np.int64)
    b.add_mesh(v, f, m)
    b.add_point_light((0, 0, 2.0), (10.0, 10.0, 10.0))
    scene = b.build()
    pv = np.asarray(tf.look_at([0, 0, 1.0], [0, 0, 0.0], [0, 1, 0.0]))
    camera = cam.make_perspective(
        parent_view=pv, screen_min=(-1, -1), screen_max=(1, 1),
        znear=0.1, zfar=100.0, fov=1.0, lens=None, resolution=(8, 8))
    film_cfg = flm.FilmConfig(
        resolution=(8, 8), filter=filt.FilterSpec("box", (0.5, 0.5)))
    config = integ.RenderConfig(max_depth=2, spp=8, sample_dx=4,
                                sample_dy=2, wave_size=8 * 8 * 8)
    return scene, camera, film_cfg, config


def _worker_setup(args):
    """(SceneData, camera, film_cfg, config) of a worker's frame: the
    tiny scene, or a scene file with --res / --spp / --depth / --wave."""
    import dataclasses
    if args.scene == "tiny":
        return _tiny_setup()
    from arendur_tpu_torch.io import scenedesc
    res = tuple(int(x) for x in args.res.split("x")) if args.res else None
    scene, camera, film_cfg, config, _ = scenedesc.parse_scene(
        args.scene, spp_override=args.spp, resolution_override=res)
    kw = {"max_depth": args.depth} if args.depth is not None else {}
    if args.wave:
        kw["wave_size"] = args.wave
    return scene, camera, film_cfg, dataclasses.replace(config, **kw)


def _train_step(args, mesh, ds, camera, film_cfg, config, img):
    """One sharded_train_step_fn step on wave 0 (kd, ks and roughness of
    the scene's materials, target 0.8 x img, lr args.train_lr) under
    PyTorch's deterministic algorithms, saved to args.step_out; returns
    its kernel launches."""
    from arendur_tpu_torch.kernels import ops
    dev = mesh.device
    p = {k: torch.tensor(np.asarray(getattr(ds.materials, k)), device=dev)
         for k in pmesh.PARAM_KEYS}
    w, h = film_cfg.resolution
    n = min(config.wave_size, w * h * config.spp)
    n = -(-n // mesh.size) * mesh.size
    step = pmesh.sharded_train_step_fn(ds, camera, film_cfg, config, mesh,
                                       lr=args.train_lr)
    target = torch.tensor(img, device=dev).reshape(-1, 3) * 0.8
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        ops.reset_counts()
        new, loss = step(p, target, torch.arange(n, device=dev))
        launches = ops.counts()
    finally:
        torch.use_deterministic_algorithms(was)
    np.savez(args.step_out.format(rank=mesh.rank), loss=loss.item(),
             **{k: v.cpu().numpy() for k, v in new.items()})
    return launches


def _worker(args):
    """Render the frame with render_multihost and print one JSON line.
    After one untimed round, `runs` rounds, each of one render over the
    group and one render of
    the whole frame by rank 0 alone (integrator.render, the other ranks
    waiting at a barrier), in turns, both timed on the host clock with
    no synchronisation of the card inside them: the group's and rank 0's
    seconds a frame.  Then one more group render with the card
    synchronised at every phase's edges (utils.reset_phase_totals(
    sync=True)), so that the film's all-reduce is timed apart from the
    waves: its named phases and its kernel launches.  Every group
    render must equal the first.  With --train-lr, also one
    sharded_train_step_fn step (_train_step) and its launches."""
    from arendur_tpu_torch import scene as sc
    from arendur_tpu_torch import utils
    from arendur_tpu_torch.kernels import ops
    from arendur_tpu_torch.render import integrator as integ
    mesh = init_distributed(args.coordinator, args.num_processes,
                            args.process_id, init_method=args.init_method,
                            backend=args.backend, device=args.device,
                            timeout_s=args.timeout)
    if mesh.device.type == "cpu":
        # the ranks of one host share its cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // mesh.size))
    try:
        scene, camera, film_cfg, config = _worker_setup(args)
        ds = sc.DeviceScene.build(scene, mesh.device)

        def group():
            return render_multihost(ds, camera, film_cfg, config)

        def alone():
            if mesh.rank == 0:
                integ.render(ds, camera, film_cfg, config).cpu().numpy()

        imgs, secs = [], {"group": [], "alone": []}
        utils.reset_phase_totals()
        group(), alone()        # warm-up: the first call's lazy set-up
        for i in range(args.runs):
            for name in ("group", "alone")[::1 if i % 2 == 0 else -1]:
                dist.barrier()
                t0 = time.perf_counter()
                out = (group if name == "group" else alone)()
                secs[name].append(time.perf_counter() - t0)
                if name == "group":
                    imgs.append(out)
        dist.barrier()
        utils.reset_phase_totals(sync=True)
        ops.reset_counts()
        imgs.append(group())
        phases, launches = utils.phase_totals(), ops.counts()
        utils.reset_phase_totals()
        if any(not np.array_equal(i, imgs[0]) for i in imgs[1:]):
            raise AssertionError("the renders of one worker differ")
        if args.out:
            np.save(args.out.format(rank=mesh.rank), imgs[-1])
        step_launches = None
        if args.train_lr is not None:
            step_launches = _train_step(args, mesh, ds, camera, film_cfg,
                                        config, imgs[-1])
        w, h = film_cfg.resolution
        n = w * h * config.spp
        print(json.dumps(dict(
            rank=mesh.rank, size=mesh.size, device=str(mesh.device),
            backend=dist.get_backend(), seconds=secs["group"],
            paths_per_s=[n / t for t in secs["group"]],
            alone_paths_per_s=[n / t for t in secs["alone"]]
            if mesh.rank == 0 else None,
            mean=float(imgs[-1].mean()), phases=phases, launches=launches,
            step_launches=step_launches)), flush=True)
    finally:
        utils.reset_phase_totals()
        dist.destroy_process_group()


def spawn_workers(num_processes: int, out_dir: str, device=None,
                  backend=None, scene_args=(), runs: int = 1,
                  timeout_s: float = 600.0, train_lr: Optional[float] = None):
    """Start `num_processes` workers on this machine, joined by a
    ``file://`` rendezvous under out_dir, each rendering the same frame
    with render_multihost (on `device`, else each on its local card) and
    saving its image (and, with train_lr, taking one train step); wait
    for all of them.  Returns (images, reports, return codes); a report
    holds the worker's JSON line and, with train_lr, its step under
    "step" (loss and new parameters).  A worker still running after
    timeout_s is killed, as all the others then are."""
    rdv = os.path.join(out_dir, "rendezvous")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_PKG_ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")    # one machine
    procs, outs = [], []
    step_out = os.path.join(out_dir, "step_{rank}.npz")
    for rank in range(num_processes):
        outs.append(os.path.join(out_dir, f"img_{rank}.npy"))
        cmd = [sys.executable, "-m", "arendur_tpu_torch.parallel.distributed",
               "--worker", "--init-method", "file://" + rdv,
               "--num-processes", str(num_processes), "--process-id",
               str(rank), "--out", outs[-1], "--runs", str(runs),
               "--timeout", str(timeout_s)] + list(scene_args)
        if device is not None:
            cmd += ["--device", str(device)]
        if backend is not None:
            cmd += ["--backend", backend]
        if train_lr is not None:
            cmd += ["--train-lr", str(train_lr), "--step-out", step_out]
        procs.append(subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                      text=True))
    deadline = time.monotonic() + timeout_s
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            logs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    rcs = [p.returncode for p in procs]
    reports = [json.loads(log.strip().splitlines()[-1]) if rc == 0 else None
               for log, rc in zip(logs, rcs)]
    imgs = [np.load(o) if rc == 0 else None for o, rc in zip(outs, rcs)]
    if train_lr is not None:
        for rank, r in enumerate(reports):
            if r is not None:
                r["step"] = dict(np.load(step_out.format(rank=rank)))
    return imgs, reports, rcs


def selftest(num_processes: int = 2, device=None, backend=None,
             scene_args=()) -> int:
    """Render the tiny scene (or the frame of `scene_args`) in
    `num_processes` workers; 0 where every worker finished and all of
    them returned the same image (to 1e-7, the JAX self-test's gate)."""
    with tempfile.TemporaryDirectory() as tmp:
        imgs, reports, rcs = spawn_workers(num_processes, tmp, device,
                                           backend, scene_args)
    print("selftest rcs:", rcs)
    if any(rcs):
        return 1
    for r in reports:
        print(json.dumps(r))
    same = all(np.allclose(i, imgs[0], rtol=1e-6, atol=1e-7)
               for i in imgs[1:])
    print("selftest images equal:", same)
    return 0 if same else 1


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--selftest", action="store_true",
                      help="spawn --num-processes workers on this machine")
    mode.add_argument("--worker", action="store_true",
                      help="one process of the group: render and save")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--coordinator", default=None, help="host:port")
    ap.add_argument("--init-method", default=None,
                    help="file:///shared/path or tcp://host:port")
    ap.add_argument("--device", default=None,
                    help="default: cuda:{LOCAL_RANK}")
    ap.add_argument("--backend", default=None, help="default: nccl on a "
                    "card, gloo on the CPU")
    ap.add_argument("--timeout", type=float, default=None,
                    help="seconds a collective may take")
    ap.add_argument("--scene", default="tiny",
                    help="'tiny' or a scene JSON")
    ap.add_argument("--res", default=None, help="WxH")
    ap.add_argument("--spp", type=int, default=None)
    ap.add_argument("--depth", type=int, default=None)
    ap.add_argument("--wave", type=int, default=None)
    ap.add_argument("--runs", type=int, default=1,
                    help="timed rounds: a group render and rank 0's render "
                    "alone, in turns")
    ap.add_argument("--train-lr", type=float, default=None,
                    help="also take one sharded train step at this rate")
    ap.add_argument("--step-out", default=None,
                    help="the step (.npz); {rank} is replaced by the rank")
    ap.add_argument("--out", default=None,
                    help="the image (.npy); {rank} is replaced by the rank")
    args = ap.parse_args(argv)
    if args.worker and (args.train_lr is None) != (args.step_out is None):
        ap.error("--train-lr and --step-out go together")
    if args.worker:
        _worker(args)
        return 0
    scene_args = ["--scene", args.scene]
    for flag, v in (("--res", args.res), ("--spp", args.spp),
                    ("--depth", args.depth), ("--wave", args.wave)):
        if v is not None:
            scene_args += [flag, str(v)]
    return selftest(args.num_processes or 2, args.device, args.backend,
                    scene_args)


if __name__ == "__main__":
    sys.exit(main())
