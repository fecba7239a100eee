"""Count the processes in which PyTorch's first CPU call of a
transcendental (torch.sin, torch.cos, ...) gives other bits than its
second call on the same input.

    python tools/torch_first_call.py [--fn sin] [--processes 120] \
        [--threads 0] [--n 20000] [--jobs 6]

Each process (a fresh interpreter, so the call is its first) draws n
float32 values in [0, 2 pi) from a fixed seed, calls the function twice
and compares: where the first call differs, it prints the lanes that
differ and the largest error of each call against the float64 value,
relative to max(|exact|, 1e-3).  --threads 0 keeps PyTorch's default
thread count.  The port's CPU plain versions call these functions, so a
first call that goes wrong moves their results (the witness of
tools/witness_big_lights.py saw it as a light sample whose points moved
on one thread's share of the lanes).
"""

import argparse
import concurrent.futures
import subprocess
import sys

CHILD = r"""
import sys
import numpy as np
import torch
fn, threads, n = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
if threads:
    torch.set_num_threads(threads)
x = torch.tensor(np.random.default_rng(0).uniform(
    0.0, 6.283, n).astype(np.float32))
first = getattr(torch, fn)(x).numpy().copy()
again = getattr(torch, fn)(x).numpy()
exact = getattr(np, fn)(x.numpy().astype(np.float64))
d = np.nonzero(first != again)[0]
if len(d):
    rel = lambda a: float(np.max(np.abs(a[d] - exact[d]) / np.maximum(
        np.abs(exact[d]), 1e-3)))
    print(f"DIFF {len(d)} {d.min()} {d.max()} {rel(first):.3e} "
          f"{rel(again):.3e} {torch.get_num_threads()}")
else:
    print(f"SAME {torch.get_num_threads()}")
"""


def one(args):
    out = subprocess.run([sys.executable, "-c", CHILD, args.fn,
                          str(args.threads), str(args.n)],
                         capture_output=True, text=True, timeout=300,
                         check=True)
    return out.stdout.split()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fn", default="sin")
    ap.add_argument("--processes", type=int, default=120)
    ap.add_argument("--threads", type=int, default=0)
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--jobs", type=int, default=6)
    args = ap.parse_args(argv)
    with concurrent.futures.ThreadPoolExecutor(args.jobs) as pool:
        runs = list(pool.map(lambda _: one(args), range(args.processes)))
    bad = [r for r in runs if r[0] == "DIFF"]
    for r in bad:
        print(f"first call differs on {r[1]} lanes ({r[2]}..{r[3]}); "
              f"largest relative error, first call {r[4]}, second {r[5]}")
    print(f"torch.{args.fn} on {args.n} float32 values, {runs[0][-1]} "
          f"threads: the first call differs from the second in "
          f"{len(bad)} of {len(runs)} processes")


if __name__ == "__main__":
    main()
