"""Build and load the hand-written CUDA kernels.

All ``*.cu`` sources of this directory are compiled by ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, loaded
with ctypes.  (A plain C interface needs no PyTorch headers, which
keeps the build to seconds; PyTorch's own extension builder needs
ninja and minutes per build.)  The library lands in ``_build/`` under
a name that carries the hash of the sources, so an edited source
rebuilds and an unchanged one is built once per checkout.

The build happens at first use, never at import.  A failed build
raises; nothing falls back to the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_DIR, "_build")
NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no multiply-add contraction: the bounce shade then rounds like
    # its plain PyTorch version op for op (the intersect kernels write
    # their FMAs explicitly)
    "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
]

_lock = threading.Lock()
_lib = None


def sources():
    return sorted(glob.glob(os.path.join(_DIR, "*.cu"))
                  + glob.glob(os.path.join(_DIR, "*.cuh")))


def _digest() -> str:
    h = hashlib.sha256()
    for p in sources():
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> str:
    return os.path.join(BUILD_DIR, f"libarendur_kernels_{_digest()}.so")


def build(verbose: bool = False) -> str:
    """Compile the kernels if the library for these sources is missing;
    returns its path.  verbose prints nvcc's register/spill report."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [find_nvcc()] + NVCC_FLAGS + (["-Xptxas", "-v"] if verbose
                                        else []) + \
        ["-o", tmp] + [p for p in sources() if p.endswith(".cu")]
    proc = subprocess.run(cmd, cwd=_DIR, capture_output=True, text=True)
    if verbose:
        print(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed:\n" + proc.stdout + proc.stderr)
    os.replace(tmp, path)
    return path


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
            lib.arendur_closest_hit.argtypes = [P, P, P, P, P, P, I, I, I,
                                                I, P, P, P]
            lib.arendur_closest_hit.restype = I
            lib.arendur_any_hit.argtypes = [P, P, P, P, P, P, I, I, I, I,
                                            P, P]
            lib.arendur_any_hit.restype = I
            lib.arendur_bounce_shade.argtypes = [P, P, I, I, P, I, P, I, L,
                                                 P, P, P]
            lib.arendur_bounce_shade.restype = I
            _lib = lib
        return _lib
