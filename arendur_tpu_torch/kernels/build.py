"""Build and load the hand-written CUDA kernels.

Each ``*.cu`` source of this directory is compiled by its own ``nvcc``
for ``sm_90a`` into a shared library with a plain C interface, all
``nvcc`` calls at once, and the libraries are loaded with ctypes.  (A
plain C interface needs no PyTorch headers, which keeps the build to
seconds; PyTorch's own extension builder needs ninja and minutes per
build.)  A library lands in ``_build/`` under a name that carries the
hash of its source, the headers and the flags, so an edited source
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
    return sorted(glob.glob(os.path.join(_DIR, "*.cu")))


def _headers():
    return sorted(glob.glob(os.path.join(_DIR, "*.cuh")))


def _digest(src: str) -> str:
    h = hashlib.sha256()
    for p in [src] + _headers():
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


def library_path(src: str) -> str:
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{_digest(src)}.so")


def build(report: bool = False) -> list:
    """Compile the kernel libraries that are missing for these sources,
    one nvcc per source, all started together.  Returns (path, nvcc
    output) per source; the output is empty for a library already
    built, and report adds ptxas's register / stack / spill report to
    it (-Xptxas -v)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for src in sources():
        path = library_path(src)
        if os.path.exists(path):
            procs.append((src, path, None, None))
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [find_nvcc()] + NVCC_FLAGS + (
            ["-Xptxas", "-v"] if report else []) + ["-o", tmp, src]
        procs.append((src, path, tmp, subprocess.Popen(
            cmd, cwd=_DIR, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    out, failed = [], []
    for src, path, tmp, proc in procs:
        log = ""
        if proc is not None:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{os.path.basename(src)}:\n{log}")
                continue
            os.replace(tmp, path)
        out.append((path, log))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


class _Kernels:
    """The C entries of all kernel libraries, by name."""

    def __init__(self, libs):
        self._libs = libs

    def __getattr__(self, name):
        for lib in self._libs:
            try:
                return getattr(lib, name)
            except AttributeError:
                pass
        raise AttributeError(name)


def load() -> _Kernels:
    """Build (if needed) and load the kernel libraries, once per
    process."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = _Kernels([ctypes.CDLL(p) for p, _ in build()])
            P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
            lib.arendur_closest_hit.argtypes = [P, P, P, P, P, P, P, I, I,
                                                I, I, I, I, P, P, P]
            lib.arendur_closest_hit.restype = I
            lib.arendur_any_hit.argtypes = [P, P, P, P, P, P, P, I, I, I, I,
                                            I, I, P, P]
            lib.arendur_any_hit.restype = I
            lib.arendur_closest_hit_instanced.argtypes = [
                P, P, P, P, P, P, P, I, I, I, I, P, P, P, P]
            lib.arendur_closest_hit_instanced.restype = I
            lib.arendur_any_hit_instanced.argtypes = [
                P, P, P, P, P, P, P, P, I, I, I, I, P, P]
            lib.arendur_any_hit_instanced.restype = I
            lib.arendur_isect_inst_occupancy.argtypes = [I, I, P]
            lib.arendur_isect_inst_occupancy.restype = I
            lib.arendur_isect_encodes.argtypes = []
            lib.arendur_isect_encodes.restype = ctypes.c_longlong
            lib.arendur_isect_occupancy.argtypes = [I, P]
            lib.arendur_isect_occupancy.restype = I
            lib.arendur_bounce_shade.argtypes = [P, P, I, I, P, I, P, I, I,
                                                 L, P, P, P, P]
            lib.arendur_bounce_shade.restype = I
            lib.arendur_bounce_shade_occupancy.argtypes = [I, I, I, I, I, P]
            lib.arendur_bounce_shade_occupancy.restype = I
            lib.arendur_bounce_shade_bwd.argtypes = [
                P, P, P, I, I, P, I, P, I, I, L, P, P, P, L, I, P, P, P, P,
                P, P, P, P, P, P]
            lib.arendur_bounce_shade_bwd.restype = I
            lib.arendur_hit_shade.argtypes = [P, P, I, I, L, P, P]
            lib.arendur_hit_shade.restype = I
            lib.arendur_shade_split.argtypes = [P, P, I, I, I, L, P, P, P,
                                                P]
            lib.arendur_shade_split.restype = I
            lib.arendur_shade_split_occupancy.argtypes = [I, I, I, P]
            lib.arendur_shade_split_occupancy.restype = I
            fields = [P] * 12   # the BsdfSlots fields (ops.SLOT_FIELDS)
            lib.arendur_slot_sample.argtypes = fields + [P, P, P, L, I, P,
                                                         P, P, P, P, P]
            lib.arendur_slot_eval_pdf.argtypes = fields + [P, P, L, I, P, P,
                                                           P, P]
            lib.arendur_slot_order.argtypes = [P, L, P, I, P, P, P]
            for name in ("arendur_slot_sample_packed",
                         "arendur_slot_eval_pdf_packed"):
                getattr(lib, name).argtypes = [P, L, I, P, P, P]
            for name in ("arendur_slot_sample", "arendur_slot_eval_pdf",
                         "arendur_slot_order", "arendur_slot_sample_packed",
                         "arendur_slot_eval_pdf_packed"):
                getattr(lib, name).restype = I
            _lib = lib
        return _lib
