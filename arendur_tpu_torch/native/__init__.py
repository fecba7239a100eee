"""Native (C++) host code, loaded through ctypes, and the one place
that knows how the host's C++ compiler is run.

``bvh_builder.cpp`` is the binned-SAH BVH build that every scene load
runs (accel/bvh.py build_bvh: the BVH intersector's tree and the SAH
clusters of K1 / K2, accel/clusters.py).  It computes what the NumPy
build (accel/bvh.py build_bvh_plain) computes, array for array, some
hundred times faster on meshes of 10^5-10^6 triangles.

``compile_library`` builds a C++ source with the host's compiler (g++,
else c++; no nvcc and no card) into a directory, under a name that
carries the hash of the source, the headers it includes from the
repository and the flags: this library at first use, never at import,
into ``kernels/_build/``; the host builds of the kernels' lane code
(kernels/host_*.py) into the directories their callers give.  A library
is written under a temporary name and renamed, so processes that build
it at once (render_multihost's workers) do not race on the file.  A
missing compiler, a failed compile or a library that does not load
raises; nothing falls back to the NumPy build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, "bvh_builder.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "kernels", "_build")
# -ffp-contract=off: no multiply-add contraction (NumPy rounds each
# product, nvcc -fmad=false the kernels'); no -march=native: a library
# is the same on every host
CXX_FLAGS = ["-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC"]
_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)

_lock = threading.Lock()
_lib = None


def host_cxx():
    """The host's C++ compiler (g++, else c++), or None."""
    return shutil.which("g++") or shutil.which("c++")


def find_cxx(src: str = SRC) -> str:
    cxx = host_cxx()
    if cxx is None:
        raise RuntimeError(f"no host C++ compiler (g++ or c++) found: "
                           f"{os.path.basename(src)} cannot be built")
    return cxx


def _digest(src: str) -> str:
    """Hash of src, of the files it includes by quoted path (found from
    the including file's directory, recursively) and of CXX_FLAGS."""
    h, todo, seen = hashlib.sha256(), [os.path.abspath(src)], set()
    while todo:
        path = todo.pop()
        if path in seen or not os.path.exists(path):
            continue
        seen.add(path)
        with open(path, "rb") as f:
            text = f.read()
        h.update(os.path.basename(path).encode() + text)
        todo += [os.path.join(os.path.dirname(path), m.decode())
                 for m in _INCLUDE.findall(text)]
    h.update(" ".join(CXX_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(src: str = SRC, out_dir: str | None = None) -> str:
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR if out_dir is None else out_dir,
                        f"lib{stem}_{_digest(src)}.so")


def compile_library(src: str, out_dir: str | None = None) -> str:
    """Compile src with the host's C++ compiler and CXX_FLAGS into
    out_dir (BUILD_DIR by default) where it is missing; returns the
    library's path."""
    path = library_path(src, out_dir)
    if os.path.exists(path):
        return path
    cxx = find_cxx(src)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        res = subprocess.run([cxx] + CXX_FLAGS + ["-o", tmp, src],
                             capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise RuntimeError(f"{os.path.basename(src)}: the host C++ "
                               f"build failed ({cxx}, exit "
                               f"{res.returncode}):\n{res.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def build() -> str:
    """Compile the BVH build's library where it is missing; returns its
    path."""
    return compile_library(SRC)


def load():
    """Build (if needed) and load the library, once per process."""
    global _lib
    with _lock:
        if _lib is None:
            path = build()
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                raise RuntimeError(f"the native BVH library {path} does not "
                                   f"load: {e}") from e
            P, I = ctypes.c_void_p, ctypes.c_int32
            lib.arendur_bvh_build.argtypes = [P, P, P, I, I, I] + [P] * 7
            lib.arendur_bvh_build.restype = I
            _lib = lib
        return _lib


def build_bvh(v0, v1, v2, max_leaf: int = 4) -> dict:
    """The binned-SAH build of T >= 1 triangles v0, v1, v2 [T, 3]: the
    node arrays bmin, bmax [M, 3] f32, second, start, count, axis [M]
    int32 and the primitive order [T] int32 (accel/bvh.py BVH's fields)."""
    v0, v1, v2 = (np.ascontiguousarray(v, np.float32) for v in (v0, v1, v2))
    t = v0.shape[0]
    if t < 1 or max_leaf < 1:
        raise ValueError(f"the native BVH build needs T >= 1 triangles and "
                         f"max_leaf >= 1 (T = {t}, max_leaf = {max_leaf})")
    if t > (2 ** 31 - 1) // 2:
        raise ValueError(f"{t} triangles pass the build's int32 node ids")
    lib = load()
    cap = 2 * t - 1
    order = np.empty(t, np.int32)
    bmin = np.empty((cap, 3), np.float32)
    bmax = np.empty((cap, 3), np.float32)
    ints = [np.empty(cap, np.int32) for _ in range(4)]
    m = lib.arendur_bvh_build(*(a.ctypes.data for a in (v0, v1, v2)), t,
                              int(max_leaf), cap, order.ctypes.data,
                              bmin.ctypes.data, bmax.ctypes.data,
                              *(a.ctypes.data for a in ints))
    if m < 1:
        raise RuntimeError(f"the native BVH build returned {m}")
    second, start, count, axis = (a[:m].copy() for a in ints)
    return dict(bmin=bmin[:m].copy(), bmax=bmax[:m].copy(), second=second,
                start=start, count=count, axis=axis, order=order)
