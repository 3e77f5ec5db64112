"""Native (C++) host-side merge and denoise, bound with ctypes.

The port's own copy of ``surfacenet_tpu/native``: ``merge.cpp`` (overlap
merge: O(N) hash dedupe, binary-search containment counts) and
``denoise.cpp`` (26-connected components by union-find) keep the same C
interface (``sn_containment``, ``sn_merge``, ``sn_pack_keys``,
``sn_components``).  They are compiled at first use with

    g++ -O3 -shared -fPIC -std=c++17

into ``surfacenet_tpu_torch/_build/`` (ignored by git), named by a hash of
the sources and the flags, as ``ops/cuda/_build.py`` builds the CUDA
kernels.  Nothing is built when the module is imported.  A failed build or
load raises with the compiler's output: there is no silent fall back.  The
numpy versions (``pipeline/sparse.py``'s numpy merge,
``ops/denoise.py::_components_numpy``) run only where a caller asks for
them by name.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

from surfacenet_tpu_torch.ops.cuda._build import BUILD_DIR

_DIR = os.path.dirname(os.path.abspath(__file__))
SRCS = ("merge.cpp", "denoise.cpp")
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> str:
    """Path of the library: hashes the sources and the flags."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in SRCS:
        with open(os.path.join(_DIR, src), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"native-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library unless it exists; returns its path.  Raises
    RuntimeError with the compiler's output if the build fails."""
    path = library_path()
    if os.path.exists(path):
        return path
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the port's native merge "
                           "and denoise are built from source at first use")
    os.makedirs(BUILD_DIR, exist_ok=True)
    # build under a temporary name, then rename: a concurrent loader never
    # sees a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [cxx, *FLAGS, "-o", tmp, *(os.path.join(_DIR, s) for s in SRCS)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"native merge/denoise build failed (g++ exit "
            f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        i64p = ctypes.POINTER(ctypes.c_int64)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        f32p = ctypes.POINTER(ctypes.c_float)
        i64 = ctypes.c_int64
        lib.sn_containment.restype = None
        lib.sn_containment.argtypes = [i64p, i64, u64p, i64, i64, i64, f32p]
        lib.sn_merge.restype = i64
        lib.sn_merge.argtypes = [i64p, f32p, f32p, f32p, i64, ctypes.c_float,
                                 i64p, f32p, f32p]
        lib.sn_pack_keys.restype = None
        lib.sn_pack_keys.argtypes = [i64p, i64, u64p]
        lib.sn_components.restype = i64
        lib.sn_components.argtypes = [i64p, i64, i64p, i64p]
        _lib = lib
        return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _coords(a: np.ndarray, name: str) -> np.ndarray:
    a = np.ascontiguousarray(a, np.int64)
    if a.ndim != 2 or a.shape[1] != 3:
        raise ValueError(f"{name} must be (N, 3), got {a.shape}")
    # the packed keys hold 21 bits an axis, sign included
    if a.size and (a.min() < -(1 << 20) or a.max() >= (1 << 20)):
        raise ValueError(f"{name} outside the packed key's range +-2^20")
    return a


def native_merge(
    coords: np.ndarray,  # (N, 3) int64
    probs: np.ndarray,  # (N,) f32
    colors: np.ndarray,  # (N, 3) f32
    done_grid: np.ndarray,  # (M, 3) int64 grid indices of processed cubes
    stride: int,
    D: int,
    vote_threshold: float,
):
    """Overlap merge of sparse voxel records: (coords (K, 3) int64, probs
    (K,) f32, colors (K, 3) f32) of the surviving distinct voxels, in the
    hash map's order (not sorted).  A voxel survives when the records that
    mark it, over the processed cubes that contain it, reach
    ``vote_threshold``; probabilities and colours are float32 means."""
    lib = load()
    coords = _coords(coords, "coords")
    done_grid = _coords(np.asarray(done_grid).reshape(-1, 3), "done_grid")
    n, m = len(coords), len(done_grid)
    probs = np.ascontiguousarray(probs, np.float32)
    colors = np.ascontiguousarray(colors, np.float32)
    if probs.shape != (n,) or colors.shape != (n, 3):
        raise ValueError(f"probs {probs.shape} / colors {colors.shape} do "
                         f"not match {n} records")

    keys = np.empty(m, np.uint64)
    lib.sn_pack_keys(_ptr(done_grid, ctypes.c_int64), m,
                     _ptr(keys, ctypes.c_uint64))
    contain = np.empty(n, np.float32)
    lib.sn_containment(_ptr(coords, ctypes.c_int64), n,
                       _ptr(keys, ctypes.c_uint64), m, int(stride), int(D),
                       _ptr(contain, ctypes.c_float))
    out_coords = np.empty((n, 3), np.int64)
    out_probs = np.empty(n, np.float32)
    out_colors = np.empty((n, 3), np.float32)
    kept = lib.sn_merge(
        _ptr(coords, ctypes.c_int64), _ptr(probs, ctypes.c_float),
        _ptr(colors, ctypes.c_float), _ptr(contain, ctypes.c_float),
        n, float(vote_threshold),
        _ptr(out_coords, ctypes.c_int64), _ptr(out_probs, ctypes.c_float),
        _ptr(out_colors, ctypes.c_float),
    )
    return out_coords[:kept], out_probs[:kept], out_colors[:kept]


def native_components(coords: np.ndarray):
    """26-connected components of (N, 3) unique integer voxel coords by the
    C++ union-find: (labels, sizes) int64, labels compact in
    [0, n_components) in order of first appearance, sizes per record."""
    lib = load()
    coords = _coords(coords, "coords")
    n = len(coords)
    labels = np.empty(n, np.int64)
    sizes = np.empty(n, np.int64)
    lib.sn_components(_ptr(coords, ctypes.c_int64), n,
                      _ptr(labels, ctypes.c_int64),
                      _ptr(sizes, ctypes.c_int64))
    return labels, sizes
