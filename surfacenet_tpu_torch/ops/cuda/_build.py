"""Build and load the port's CUDA kernels.

Each kernel source ``csrc/<name>.cu`` has a plain C interface and is
compiled with ``nvcc`` into a shared library, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC --fmad=false -Xptxas=-v

Libraries go to ``surfacenet_tpu_torch/_build/`` (ignored by git), named by
a hash of the source, the shared headers (``csrc/*.cuh``) and the flags, so an edited source rebuilds and an
unchanged one is reused.  Nothing is built when a module is imported: the
first ``load`` builds what it needs, and ``build_all`` builds every kernel
at once with one ``nvcc`` per source running in parallel.  A failed build
raises with the compiler's output.

``--fmad=false`` keeps the compiler from contracting a multiply and an add
into one rounding, so the gather and the ray-pooling kernels repeat their
plain PyTorch versions' float32 arithmetic exactly (they are bound by
memory, not by arithmetic, so the lost FMAs cost nothing measurable).  The
conv kernel's products and sums run in the tensor cores, where the flag
changes nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, Iterable

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)
)))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
KERNELS = ("warp_gather", "affine_vote", "affine_pool", "conv3d")
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas=-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# compiler output of the builds made by this process (ptxas register and
# spill counts), by kernel name
build_log: Dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for root in ([home] if home else []) + ["/usr/local/cuda"]:
        cand = os.path.join(root, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the port's "
        "CUDA kernels are built from source at first use"
    )


def library_path(name: str) -> str:
    """Path of kernel ``name``'s library: hashes its source, the shared
    headers (``csrc/*.cuh``) and the flags."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    headers = sorted(f for f in os.listdir(SRC_DIR) if f.endswith(".cuh"))
    for src in [f"{name}.cu", *headers]:
        with open(os.path.join(SRC_DIR, src), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build_all(names: Iterable[str] = KERNELS) -> float:
    """Build every missing library in ``names``, all ``nvcc`` in parallel.

    Returns the wall seconds spent.  Raises RuntimeError if any build fails.
    """
    t0 = time.perf_counter()
    todo = [n for n in names if not os.path.exists(library_path(n))]
    if not todo:
        return 0.0
    nvcc = nvcc_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name in todo:
        # build under a temporary name, then rename: a concurrent loader
        # never sees a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *FLAGS, "-o", tmp, os.path.join(SRC_DIR, f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )))
    failed = []
    for name, tmp, proc in procs:
        out, _ = proc.communicate()
        build_log[name] = out
        if proc.returncode == 0:
            os.replace(tmp, library_path(name))
        else:
            os.unlink(tmp)
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{out}")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(library_path(name))
            _libs[name] = lib
        return lib
