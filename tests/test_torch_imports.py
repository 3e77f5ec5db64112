"""The port imports as it must on a machine without the JAX stack.

A fresh interpreter blocks ``jax``, ``flax``, ``optax``, ``orbax``, ``PIL``
and the JAX package ``surfacenet_tpu`` (a ``sys.meta_path`` finder that
raises on them), then imports every module of ``surfacenet_tpu_torch`` and
the ``chip_smoke`` script (without running it).  Importing registers the
conv kernel's op, and must build nothing and create no build directory.
"""

import os
import subprocess
import sys

import torch

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GUARD = r"""
import importlib, importlib.abc, os, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "PIL",
           "surfacenet_tpu")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import surfacenet_tpu_torch

names = ["surfacenet_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(
        surfacenet_tpu_torch.__path__, "surfacenet_tpu_torch.")
]
for name in names:
    importlib.import_module(name)
import torch
# the conv kernel's registered op, which an exported fused forward names
assert torch.ops.surfacenet_tpu_torch.conv3d.default is not None
smoke = importlib.import_module("chip_smoke")
assert callable(smoke.main)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
from surfacenet_tpu_torch.ops.cuda import _build
assert not os.path.exists(_build.BUILD_DIR) or not any(
    f.endswith(".so") and os.path.getmtime(os.path.join(_build.BUILD_DIR, f))
    > START for f in os.listdir(_build.BUILD_DIR)
)
print("IMPORTED", " ".join(names))
"""


def test_port_imports_without_jax_pil_or_reference_package():
    import time

    code = f"START = {time.time()!r}\n" + GUARD
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    names = set(proc.stdout.split("IMPORTED")[1].split())
    assert len(names) >= 20  # every subpackage and module was walked
    # the modules that replace PIL and the JAX package's metrics
    assert {"surfacenet_tpu_torch.data.png", "surfacenet_tpu_torch.data.dtu",
            "surfacenet_tpu_torch.utils.metrics",
            "surfacenet_tpu_torch.cli", "surfacenet_tpu_torch.native",
            "surfacenet_tpu_torch.ops.denoise",
            "surfacenet_tpu_torch.data.colmap",
            "surfacenet_tpu_torch.utils.observability",
            "surfacenet_tpu_torch.parallel.distributed",
            "surfacenet_tpu_torch.parallel.mesh",
            "surfacenet_tpu_torch.parallel.halo",
            "surfacenet_tpu_torch.parallel.sweep_sharded",
            "surfacenet_tpu_torch.utils.debug",
            "surfacenet_tpu_torch.utils.viz",
            "surfacenet_tpu_torch.ops.cuda.conv3d",
            "surfacenet_tpu_torch.models.surfacenet"} <= names


def test_sources_name_no_reference_imports():
    """No import statement of the port names the JAX stack or package."""
    import re

    pat = re.compile(
        r"^\s*(import|from)\s+(jax|flax|optax|orbax|surfacenet_tpu)\b"
    )
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, fs in os.walk(os.path.join(ROOT, "surfacenet_tpu_torch")):
        files += [os.path.join(d, f) for f in fs if f.endswith(".py")]
    bad = [
        f"{f}:{i + 1}"
        for f in files
        for i, line in enumerate(open(f).read().splitlines())
        if pat.match(line)
    ]
    assert not bad, bad
