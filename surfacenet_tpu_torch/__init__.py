"""surfacenet-tpu on PyTorch and CUDA.

A port of the JAX package ``surfacenet_tpu`` to PyTorch, with the Pallas
TPU kernels of the reconstruction path rewritten as hand-written CUDA
kernels for Hopper (``csrc/``, bound in ``ops/cuda/``).  The package
imports neither JAX nor the JAX package; it keeps its own copies of the
host-side modules it needs.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU; see ``device.resolve_device``.
"""

__version__ = "0.1.0"

from surfacenet_tpu_torch.config import Config, baseline_config  # noqa: F401
