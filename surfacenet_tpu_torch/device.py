"""Device selection for the port's entry points.

Entry points take ``device="cuda"`` by default and run on the card; the
CPU is used only when the caller passes ``device="cpu"`` (the tests do).
A missing card is an error, never a silent fall back to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if CUDA is asked for and absent.

    On the card, float32 matrix products and convolutions are pinned to
    full float32 (no TF32): projection matrices have entries ~1e4, and the
    reduced precision moves projected points by pixels.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "surfacenet_tpu_torch: CUDA is not available on this "
                "machine; pass device='cpu' (CLI: --device cpu) to run on "
                "the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use cuda or cpu")
    return dev
