"""Training loss: class-balanced binary cross-entropy over voxels.

Port of ``surfacenet_tpu/train/losses.py``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def class_balanced_bce(
    logits: torch.Tensor,
    labels: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    balanced: bool = True,
    eps: float = 1e-6,
) -> torch.Tensor:
    """Class-balanced binary cross-entropy over voxels.

    Surface voxels are rare (~1-3% of a cube): positives are weighted by
    alpha = N_neg / N, negatives by 1 - alpha = N_pos / N, per batch, over
    the valid voxels only.

    Args:
      logits: (B, D, D, D) pre-sigmoid, float32.
      labels: (B, D, D, D) in {0, 1}.
      valid: optional bool mask; invalid voxels are excluded.

    Returns a float32 scalar.
    """
    labels = labels.float()
    # optax's sigmoid_binary_cross_entropy, term for term: log-sigmoids
    # keep a confident voxel's small loss exact, where
    # F.binary_cross_entropy_with_logits's log(1 + e) loses it (1e-3
    # relative at a logit of -8)
    per_vox = -(labels * F.logsigmoid(logits)
                + (1.0 - labels) * F.logsigmoid(-logits))
    valid_f = torch.ones_like(labels) if valid is None else valid.float()
    n = torch.clamp(valid_f.sum(), min=1.0)
    if balanced:
        n_pos = (labels * valid_f).sum()
        w = torch.where(labels > 0.5, (n - n_pos) / n, n_pos / n) * valid_f
    else:
        w = valid_f
    return (per_vox * w).sum() / torch.clamp(w.sum(), min=eps)
