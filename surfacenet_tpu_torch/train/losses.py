"""Training loss: class-balanced binary cross-entropy over voxels.

Port of ``surfacenet_tpu/train/losses.py``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from surfacenet_tpu_torch.parallel.distributed import all_reduce_


def class_balanced_bce(
    logits: torch.Tensor,
    labels: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    balanced: bool = True,
    eps: float = 1e-6,
    group=None,
) -> torch.Tensor:
    """Class-balanced binary cross-entropy over voxels.

    Surface voxels are rare (~1-3% of a cube): positives are weighted by
    alpha = N_neg / N, negatives by 1 - alpha = N_pos / N, per batch, over
    the valid voxels only.

    Args:
      logits: (B, D, D, D) pre-sigmoid, float32.
      labels: (B, D, D, D) in {0, 1}.
      valid: optional bool mask; invalid voxels are excluded.
      group: a process group whose ranks each hold a part of the batch
        (data-parallel training): N, N_pos and the weights' sum are then
        the global batch's, as in the reference's loss over its sharded
        batch, and each rank returns its voxels' share of the global
        loss (the ranks' returns add up to it).

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
    counts = torch.stack([valid_f.sum(), (labels * valid_f).sum()])
    if group is not None:
        all_reduce_(counts, group)
    n = torch.clamp(counts[0], min=1.0)
    if balanced:
        n_pos = counts[1]
        w = torch.where(labels > 0.5, (n - n_pos) / n, n_pos / n) * valid_f
    else:
        w = valid_f
    w_sum = w.sum()
    if group is not None:
        w_sum = all_reduce_(w_sum.reshape(1), group)[0]
    return (per_vox * w).sum() / torch.clamp(w_sum, min=eps)
