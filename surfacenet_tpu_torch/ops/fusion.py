"""View-pair probability fusion and adaptive thresholds.

Port of ``fuse_pairs`` and ``adaptive_threshold`` from
``surfacenet_tpu/ops/fusion.py``; both take leading batch dimensions (the
reference vmaps them over cubes).
"""

from __future__ import annotations

import torch


def fuse_pairs(probs, weights, valid=None, eps: float = 1e-8):
    """Weighted average of per-pair probability volumes.

    probs (..., Npairs, D, D, D); weights (..., Npairs); valid optional
    (..., Npairs, D, D, D) bool, invalid voxels drop out of the average.
    Returns (..., D, D, D).
    """
    w = weights[..., None, None, None]
    if valid is not None:
        w = w * valid.to(probs.dtype)
    num = torch.sum(w * probs, dim=-4)
    den = torch.sum(w, dim=-4)
    return num / (den + eps)


def adaptive_threshold(fused, taus, target_density: float):
    """Per cube, the tau whose occupancy is closest to ``target_density``.

    fused (..., D, D, D); taus (T,).  Returns (...) chosen thresholds.
    """
    occ = fused[..., None, :, :, :] > taus[:, None, None, None]
    dens = occ.float().mean(dim=(-1, -2, -3))  # (..., T)
    idx = torch.argmin(torch.abs(dens - target_density), dim=-1)
    return taus[idx]
