"""View-pair probability fusion and adaptive thresholds.

Port of ``fuse_pairs``, ``fuse_pairs_consensus`` and ``adaptive_threshold``
from ``surfacenet_tpu/ops/fusion.py``; each takes leading batch dimensions
(the reference vmaps them over cubes).
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


def fuse_pairs_consensus(probs, weights, valid=None, beta: float = 8.0,
                         deadband: float = 0.1, eps: float = 1e-8):
    """Consensus-reweighted fusion: each pair's volume is correlated with
    the fusion of the OTHER pairs (leave-one-out; masked zero-mean cosine
    over the cube's voxels), and a pair whose correlation falls more than
    ``deadband`` below the cube's best pair is down-weighted by
    ``exp(beta * (corr - max + deadband))`` before the weighted average.
    Pairs inside the deadband keep their weight exactly, so agreeing pairs
    and empty cubes reproduce ``fuse_pairs``.

    probs (..., Npairs, D, D, D); weights (..., Npairs); valid optional
    (..., Npairs, D, D, D) bool.  Returns (..., D, D, D).
    """
    v = (valid.to(probs.dtype) if valid is not None
         else torch.ones_like(probs))
    vox = (-3, -2, -1)
    w = weights[..., None, None, None] * v
    num_all = torch.sum(w * probs, dim=-4, keepdim=True)
    den_all = torch.sum(w, dim=-4, keepdim=True)
    f_loo = (num_all - w * probs) / (den_all - w + eps)
    cnt = torch.sum(v, dim=vox, keepdim=True) + eps
    pm = torch.sum(probs * v, dim=vox, keepdim=True) / cnt
    fm = torch.sum(f_loo * v, dim=vox, keepdim=True) / cnt
    pc = (probs - pm) * v
    fc = (f_loo - fm) * v
    num = torch.sum(pc * fc, dim=vox)
    den = torch.sqrt(
        torch.sum(pc * pc, dim=vox) * torch.sum(fc * fc, dim=vox)
    ) + eps
    corr = num / den  # (..., Npairs)
    gate = torch.exp(beta * torch.clamp(
        corr - corr.amax(dim=-1, keepdim=True) + deadband, max=0.0))
    return fuse_pairs(probs, weights * gate, valid)


def adaptive_threshold(fused, taus, target_density: float):
    """Per cube, the tau whose occupancy is closest to ``target_density``.

    fused (..., D, D, D); taus (T,).  Returns (...) chosen thresholds.
    """
    occ = fused[..., None, :, :, :] > taus[:, None, None, None]
    dens = occ.float().mean(dim=(-1, -2, -3))  # (..., T)
    idx = torch.argmin(torch.abs(dens - target_density), dim=-1)
    return taus[idx]
