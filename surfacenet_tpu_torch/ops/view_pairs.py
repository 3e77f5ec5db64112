"""Geometric view-pair selection and gather deduplication.

Port of the geometric half of ``surfacenet_tpu/ops/view_pairs.py``: every
candidate pair is scored densely per cube (both cameras must see the cube;
the weight peaks at a preferred triangulation angle), and the top Nv are
kept.  Ties keep the lower pair index first, as ``lax.top_k`` does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from surfacenet_tpu_torch.device import resolve_device
from surfacenet_tpu_torch.geometry.camera import camera_center, cube_visible


def candidate_pairs(n_views: int) -> np.ndarray:
    """All unordered view pairs, (P, 2) int32."""
    a, b = np.triu_indices(n_views, k=1)
    return np.stack([a, b], axis=-1).astype(np.int32)


def pair_angle_weight(cos_angle, preferred_deg: float = 20.0,
                      sigma_deg: float = 15.0):
    """Gaussian weight on the pair's triangulation angle at the cube."""
    ang = torch.rad2deg(torch.arccos(torch.clamp(cos_angle, -1.0, 1.0)))
    return torch.exp(-0.5 * ((ang - preferred_deg) / sigma_deg) ** 2)


def select_pairs_geometric(
    Ps: np.ndarray,
    origins: np.ndarray,
    n_pairs: int,
    image_hw: Tuple[int, int],
    extent_mm: Optional[float] = None,
    dist_sigma_frac: float = 0.0,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Geometric top-Nv pair selection for a batch of cubes.

    Scores are computed in float32 on ``device``.
    Returns (pair_idx (N, Nv, 2) int32, weights (N, Nv) float32), numpy.
    """
    if extent_mm is None:
        raise ValueError("extent_mm required")
    dev = resolve_device(device)
    Ps = torch.as_tensor(np.asarray(Ps), dtype=torch.float32, device=dev)
    origins = torch.as_tensor(
        np.asarray(origins), dtype=torch.float32, device=dev
    )
    pairs = torch.as_tensor(candidate_pairs(Ps.shape[0]), device=dev).long()

    vis = cube_visible(Ps, origins, float(extent_mm), image_hw)  # (N, V)
    centers = origins + float(extent_mm) / 2.0
    cams = camera_center(Ps)  # (V, 3)
    va = cams[pairs[:, 0]][None] - centers[:, None]  # (N, P, 3)
    vb = cams[pairs[:, 1]][None] - centers[:, None]
    da = torch.linalg.norm(va, dim=-1)
    db = torch.linalg.norm(vb, dim=-1)
    va = va / (da[..., None] + 1e-8)
    vb = vb / (db[..., None] + 1e-8)
    w = pair_angle_weight(torch.sum(va * vb, dim=-1))  # (N, P)
    if dist_sigma_frac > 0:
        d_view = torch.linalg.norm(cams[None] - centers[:, None], dim=-1)
        d_ref = torch.where(vis, d_view, torch.inf).amin(dim=1, keepdim=True)
        d_ref = torch.where(torch.isfinite(d_ref), d_ref, 1.0)
        w = w * torch.exp(
            -(((da + db) / 2 - d_ref) / (dist_sigma_frac * d_ref)) ** 2
        )
    both_vis = vis[:, pairs[:, 0]] & vis[:, pairs[:, 1]]
    w = torch.where(both_vis, w, 0.0)

    top_w, top_i = torch.sort(w, dim=1, descending=True, stable=True)
    top_w, top_i = top_w[:, :n_pairs].clone(), top_i[:, :n_pairs]
    sel = pairs[top_i].to(torch.int32)  # (N, n_pairs, 2)
    # fewer visible pairs than n_pairs: weights are 0 and fusion's
    # denominator handles it; the best pair keeps a tiny floor
    top_w[:, 0] = torch.clamp(top_w[:, 0], min=1e-3)
    return sel.cpu().numpy(), top_w.cpu().numpy()


def dedup_view_slots(
    pair_idx: np.ndarray, k: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-cube unique-view table + per-pair-half slot indices.

    The gather runs once per (cube, distinct view); pairs index into it.

    Args:
      pair_idx: (N, P, 2) int view indices per cube pair.
      k: table width; defaults to the batch max unique count.

    Returns:
      (uniq (N, K) int32 ascending unique views, -1 padded at the end;
       slots (N, P, 2) int32 with uniq[n, slots[n,p,h]] == pair_idx[n,p,h]).
    """
    pi = np.asarray(pair_idx)
    N = pi.shape[0]
    flat = pi.reshape(N, -1).astype(np.int64)
    order = np.argsort(flat, axis=1, kind="stable")
    sf = np.take_along_axis(flat, order, axis=1)
    new = np.ones_like(sf, bool)
    new[:, 1:] = sf[:, 1:] != sf[:, :-1]
    rank = np.cumsum(new, axis=1) - 1
    n_uniq = rank[:, -1] + 1
    kk = int(n_uniq.max()) if k is None else int(k)
    if (n_uniq > kk).any():
        raise ValueError(
            f"dedup_view_slots: k={kk} < max unique views {n_uniq.max()}"
        )
    uniq = np.full((N, kk), -1, np.int32)
    rows = np.repeat(np.arange(N), flat.shape[1])
    uniq[rows, rank.reshape(-1)] = sf.reshape(-1).astype(np.int32)
    slots = np.empty_like(flat, dtype=np.int32)
    np.put_along_axis(slots, order, rank.astype(np.int32), axis=1)
    return uniq, slots.reshape(pi.shape).astype(np.int32)
