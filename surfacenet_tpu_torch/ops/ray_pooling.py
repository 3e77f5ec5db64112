"""Affine ray pooling: view-consistent thinning of the fused volume.

Port of the affine half of ``surfacenet_tpu/ops/ray_pooling.py``.  Within a
cube small next to its camera distance, the projection is near-affine and
viewing rays are straight lines in voxel space with direction
n = cross(dudx, dvdx).  Along the dominant axis of n, slab t is sheared by
``round(sl * (t - D//2))`` (round half to even) with slopes
sl = n_other / n_dominant, and a voxel is a ray maximum when its
probability is within 1e-6 of the maximum along its sheared ray (the whole
segment for window 0, else +-window slabs).  Positions sheared out of the
cube are NEG both ways, so a voxel whose ray leaves the cube counts as a
maximum.

``ray_max_mask_affine_plain`` is the plain PyTorch version of the
affine-pool CUDA kernel (``ops/cuda/affine_pool.py``): one mask per (cube,
view) item.  ``ray_vote_affine_plain`` is the plain version of the
affine-vote CUDA kernel (``ops/cuda/affine_vote.py``): the sum of those
masks over the active views of each cube.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

NEG = -1e30
# (o1, o2, dominant) axis permutation for each dominant ray axis
PERMS = ((1, 2, 0), (0, 2, 1), (0, 1, 2))


def _projection_jacobian(P: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """d(u, v)/d(xyz) of the projection at x.  P (..., 3, 4), x (..., 3) -> (..., 2, 3)."""
    def row(r):
        return (
            P[..., r, 0] * x[..., 0] + P[..., r, 1] * x[..., 1]
            + P[..., r, 2] * x[..., 2] + P[..., r, 3]
        )

    num = torch.stack([row(0), row(1)], dim=-1)  # (..., 2)
    den = row(2)[..., None, None]
    return (
        P[..., :2, :3] * den - num[..., :, None] * P[..., 2:3, :3]
    ) / (den * den)


def vote_params(
    origins: torch.Tensor, s: float, Ps_pool: torch.Tensor,
    view_mask: torch.Tensor, D: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dominant ray axis and shear slopes per (cube, pooling view).

    Jacobian at the cube centre ``origin + D*s/2``; n = cross(A[0], A[1]);
    axis = argmax |n|; sl = clip(n_other / n_axis, -1, 1) for the two other
    axes in ``PERMS`` order, all in float32.

    Args:
      origins: (N, 3); Ps_pool: (N, K, 3, 4); view_mask: (N, K) bool.

    Returns:
      axis (N, K) int32, -1 for masked slots; slopes (N, K, 2) float32.
    """
    centers = origins.float() + 0.5 * D * s  # (N, 3)
    A = _projection_jacobian(Ps_pool.float(), centers[:, None, :])
    n = torch.linalg.cross(A[..., 0, :], A[..., 1, :])  # (N, K, 3)
    axis = torch.argmax(n.abs(), dim=-1)  # (N, K)
    # PERMS[axis], built on the device (no host-to-device copy)
    perms = torch.stack(
        [(axis == 0).long(), 2 - (axis == 2).long(), axis], dim=-1
    )
    comp = torch.gather(n, -1, perms)  # (n_o1, n_o2, n_dom)
    na = comp[..., 2]
    safe = torch.where(na.abs() < 1e-12, 1e-12, na)
    slopes = (comp[..., :2] / safe[..., None]).clamp(-1.0, 1.0)
    axis = torch.where(view_mask.bool(), axis, -1).to(torch.int32)
    return axis, slopes.contiguous()


def _shear_offsets(slopes: torch.Tensor, D: int) -> torch.Tensor:
    """(..., 2) slopes -> (..., D, 2) int64 offsets round(sl * (t - D//2))."""
    tf = (torch.arange(D, device=slopes.device) - D // 2).float()
    return torch.round(slopes[..., None, :] * tf[:, None]).long()


def _ray_max_sheared(p: torch.Tensor, off: torch.Tensor, window: int):
    """Ray-max mask of volumes with the ray axis last.

    p: (M, D, D, D) indexed [a, b, t]; off: (M, D, 2) shear offsets per t.
    Returns (M, D, D, D) bool: p[a, b, t] >= raymax(a, b, t) - 1e-6.
    """
    M, D = p.shape[0], p.shape[1]
    ar = torch.arange(D, device=p.device)
    oi = off[..., 0][:, None, :]  # (M, 1, T)
    oj = off[..., 1][:, None, :]
    m_idx = torch.arange(M, device=p.device)[:, None, None, None]
    t_idx = ar[None, None, None, :]

    def take(vol, ai, bi):  # vol[m, ai, bi, t], NEG outside the cube
        okA = (ai >= 0) & (ai < D)  # (M, D, T)
        okB = (bi >= 0) & (bi < D)
        got = vol[m_idx, ai.clamp(0, D - 1)[:, :, None, :],
                  bi.clamp(0, D - 1)[:, None, :, :], t_idx]
        ok = okA[:, :, None, :] & okB[:, None, :, :]
        return torch.where(ok, got, NEG)

    # shear: shifted[a, b, t] = p[a - oi(t), b - oj(t), t]
    shifted = take(p, ar[None, :, None] - oi, ar[None, :, None] - oj)
    if window > 0:
        # max over +-window slabs; padding never wins (the centre is real)
        ray = F.max_pool1d(
            shifted.reshape(M * D * D, 1, D), 2 * window + 1, stride=1,
            padding=window,
        ).reshape(M, D, D, D)
    else:
        ray = shifted.amax(dim=-1, keepdim=True).expand(M, D, D, D)
    # unshear: raymax[i, j, t] = ray[i + oi(t), j + oj(t), t]
    rm = take(ray, ar[None, :, None] + oi, ar[None, :, None] + oj)
    return p >= rm - 1e-6


def ray_max_mask_affine(prob, origin, s: float, P, window: int = 0):
    """Affine ray-max mask of one (D, D, D) volume for one view (3, 4)."""
    return ray_max_mask_affine_batch(prob[None], origin[None], s, P[None],
                                     window)[0]


def ray_max_mask_affine_plain(
    probs: torch.Tensor, axis: torch.Tensor, slopes: torch.Tensor,
    window: int = 0,
) -> torch.Tensor:
    """Affine ray-max mask of each item for its one view.

    The plain version of the affine-pool kernel.

    Args:
      probs: (M, D, D, D) float32 probability volumes.
      axis: (M,) int32 dominant ray axis per item (an item with none of
        0, 1, 2 gets an all-False mask).
      slopes: (M, 2) float32 shear slopes (``vote_params``).

    Returns (M, D, D, D) bool.
    """
    D = probs.shape[1]
    mask = torch.zeros(probs.shape, dtype=torch.bool, device=probs.device)
    for a, perm in enumerate(PERMS):
        idx = torch.nonzero(axis == a)[:, 0]
        if idx.shape[0] == 0:
            continue
        p = probs[idx].permute(0, *(1 + q for q in perm))
        m = _ray_max_sheared(p, _shear_offsets(slopes[idx], D), window)
        mask[idx] = m.permute(0, *(1 + np.argsort(perm)).tolist())
    return mask


def ray_max_mask_affine_batch(
    probs: torch.Tensor, origins: torch.Tensor, s: float, Ps: torch.Tensor,
    window: int = 0,
) -> torch.Tensor:
    """``ray_max_mask_affine`` over items: (N, D, D, D) bool.

    probs (N, D, D, D); origins (N, 3); Ps (N, 3, 4) one pooling view per
    item.  Counterpart of the reference's ``vmap(ray_max_mask_affine)``.
    """
    axis, slopes = item_params(origins, s, Ps, probs.shape[1])
    return ray_max_mask_affine_plain(probs.float(), axis, slopes, window)


def item_params(origins, s, Ps, D):
    """``vote_params`` for one active view per item: axis (N,), slopes (N, 2)."""
    ones = torch.ones((Ps.shape[0], 1), dtype=torch.bool, device=Ps.device)
    axis, slopes = vote_params(origins, s, Ps[:, None], ones, D)
    return axis[:, 0].contiguous(), slopes[:, 0].contiguous()


def ray_vote_affine_plain(
    fused: torch.Tensor, axis: torch.Tensor, slopes: torch.Tensor,
    window: int = 0,
) -> torch.Tensor:
    """Per-cube vote: how many active views find each voxel a ray maximum.

    The plain version of the affine-vote kernel.

    Args:
      fused: (N, D, D, D) float32 probability volumes.
      axis: (N, K) int32 dominant ray axis per pooling view, -1 = inactive.
      slopes: (N, K, 2) float32 shear slopes (``vote_params``).

    Returns votes (N, D, D, D) int32.
    """
    n_idx, k_idx = torch.nonzero(axis >= 0).unbind(1)  # active (cube, view)
    mask = ray_max_mask_affine_plain(fused[n_idx], axis[n_idx, k_idx],
                                     slopes[n_idx, k_idx], window)
    votes = torch.zeros(fused.shape, dtype=torch.int32, device=fused.device)
    return votes.index_add_(0, n_idx, mask.to(torch.int32))
