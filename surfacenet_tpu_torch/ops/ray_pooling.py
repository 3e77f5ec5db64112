"""Ray pooling: view-consistent thinning of the fused volume.

Port of ``surfacenet_tpu/ops/ray_pooling.py``: the exact mode, the
affine mode and its one-hot matmul form (``affine_matmul``).

Exact mode (``ray_max_mask_exact``): every voxel centre is projected into
the pooling view, voxels sharing a raster pixel (coarsened so that one ray
is about one voxel column) form a ray, and a voxel is a ray maximum when
its probability is within 1e-6 of the ray's maximum (the whole segment for
window 0, else the voxel's depth bin and its two neighbours, bins of
``window`` voxels of metric depth).  The reference computes it in XLA with
scatter-max; here it is ``scatter_reduce_(..., "amax")`` batched over
(cube, view) items.

Affine mode: within a
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

import contextlib
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from surfacenet_tpu_torch.geometry.camera import project, voxel_centers

NEG = -1e30
# side of the exact mode's raster window in (coarsened) pixels
RASTER = 128
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


@contextlib.contextmanager
def _ieee_float32_matmul():
    """float32 products in full float32 on the card (no TF32) inside the
    block, whatever the process-wide flag says; restored after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def ray_max_mask_affine_matmul(
    probs: torch.Tensor, origins: torch.Tensor, s: float, Ps: torch.Tensor,
    window: int = 0,
) -> torch.Tensor:
    """The affine ray-max mask of each item for its one view, with the
    shear as one-hot shift products (the reference's MXU form).

    The shift ``sh[t, i, j] = vol[t, i - oi_t, j - oj_t]`` of slab t is
    ``Arow_t @ vol_t @ Acol_t^T`` with one-hot ``Arow_t[i, r] = [r == i -
    oi_t]`` (and ``Acol_t`` alike); the unshear is the adjoint product with
    the same matrices.  Sheared positions outside the cube are NEG before
    the max; unsheared positions with no source get a ray maximum of 0,
    which keeps their voxel as a maximum, as NEG does in the other forms
    (probabilities are >= 0).  The products run as batched
    ``torch.matmul`` in float32 with TF32 off: the one-hot matrices are
    exact 0/1, so a product is then a lossless selection and the masks
    equal the reference's (at Precision.HIGHEST) bit for bit.  A plain
    product the reference computes outside any Pallas kernel, so a
    library call is the port; each item is transformed only along its own
    dominant axis.

    probs (N, D, D, D); origins (N, 3); Ps (N, 3, 4) -> (N, D, D, D) bool.
    """
    N, D = probs.shape[0], probs.shape[1]
    axis, slopes = item_params(origins, s, Ps, D)
    off = _shear_offsets(slopes, D)  # (N, D, 2): oi_t, oj_t
    ii = torch.arange(D, device=probs.device)
    mask = torch.zeros(probs.shape, dtype=torch.bool, device=probs.device)
    for a, perm in enumerate(PERMS):
        idx = torch.nonzero(axis == a)[:, 0]
        if idx.shape[0] == 0:
            continue
        order = (perm[2], perm[0], perm[1])  # slab axis first
        vols = probs[idx].float().permute(0, *(1 + q for q in order))
        src_i = ii[None, None, :] - off[idx, :, None, 0]  # (M, t, i)
        src_j = ii[None, None, :] - off[idx, :, None, 1]
        a_row = (src_i[..., None] == ii).float()  # (M, t, i, r)
        a_col = (src_j[..., None] == ii).float()  # (M, t, j, c)
        valid = (((src_i >= 0) & (src_i < D))[..., :, None]
                 & ((src_j >= 0) & (src_j < D))[..., None, :])
        with _ieee_float32_matmul():
            sh = torch.matmul(torch.matmul(a_row, vols),
                              a_col.transpose(-1, -2))
            sh = torch.where(valid, sh, NEG)
            if window > 0:
                M = F.max_pool1d(
                    sh.permute(0, 2, 3, 1).reshape(-1, 1, D),
                    2 * window + 1, stride=1, padding=window,
                ).reshape(sh.shape[0], D, D, D).permute(0, 3, 1, 2)
            else:
                M = sh.amax(dim=1, keepdim=True).expand_as(sh)
            rm = torch.matmul(a_row.transpose(-1, -2),
                              torch.matmul(M, a_col))
        is_max = vols >= rm - 1e-6
        mask[idx] = is_max.permute(0, *(1 + np.argsort(order)).tolist())
    return mask


def ray_max_mask_exact(
    probs: torch.Tensor, origins: torch.Tensor, s: float, Ps: torch.Tensor,
    window: int = 0,
) -> torch.Tensor:
    """Exact ray-max mask of each item for its one pooling view.

    The reference's ``ray_max_mask_single_view`` (with its defaults) over
    items: a raster of ``RASTER``^2 pixels anchored at the footprint's first
    pixel, coarsened so that one ray is about one voxel footprint and the
    footprint fits; voxels outside the raster or behind the camera are never
    maxima.

    Args:
      probs: (N, D, D, D) probability volumes; origins: (N, 3) cube
        corners (mm); Ps: (N, 3, 4) the pooling view of each item.
      window: 0 = segment max over the volume; > 0 = max over the voxel's
        depth bin (``window`` voxels of metric depth) and its neighbours.

    Returns (N, D, D, D) bool.
    """
    N, D = probs.shape[0], probs.shape[1]
    R = RASTER
    NB = 1 if window <= 0 else int(np.ceil(D * 1.7322 / window)) + 2
    dev = probs.device
    centers = (voxel_centers(torch.zeros(3, device=dev), D, s).reshape(-1, 3)
               + origins.float()[:, None, :])  # (N, D^3, 3)
    Pf = Ps.float()
    uv, w = project(Pf, centers)
    u, v = uv[..., 0], uv[..., 1]
    infront = w > 0
    big = 1e9

    def masked_min(x, fill):
        return torch.where(infront, x, fill).amin(dim=1, keepdim=True)

    u_min, v_min = masked_min(u, big), masked_min(v, big)
    u_max, v_max = -masked_min(-u, big), -masked_min(-v, big)
    extent = torch.maximum(u_max - u_min, v_max - v_min)
    # one ray ~ one voxel column, never finer than 1 px, and the footprint
    # fits the raster
    scale = torch.clamp(extent / D, min=1.0)
    scale = torch.maximum(scale, (extent + 1.0) / (R - 1))
    # non-finite coordinates (points on the camera plane) are never inside:
    # zero them before the cast so the integer arithmetic stays defined
    ui = torch.floor(torch.nan_to_num(u / scale)).long()
    vi = torch.floor(torch.nan_to_num(v / scale)).long()
    uu = ui - masked_min(ui, 2**30)
    vv = vi - masked_min(vi, 2**30)
    inside = infront & (uu >= 0) & (uu < R) & (vv >= 0) & (vv < R)
    pid = torch.clamp(vv * R + uu, 0, R * R - 1)
    pf = probs.reshape(N, -1).float()
    contrib = torch.where(inside, pf, NEG)

    if window <= 0:
        cell = pid
    else:
        # metric ray depth: w / ||P[2, :3]|| is depth in mm for any row
        # scaling of P; bins of `window` voxels of depth
        depth = w / (torch.linalg.vector_norm(Pf[:, 2, :3], dim=-1,
                                              keepdim=True) + 1e-12)
        dmin = masked_min(depth, big)
        b = torch.clamp(
            torch.floor(torch.nan_to_num((depth - dmin) / (window * s)))
            .long(), 0, NB - 1)
        cell = pid * NB + b
    base = torch.arange(N, device=dev)[:, None] * (R * R * NB)
    buf = torch.full((N * R * R * NB,), NEG, dtype=pf.dtype, device=dev)
    buf.scatter_reduce_(0, (base + cell).reshape(-1), contrib.reshape(-1),
                        "amax")
    ray_max = buf[base + cell]
    if window > 0:
        row = base + pid * NB
        lo = torch.where(b > 0, buf[row + torch.clamp(b - 1, min=0)], NEG)
        hi = torch.where(b < NB - 1,
                         buf[row + torch.clamp(b + 1, max=NB - 1)], NEG)
        ray_max = torch.maximum(ray_max, torch.maximum(lo, hi))
    is_max = inside & (pf >= ray_max - 1e-6) & (ray_max > NEG / 2)
    return is_max.reshape(probs.shape)


def ray_pool(
    probs: torch.Tensor, origins: torch.Tensor, s: float,
    Ps_pool: torch.Tensor, taus, gamma: float,
    view_mask: Optional[torch.Tensor] = None, window: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact thinning of a batch of cubes (the reference's ``ray_pool``
    over cubes, ``ray_pool_batch``, in its exact mode).

    A voxel survives when it is a ray maximum in at least
    ``max(ceil(gamma * n_views), 1)`` of its cube's active pooling views
    and its probability exceeds the cube's tau.

    Args:
      probs: (N, D, D, D); origins: (N, 3); Ps_pool: (N, K, 3, 4);
        taus: (N,) or a scalar.
      view_mask: (N, K) bool; False marks padded slots that neither vote
        nor count in the gamma denominator.

    Returns (occupancy (N, D, D, D) bool, votes (N, D, D, D) int32).
    """
    N, D = probs.shape[0], probs.shape[1]
    K = Ps_pool.shape[1]
    items = probs.repeat_interleave(K, dim=0)
    item_origins = origins.repeat_interleave(K, dim=0)
    item_Ps = Ps_pool.reshape(N * K, 3, 4)
    masks = ray_max_mask_exact(items, item_origins, s, item_Ps,
                               window).reshape(N, K, D, D, D)
    if view_mask is None:
        n_views = torch.full((N,), K, device=probs.device)
    else:
        masks = masks & view_mask[:, :, None, None, None]
        n_views = view_mask.sum(dim=1)
    votes = masks.sum(dim=1, dtype=torch.int32)
    need = torch.clamp(torch.ceil(gamma * n_views.float()).to(torch.int32),
                       min=1)
    taus = torch.as_tensor(taus, dtype=torch.float32, device=probs.device)
    occ = ((votes >= need[:, None, None, None])
           & (probs > taus.expand(N)[:, None, None, None]))
    return occ, votes
