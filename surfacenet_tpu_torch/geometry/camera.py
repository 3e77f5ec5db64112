"""Pinhole camera model and projection geometry.

Port of ``surfacenet_tpu/geometry/camera.py``.  Conventions are the same:

  * ``P`` is a 3x4 projection matrix mapping homogeneous world points (mm)
    to homogeneous pixels: ``[u*w, v*w, w]^T = P @ [X, Y, Z, 1]^T``.
  * Pixel coordinates are (u, v) = (column, row), origin at the top-left.
  * A batch of cameras is a tensor of shape (V, 3, 4).

Projections are written out as elementwise float32 sums, not matrix
products, so no TF32 path can touch them, and the CUDA gather kernel
(``csrc/warp_gather.cu``) repeats exactly this arithmetic.  Division is
true division (the reference's Newton-refined reciprocal works around the
TPU's approximate reciprocal and is not needed here).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def project_rows(P: torch.Tensor, x, y, z):
    """The three homogeneous rows of ``P @ [x, y, z, 1]``.

    ``P`` is (..., 3, 4); x, y, z broadcast against ``P[..., r, c, None]``.
    Each row is summed left to right: ``((p0*x + p1*y) + p2*z) + p3``.
    """
    rows = []
    for r in range(3):
        rows.append(
            P[..., r, 0, None] * x + P[..., r, 1, None] * y
            + P[..., r, 2, None] * z + P[..., r, 3, None]
        )
    return rows


def project(P: torch.Tensor, pts: torch.Tensor, eps: float = 1e-8):
    """Project world points into pixel coordinates.

    Args:
      P: (..., 3, 4) projection matrix/matrices.
      pts: (..., N, 3) world points in mm.

    Returns:
      uv: (..., N, 2) pixel coordinates (u=col, v=row).
      depth: (..., N) homogeneous scale w (positive = in front).
    """
    nu, nv, w = project_rows(P, pts[..., 0], pts[..., 1], pts[..., 2])
    d = w + eps
    return torch.stack([nu / d, nv / d], dim=-1), w


def project_crop(P: torch.Tensor, pts: torch.Tensor, eps: float = 1e-8):
    """``project`` in float32 with the JAX package's rounding on the CPU,
    for the pair net's patch crops, which round uv to whole pixels (a
    last-bit difference moves a crop by a pixel at a .5 boundary).

    ``P`` (N, 3, 4) with one point each, ``pts`` (N, 3); or ``P`` (3, 4)
    with ``pts`` (N, 3).  XLA's CPU dot sums the first form, and the
    second below 8 points, as ``p0 x`` then fused multiply-adds of ``p1 y``
    and ``p2 z`` (here a float64 product and sum rounded once), then
    ``+ p3``; the second form at 8 points or more as
    ``(p0 x + p1 y) + (p2 z + p3)``.  Division is through the reference's
    Newton-refined reciprocal.  Returns uv (N, 2) and depth w (N,).
    """
    batched = P.dim() == 3
    Pb = P if batched else P[None]
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    rows = []
    for r in range(3):
        p0, p1, p2, p3 = (Pb[:, r, c] for c in range(4))
        if batched or pts.shape[0] < 8:
            acc = p0 * x
            acc = (p1.double() * y.double() + acc.double()).float()
            acc = (p2.double() * z.double() + acc.double()).float()
            rows.append(acc + p3)
        else:
            rows.append((p0 * x + p1 * y) + (p2 * z + p3))
    d = rows[2] + eps
    inv = 1.0 / d
    inv = inv * (2.0 - d * inv)
    return torch.stack([rows[0] * inv, rows[1] * inv], dim=-1), rows[2]


def camera_center(P: torch.Tensor) -> torch.Tensor:
    """Camera centre C = -M^{-1} p4 of P = [M | p4].  (..., 3, 4) -> (..., 3)."""
    M = P[..., :, :3]
    p4 = P[..., :, 3]
    return -torch.linalg.solve(M, p4.unsqueeze(-1)).squeeze(-1)


def look_at_projection(
    eye: np.ndarray,
    target: np.ndarray,
    up: np.ndarray,
    focal_px: float,
    principal: Tuple[float, float],
) -> np.ndarray:
    """Synthetic 3x4 projection matrix (host-side numpy, float64)."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)  # image v grows downward
    R = np.stack([right, down, fwd], axis=0)  # world -> cam
    t = -R @ eye
    K = np.array(
        [
            [focal_px, 0.0, principal[0]],
            [0.0, focal_px, principal[1]],
            [0.0, 0.0, 1.0],
        ]
    )
    return (K @ np.concatenate([R, t[:, None]], axis=1)).astype(np.float64)


def baseline_angle(P_a, P_b, point):
    """Cosine of the angle at ``point`` subtended by two camera centres."""
    va = camera_center(P_a) - point
    vb = camera_center(P_b) - point
    va = va / (torch.linalg.norm(va, dim=-1, keepdim=True) + 1e-8)
    vb = vb / (torch.linalg.norm(vb, dim=-1, keepdim=True) + 1e-8)
    return torch.sum(va * vb, dim=-1)


def in_frustum(P, pts, image_hw: Tuple[int, int], margin: float = 0.0):
    """Which points project inside the image with positive depth.

    P (3, 4) or (V, 3, 4); pts (N, 3) -> (N,) or (V, N) bool.
    """
    uv, w = project(P, pts)
    h, wpx = image_hw
    u, v = uv[..., 0], uv[..., 1]
    return (
        (w > 0)
        & (u >= -margin)
        & (u <= wpx - 1 + margin)
        & (v >= -margin)
        & (v <= h - 1 + margin)
    )


_CORNERS = (
    (0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1),
    (1, 1, 0), (1, 0, 1), (0, 1, 1), (1, 1, 1),
)


def cube_corners(origin: torch.Tensor, extent_mm: float) -> torch.Tensor:
    """The 8 corners of an axis-aligned cube. (..., 3) -> (..., 8, 3)."""
    offs = torch.tensor(_CORNERS, dtype=origin.dtype, device=origin.device)
    return origin[..., None, :] + extent_mm * offs


def cube_visible(P, origin, extent_mm: float, image_hw, margin: float = 0.0):
    """True where any corner of the cube lies in a view's frustum.

    P (V, 3, 4); origin (..., 3) -> (..., V) bool.
    """
    corners = cube_corners(origin, extent_mm)  # (..., 8, 3)
    vis = in_frustum(P, corners.reshape(-1, 3), image_hw, margin)
    vis = vis.reshape(P.shape[0], *corners.shape[:-2], 8).any(dim=-1)
    return torch.movedim(vis, 0, -1)


def estimate_bbox_from_cameras(
    Ps: np.ndarray, size_factor: float = 0.6
) -> Tuple[np.ndarray, np.ndarray]:
    """Scene bbox from calibrated cameras alone (host-side numpy).

    The least-squares point closest to all principal rays is the scene
    centre; the median camera-to-centre distance sets the scale.
    """
    Ps = np.asarray(Ps, np.float64)
    centers, dirs = [], []
    for P in Ps:
        M = P[:, :3]
        c = -np.linalg.solve(M, P[:, 3])
        d = M[2] / np.linalg.norm(M[2])
        if np.linalg.det(M) < 0:
            d = -d
        centers.append(c)
        dirs.append(d)
    centers = np.stack(centers)
    A = np.zeros((3, 3))
    b = np.zeros(3)
    for c, d in zip(centers, dirs):
        Pm = np.eye(3) - np.outer(d, d)
        A += Pm
        b += Pm @ c
    target = np.linalg.solve(A, b)
    dist = np.median(np.linalg.norm(centers - target, axis=1))
    half = size_factor * dist / 2.0
    return target - half, target + half


def voxel_centers(origin: torch.Tensor, D: int, s: float) -> torch.Tensor:
    """(D, D, D, 3) world centres ``origin + s * ([i, j, k] + 0.5)``."""
    r = (torch.arange(D, dtype=origin.dtype, device=origin.device) + 0.5) * s
    gi, gj, gk = torch.meshgrid(r, r, r, indexing="ij")
    return origin + torch.stack([gi, gj, gk], dim=-1)
