"""Reconstruction metrics: DTU-style accuracy and completeness.

Port of ``surfacenet_tpu/utils/metrics.py``:

  * accuracy: mean distance from predicted points to the ground truth;
  * completeness: mean distance from ground-truth points to the prediction.

Nearest neighbours are a chunked brute force on the device: one (n, m)
squared-distance matrix per chunk of queries through the expansion
``|q|^2 + |r|^2 - 2 q.r``, the product a float32 matrix product.  On the
card ``resolve_device`` keeps TF32 off: its ~3 decimal digits would put
~0.1% of error on the distances (the reference asks for
``Precision.HIGHEST`` for the same reason).

``accuracy_completeness`` clamps outliers and averages over all points (the
golden tests' metric); ``dtu_eval`` with an ``ObsMask`` and a plane follows
the official DTU protocol (Jensen et al., CVPR 2014): accuracy over
predicted points inside the observability mask, completeness over
ground-truth points on the kept side of the plane, distances beyond
``max_dist`` dropped, medians beside the means.

Every function takes ``device`` ("cuda" by default, which fails without a
card; "cpu" runs on the CPU).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from surfacenet_tpu_torch.device import resolve_device


def min_dists(query: np.ndarray, ref: np.ndarray, chunk: int = 4096,
              device="cuda") -> np.ndarray:
    """For each query point (n, 3), the distance to its nearest ref point
    (m, 3): (n,) float32."""
    dev = resolve_device(device)
    ref_t = torch.as_tensor(np.asarray(ref, np.float32), device=dev)
    rn = (ref_t * ref_t).sum(dim=-1)[None]  # (1, m)
    query = np.asarray(query, np.float32)
    out = np.empty(len(query), np.float32)
    for i in range(0, len(query), chunk):
        q = torch.as_tensor(query[i:i + chunk], device=dev)
        qn = (q * q).sum(dim=-1, keepdim=True)  # (c, 1)
        d2 = qn + rn - 2.0 * (q @ ref_t.T)
        out[i:i + chunk] = torch.sqrt(
            torch.clamp(d2.amin(dim=-1), min=0.0)).cpu().numpy()
    return out


def accuracy_completeness(
    pred_points: np.ndarray, gt_points: np.ndarray,
    max_dist: Optional[float] = None, device="cuda",
) -> Tuple[float, float]:
    """(accuracy_mm, completeness_mm), lower is better; inf without
    predictions.  ``max_dist`` clamps the distances in both directions."""
    if len(pred_points) == 0:
        return float("inf"), float("inf")
    acc = min_dists(pred_points, gt_points, device=device)
    comp = min_dists(gt_points, pred_points, device=device)
    if max_dist is not None:
        acc = np.minimum(acc, max_dist)
        comp = np.minimum(comp, max_dist)
    return float(acc.mean()), float(comp.mean())


def voxel_set_agreement(a: np.ndarray, b: np.ndarray) -> float:
    """Shared voxel centres over the union of two point sets (points
    rounded to 1e-3 mm): 1.0 when two sweeps kept the same voxels."""
    A = set(map(tuple, np.round(a, 3)))
    B = set(map(tuple, np.round(b, 3)))
    return len(A & B) / max(len(A | B), 1)


@dataclasses.dataclass
class ObsMask:
    """DTU-style observability mask: a boolean voxel volume over the scan
    (the official ``ObsMask`` with origin ``BB(1,:)`` and resolution
    ``Res``).  Accuracy counts only predictions inside observed voxels."""

    vol: np.ndarray  # (X, Y, Z) bool
    origin: np.ndarray  # (3,) mm, min corner of voxel (0, 0, 0)
    res_mm: float

    def contains(self, pts: np.ndarray) -> np.ndarray:
        """(N, 3) points -> (N,) bool: inside an observed voxel."""
        pts = np.asarray(pts, np.float64)
        idx = np.floor((pts - self.origin) / self.res_mm).astype(np.int64)
        ok = np.all(idx >= 0, axis=1) & np.all(
            idx < np.asarray(self.vol.shape), axis=1
        )
        out = np.zeros(len(pts), bool)
        ii = idx[ok]
        out[ok] = self.vol[ii[:, 0], ii[:, 1], ii[:, 2]]
        return out

    def save(self, path: str) -> None:
        np.savez_compressed(
            path, vol=self.vol.astype(bool), origin=self.origin,
            res_mm=np.float64(self.res_mm),
        )

    @classmethod
    def load(cls, path: str) -> "ObsMask":
        with np.load(path) as z:
            return cls(
                vol=z["vol"].astype(bool),
                origin=np.asarray(z["origin"], np.float64),
                res_mm=float(z["res_mm"]),
            )

    @classmethod
    def from_cameras(
        cls, Ps: np.ndarray, image_hw: Tuple[int, int],
        bbox_min: np.ndarray, bbox_max: np.ndarray, res_mm: float = 4.0,
        min_views: int = 2,
    ) -> "ObsMask":
        """Observable = inside at least ``min_views`` camera frusta (the
        camera-only counterpart of DTU's structured-light coverage)."""
        bbox_min = np.asarray(bbox_min, np.float64)
        bbox_max = np.asarray(bbox_max, np.float64)
        shape = np.maximum(
            np.ceil((bbox_max - bbox_min) / res_mm).astype(int), 1
        )
        ax = [
            bbox_min[a] + (np.arange(shape[a]) + 0.5) * res_mm
            for a in range(3)
        ]
        gx, gy, gz = np.meshgrid(*ax, indexing="ij")
        pts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
        ph = np.concatenate([pts, np.ones((len(pts), 1))], axis=1)
        H, W = image_hw
        nvis = np.zeros(len(pts), np.int32)
        for P in np.asarray(Ps, np.float64):
            uvw = ph @ P.T  # (N, 3)
            w = uvw[:, 2]
            infront = w > 1e-9
            u = np.where(infront, uvw[:, 0] / np.where(infront, w, 1), -1)
            v = np.where(infront, uvw[:, 1] / np.where(infront, w, 1), -1)
            nvis += (
                infront & (u >= 0) & (u < W) & (v >= 0) & (v < H)
            ).astype(np.int32)
        vol = (nvis >= min_views).reshape(tuple(shape))
        return cls(vol=vol, origin=bbox_min, res_mm=res_mm)


def dtu_eval(
    pred_points: np.ndarray, gt_points: np.ndarray, max_dist: float = 20.0,
    obs_mask: Optional[ObsMask] = None, plane: Optional[np.ndarray] = None,
    device="cuda",
) -> dict:
    """Official-protocol DTU evaluation.

    Accuracy over predicted points inside ``obs_mask``, against the whole
    ground truth; completeness over ground-truth points with
    ``plane . [x, 1] > 0``, against the whole prediction; distances beyond
    ``max_dist`` dropped from the means.

    Returns acc_mean_mm / acc_median_mm / comp_mean_mm / comp_median_mm /
    overall_mm (mean of the two means), the point counts before and after
    masking, and the dropped-outlier fractions.
    """
    pred = np.asarray(pred_points, np.float32).reshape(-1, 3)
    gt = np.asarray(gt_points, np.float32).reshape(-1, 3)
    n_pred_total, n_gt_total = len(pred), len(gt)
    if obs_mask is not None and len(pred):
        pred_eval = pred[obs_mask.contains(pred)]
    else:
        pred_eval = pred
    if plane is not None and len(gt):
        plane = np.asarray(plane, np.float64).reshape(4)
        side = gt @ plane[:3] + plane[3]
        gt_eval = gt[side > 0]
    else:
        gt_eval = gt

    inf = float("inf")
    out = {
        "n_pred_total": n_pred_total,
        "n_pred_eval": int(len(pred_eval)),
        "n_gt_total": n_gt_total,
        "n_gt_eval": int(len(gt_eval)),
        "max_dist_mm": float(max_dist),
    }
    if len(pred_eval) == 0 or len(gt_eval) == 0:
        out.update(
            acc_mean_mm=inf, acc_median_mm=inf, comp_mean_mm=inf,
            comp_median_mm=inf, overall_mm=inf,
            acc_outlier_frac=0.0, comp_outlier_frac=0.0,
        )
        return out

    acc_d = min_dists(pred_eval, gt, device=device)
    comp_d = min_dists(gt_eval, pred, device=device)
    acc_keep = acc_d[acc_d <= max_dist]
    comp_keep = comp_d[comp_d <= max_dist]

    def _mm(x, f):
        return float(f(x)) if len(x) else inf

    out.update(
        acc_mean_mm=_mm(acc_keep, np.mean),
        acc_median_mm=_mm(acc_keep, np.median),
        comp_mean_mm=_mm(comp_keep, np.mean),
        comp_median_mm=_mm(comp_keep, np.median),
        acc_outlier_frac=float((acc_d > max_dist).mean()),
        comp_outlier_frac=float((comp_d > max_dist).mean()),
    )
    out["overall_mm"] = 0.5 * (out["acc_mean_mm"] + out["comp_mean_mm"])
    return out
