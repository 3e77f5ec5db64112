"""Training scene with a ground-truth point cloud (a DTU reference scan).

Own copy of ``surfacenet_tpu/data/scene.py::PointCloudScene``.  Training
needs, per scene, images, projection matrices and a surface to sample
cubes near and to voxelize into labels.  The synthetic scenes
(``data/synthetic.py``) have an analytic surface; this one has the
ground-truth points: occupancy is a voxel centre within half a voxel
diagonal of the nearest point, and cubes are sampled at the points.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class PointCloudScene:
    """Ground-truth-point-cloud training scene."""

    images: np.ndarray  # (V, H, W, 3) float in [0, 1]
    Ps: np.ndarray  # (V, 3, 4)
    gt_points: np.ndarray  # (N, 3) mm
    bbox_min: np.ndarray = None
    bbox_max: np.ndarray = None
    name: str = ""

    def __post_init__(self):
        if self.bbox_min is None:
            pad = 5.0
            self.bbox_min = self.gt_points.min(axis=0) - pad
            self.bbox_max = self.gt_points.max(axis=0) + pad

    def surface_points(self, n: int, seed: int = 0) -> np.ndarray:
        rng = np.random.default_rng(seed)
        idx = rng.integers(0, len(self.gt_points), n)
        return self.gt_points[idx]

    def surface_distance(self, pts: np.ndarray) -> np.ndarray:
        """Exact distance to the nearest ground-truth point, float32.

        A host KD-tree (scipy's ``cKDTree``, ~1 us a query): label pools
        query tens of millions of voxel centres.  Without scipy, the
        port's brute force (``utils/metrics.py::min_dists``) on the CPU,
        which is only practical at test sizes.
        """
        shape = pts.shape[:-1]
        flat = np.asarray(pts, np.float64).reshape(-1, 3)
        try:
            from scipy.spatial import cKDTree
        except ImportError:
            from surfacenet_tpu_torch.utils.metrics import min_dists

            return min_dists(flat.astype(np.float32), self.gt_points,
                             device="cpu").reshape(shape)
        if not hasattr(self, "_kdtree"):
            object.__setattr__(self, "_kdtree", cKDTree(self.gt_points))
        d, _ = self._kdtree.query(flat, k=1, workers=-1)
        return d.astype(np.float32).reshape(shape)

    def occupancy(self, centers: np.ndarray, s: float) -> np.ndarray:
        return self.surface_distance(centers) <= (s * np.sqrt(3) / 2)

    @staticmethod
    def from_scan(scan, gt_ply_path: str) -> "PointCloudScene":
        """From a ``data/dtu.py`` ``Scan`` and a ground-truth ``.ply``."""
        from surfacenet_tpu_torch.utils.ply import read_ply

        gt, _ = read_ply(gt_ply_path)
        return PointCloudScene(
            images=scan.images, Ps=scan.Ps, gt_points=gt,
            bbox_min=scan.bbox_min, bbox_max=scan.bbox_max,
            name=scan.name,
        )
