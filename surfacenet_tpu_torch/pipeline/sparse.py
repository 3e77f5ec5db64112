"""Sparse cube store + overlap merge.

Port of the numpy path of ``surfacenet_tpu/pipeline/sparse.py``.  The
sweep adds per-cube results (thinned occupancy, fused probability, colour)
keyed by the cube's lattice index; ``merge`` resolves overlaps: a global
voxel survives when the occupied fraction of the processed cubes that
contain it is >= ``occupancy_vote``, and its probability and colour are
averaged over the cubes that mark it occupied.

Not ported yet: the resume ledger, the native C++ merge and the
connected-component denoise (``min_component``); see ROADMAP.md.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from surfacenet_tpu_torch.utils.ply import write_ply


@dataclasses.dataclass
class CubeResult:
    """Result for one cube, keyed by its integer grid index."""

    grid_idx: Tuple[int, int, int]
    occupancy: np.ndarray  # (D, D, D) bool, thinned
    prob: np.ndarray  # (D, D, D) float32 fused probability
    color: Optional[np.ndarray] = None  # (D, D, D, 3) float32 in [0, 1]


class SparseCubeStore:
    """Accumulates non-empty cube results and merges overlaps.

    Cube at grid index g owns local voxels ``g * stride + (i, j, k)``; the
    world position of a voxel is ``scene_origin + s * (coord + 0.5)``.
    """

    def __init__(
        self,
        scene_origin: np.ndarray,
        voxel_size_mm: float,
        cube_size: int,
        stride: int,
        occupancy_vote: float = 0.5,
    ):
        self.scene_origin = np.asarray(scene_origin, np.float64)
        self.s = float(voxel_size_mm)
        self.D = int(cube_size)
        self.stride = int(stride)
        self.occupancy_vote = float(occupancy_vote)
        self._cubes: Dict[Tuple[int, int, int], CubeResult] = {}
        self._done: set = set()

    def add(self, result: CubeResult) -> None:
        g = tuple(int(v) for v in result.grid_idx)
        self._done.add(g)
        if result.occupancy.any():
            self._cubes[g] = result
        else:
            self._cubes.pop(g, None)

    def merge(
        self, occupancy_vote: Optional[float] = None
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Merge all cubes into deduplicated global voxels.

        Returns points (N, 3) float32 world voxel centres (mm), probs (N,)
        and colors (N, 3) in [0, 1].
        """
        if occupancy_vote is None:
            occupancy_vote = self.occupancy_vote
        if not self._cubes:
            return (
                np.zeros((0, 3), np.float32),
                np.zeros((0,), np.float32),
                np.zeros((0, 3), np.float32),
            )
        coords, probv, colorv = [], [], []
        for g, res in self._cubes.items():
            occ = res.occupancy
            idx = np.argwhere(occ)
            coords.append(np.asarray(g, np.int64) * self.stride + idx)
            probv.append(res.prob[occ].astype(np.float32))
            if res.color is not None:
                colorv.append(res.color[occ].astype(np.float32))
            else:
                colorv.append(np.full((len(idx), 3), 0.5, np.float32))
        coords = np.concatenate(coords, axis=0)
        probv = np.concatenate(probv)
        colorv = np.concatenate(colorv, axis=0)

        cmin = coords.min(axis=0)
        rel = coords - cmin
        dims = rel.max(axis=0) + 1
        lin = (rel[:, 0] * dims[1] + rel[:, 1]) * dims[2] + rel[:, 2]
        uniq, first, inv = np.unique(lin, return_index=True,
                                     return_inverse=True)
        n = len(uniq)
        votes = np.bincount(inv, minlength=n).astype(np.float32)
        prob_sum = np.bincount(inv, weights=probv, minlength=n)
        color_sum = np.stack([
            np.bincount(inv, weights=colorv[:, c], minlength=n)
            for c in range(3)
        ], axis=-1)
        contain = self._containment_counts(coords[first])

        keep = votes / np.maximum(contain, 1.0) >= occupancy_vote
        kcoords = coords[first][keep]
        probs = (prob_sum[keep] / votes[keep]).astype(np.float32)
        colors = (color_sum[keep] / votes[keep][:, None]).astype(np.float32)
        pts = self.scene_origin + self.s * (kcoords + 0.5)
        return pts.astype(np.float32), probs, np.clip(colors, 0.0, 1.0)

    def _containment_counts(self, coords: np.ndarray) -> np.ndarray:
        """For each global voxel coord, count processed cubes containing it.

        A cube at grid g contains voxel c iff g*stride <= c < g*stride + D;
        candidate g per axis: ceil((c - D + 1)/stride) .. floor(c/stride).
        """
        counts = np.zeros(len(coords), np.float32)
        if not len(coords) or not self._done:
            return counts
        done = np.asarray(sorted(self._done), np.int64).reshape(-1, 3)
        gmin = done.min(axis=0)
        span = done.max(axis=0) - gmin + 1

        def key(g):
            r = g - gmin
            return (r[:, 0] * span[1] + r[:, 1]) * span[2] + r[:, 2]

        done_keys = np.sort(key(done))
        lo = -(-(coords - self.D + 1) // self.stride)
        hi = coords // self.stride
        n_off = int((hi - lo).max()) + 1
        for di in range(n_off):
            for dj in range(n_off):
                for dk in range(n_off):
                    g = lo + np.array([di, dj, dk])
                    ok = (g <= hi).all(axis=1)
                    ok &= ((g >= gmin) & (g < gmin + span)).all(axis=1)
                    k = key(g[ok])
                    pos = np.searchsorted(done_keys, k)
                    hit = (pos < len(done_keys)) & (
                        done_keys[np.minimum(pos, len(done_keys) - 1)] == k
                    )
                    counts[np.flatnonzero(ok)[hit]] += 1
        return counts

    def export_ply(self, path: str, occupancy_vote: Optional[float] = None) -> int:
        pts, probs, colors = self.merge(occupancy_vote)
        write_ply(path, pts, colors)
        return len(pts)
