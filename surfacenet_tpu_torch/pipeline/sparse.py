"""Sparse cube store, resume ledger and overlap merge.

Port of ``surfacenet_tpu/pipeline/sparse.py``.  The sweep adds per-cube
results (thinned occupancy, fused probability, colour) keyed by the cube's
lattice index; ``merge`` resolves overlaps: a global voxel survives when
the occupied fraction of the processed cubes that contain it is >=
``occupancy_vote``, and its probability and colour are averaged over the
cubes that mark it occupied.  ``min_component`` / ``keep_top_components``
then drop small 26-connected clusters (``ops/denoise.py``).

The merge runs the C++ library of ``native/`` (built at first use; a
failed build raises).  ``merge_backend="numpy"`` runs the plain versions
instead (the numpy merge below and the numpy components): float64 sums
where the native merge sums in float32, and points in sorted order where
the native merge gives its hash map's order.

With ``ledger_path`` every added cube is appended to a JSON-lines ledger,
empty cubes included, in the reference's record format (a ledger written
by either package resumes in the other); a store opened on an existing
ledger re-hydrates its cubes and ``done_set`` lists them, so a killed
sweep resumes where it stopped.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional, Tuple

import numpy as np

from surfacenet_tpu_torch.utils.ply import write_ply

MERGE_BACKENDS = ("native", "numpy")


def ledger_records(path: str):
    """The ledger's records in order, read only; a torn line (a process
    killed mid-append) is skipped."""
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                yield json.loads(line)
            except json.JSONDecodeError:
                continue


def ledger_done_set(path: Optional[str]) -> set:
    """Grid indices of every cube a ledger holds (empty ones included),
    read without opening a store on it; empty without a ledger."""
    if not path or not os.path.exists(path):
        return set()
    return {tuple(int(v) for v in rec["grid_idx"])
            for rec in ledger_records(path)}


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
        ledger_path: Optional[str] = None,
        occupancy_vote: float = 0.5,
        merge_backend: str = "native",
    ):
        if merge_backend not in MERGE_BACKENDS:
            raise ValueError(f"merge_backend={merge_backend!r}: use one of "
                             f"{MERGE_BACKENDS}")
        self.scene_origin = np.asarray(scene_origin, np.float64)
        self.s = float(voxel_size_mm)
        self.D = int(cube_size)
        self.stride = int(stride)
        # 0.0 for core-claiming sweeps: each voxel has one owning cube
        self.occupancy_vote = float(occupancy_vote)
        self.merge_backend = merge_backend
        self._cubes: Dict[Tuple[int, int, int], CubeResult] = {}
        self._done: set = set()
        self.ledger_path = ledger_path
        if ledger_path and os.path.exists(ledger_path):
            self._load_ledger()

    def add(self, result: CubeResult) -> None:
        g = tuple(int(v) for v in result.grid_idx)
        if not result.occupancy.any():
            # recorded as done-and-empty, for resume
            self._cubes.pop(g, None)
            self._log_done(g, empty=True)
            return
        self._cubes[g] = result
        self._log_done(g, empty=False, result=result)

    def done_set(self) -> set:
        """Grid indices of every processed cube, empty ones included."""
        return set(self._done)

    def __len__(self) -> int:
        return len(self._cubes)

    def _log_done(self, g, empty: bool, result: CubeResult = None) -> None:
        self._done.add(g)
        if not self.ledger_path:
            return
        os.makedirs(os.path.dirname(self.ledger_path) or ".", exist_ok=True)
        rec = {"grid_idx": list(g), "empty": bool(empty)}
        if result is not None and not empty:
            # sparse record: indices and values of the occupied voxels
            occ = result.occupancy
            rec["occ_idx"] = np.argwhere(occ).astype(int).tolist()
            rec["prob"] = result.prob[occ].astype(float).round(4).tolist()
            if result.color is not None:
                rec["color"] = (result.color[occ].astype(float).round(4)
                                .tolist())
        with open(self.ledger_path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def _load_ledger(self) -> None:
        """Re-hydrate the ledger's cubes.  A process killed mid-append
        leaves a torn last line: it is skipped (that cube is redone), and
        ended with a newline so that the next record starts a line of its
        own (the reference's store would append to the torn line and lose
        that record on the next resume)."""
        with open(self.ledger_path, "rb+") as f:
            end = f.seek(0, os.SEEK_END)
            if end:
                f.seek(end - 1)
                if f.read(1) != b"\n":
                    f.write(b"\n")
        for rec in ledger_records(self.ledger_path):
            g = tuple(int(v) for v in rec["grid_idx"])
            self._done.add(g)
            if rec.get("empty", True):
                continue
            idx = np.asarray(rec["occ_idx"], int).reshape(-1, 3)
            at = (idx[:, 0], idx[:, 1], idx[:, 2])
            occ = np.zeros((self.D,) * 3, bool)
            occ[at] = True
            prob = np.zeros((self.D,) * 3, np.float32)
            prob[at] = np.asarray(rec["prob"], np.float32)
            color = None
            if "color" in rec:
                color = np.zeros((self.D,) * 3 + (3,), np.float32)
                color[at] = np.asarray(rec["color"], np.float32)
            self._cubes[g] = CubeResult(g, occ, prob, color)

    def _records(self):
        """(coords (N, 3) int64, probs (N,) f32, colors (N, 3) f32) of the
        occupied voxels of every cube, cube by cube in insertion order."""
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
        return (np.concatenate(coords, axis=0), np.concatenate(probv),
                np.concatenate(colorv, axis=0))

    def merge(
        self,
        occupancy_vote: Optional[float] = None,
        min_component: int = 0,
        keep_top_components: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Merge all cubes into deduplicated global voxels, then drop the
        26-connected components of fewer than ``min_component`` voxels
        (when > 1) and keep only the ``keep_top_components`` largest (when
        set).

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
        coords, probv, colorv = self._records()
        if self.merge_backend == "native":
            from surfacenet_tpu_torch.native import native_merge

            done = np.asarray(sorted(self._done), np.int64).reshape(-1, 3)
            kcoords, probs, colors = native_merge(
                coords, probv, colorv, done, self.stride, self.D,
                occupancy_vote)
        else:
            kcoords, probs, colors = self._merge_numpy(
                coords, probv, colorv, occupancy_vote)
        if min_component > 1 or keep_top_components is not None:
            from surfacenet_tpu_torch.ops.denoise import component_filter_mask

            m = component_filter_mask(kcoords, min_component,
                                      keep_top_components,
                                      backend=self.merge_backend)
            kcoords, probs, colors = kcoords[m], probs[m], colors[m]
        pts = self.scene_origin + self.s * (kcoords + 0.5)
        return pts.astype(np.float32), probs, np.clip(colors, 0.0, 1.0)

    def _merge_numpy(self, coords, probv, colorv, occupancy_vote):
        """The plain merge: (coords, probs, colors) of the surviving voxels
        in sorted order, sums in float64."""
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
        probs = (prob_sum[keep] / votes[keep]).astype(np.float32)
        colors = (color_sum[keep] / votes[keep][:, None]).astype(np.float32)
        return coords[first][keep], probs, colors

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

    def export_ply(
        self,
        path: str,
        occupancy_vote: Optional[float] = None,
        min_component: int = 0,
        keep_top_components: Optional[int] = None,
    ) -> int:
        """Write the merged (and denoised) points with their colours;
        returns the number of points."""
        pts, _, colors = self.merge(occupancy_vote, min_component,
                                    keep_top_components)
        write_ply(path, pts, colors)
        return len(pts)
