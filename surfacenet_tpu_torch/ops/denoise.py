"""Point-cloud denoising: drop small floating voxel clusters.

Port of ``surfacenet_tpu/ops/denoise.py``.  After the cube merge,
thin-surface reconstruction leaves specks where a single bad view pair
fired; the denoise takes the 26-connected components of the merged integer
voxel coordinates and filters them by size.  This is host work on the IO
tail, like the merge: the components come from the C++ union-find
(``native/denoise.cpp``), and ``_components_numpy`` (a vectorised
hook-and-jump over the forward-neighbour edge list) is the plain version,
run only when a caller asks for ``backend="numpy"``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

# Half the 26-neighbourhood (lexicographically positive offsets); the other
# half is covered by the neighbour's own forward edge.
_FORWARD_OFFSETS = np.array(
    [
        [0, 0, 1], [0, 1, -1], [0, 1, 0], [0, 1, 1],
        [1, -1, -1], [1, -1, 0], [1, -1, 1],
        [1, 0, -1], [1, 0, 0], [1, 0, 1],
        [1, 1, -1], [1, 1, 0], [1, 1, 1],
    ],
    np.int64,
)

BACKENDS = ("native", "numpy")


def _pack(coords: np.ndarray) -> np.ndarray:
    """Pack (N, 3) int coords into sortable uint64 keys (21 bits an axis,
    the scheme of ``native/merge.cpp``)."""
    c = coords.astype(np.int64) + (1 << 20)
    return (
        (c[:, 0].astype(np.uint64) << np.uint64(42))
        | (c[:, 1].astype(np.uint64) << np.uint64(21))
        | c[:, 2].astype(np.uint64)
    )


def _components_numpy(coords: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The plain version: (labels, sizes) int64, labels compact in order of
    the smallest record index of each component."""
    n = len(coords)
    parent = np.arange(n, dtype=np.int64)
    if n == 0:
        return parent, parent.copy()

    keys = _pack(coords)
    order = np.argsort(keys)
    sorted_keys = keys[order]

    # forward-neighbour edge list by binary search on the sorted keys
    edges_a, edges_b = [], []
    for off in _FORWARD_OFFSETS:
        nk = _pack(coords + off)
        pos = np.minimum(np.searchsorted(sorted_keys, nk), n - 1)
        hit = sorted_keys[pos] == nk
        if hit.any():
            edges_a.append(np.nonzero(hit)[0])
            edges_b.append(order[pos[hit]])
    if edges_a:
        a = np.concatenate(edges_a)
        b = np.concatenate(edges_b)
        # hook-and-jump: attach the larger root under the smaller, then
        # pointer-jump to full compression; O(log n) vectorised rounds
        while True:
            pa, pb = parent[a], parent[b]
            if not (pa != pb).any():
                break
            np.minimum.at(parent, np.maximum(pa, pb), np.minimum(pa, pb))
            while True:
                nxt = parent[parent]
                if np.array_equal(nxt, parent):
                    break
                parent = nxt

    roots, inverse = np.unique(parent, return_inverse=True)
    sizes_per_comp = np.bincount(inverse, minlength=len(roots))
    return inverse.astype(np.int64), sizes_per_comp[inverse].astype(np.int64)


def connected_components(
    coords: np.ndarray, backend: str = "native",
) -> Tuple[np.ndarray, np.ndarray]:
    """26-connected components of (N, 3) unique integer voxel coordinates.

    Returns labels (N,) int64, compact component ids in [0, n_components),
    and sizes (N,) int64, the size of each record's component.  The two
    backends number the components differently (same partition, same
    sizes).
    """
    coords = np.asarray(coords)
    if coords.ndim != 2 or coords.shape[1] != 3:
        raise ValueError(f"coords must be (N, 3), got {coords.shape}")
    if backend == "native":
        from surfacenet_tpu_torch.native import native_components

        return native_components(coords)
    if backend == "numpy":
        return _components_numpy(coords.astype(np.int64))
    raise ValueError(f"backend={backend!r}: use one of {BACKENDS}")


def component_filter_mask(
    coords: np.ndarray,
    min_size: int = 0,
    keep_top: Optional[int] = None,
    backend: str = "native",
) -> np.ndarray:
    """(N,) bool keep-mask over voxel records after cluster-size filtering.

    ``min_size`` drops components of fewer voxels (<= 1 keeps all);
    ``keep_top`` keeps only the ``keep_top`` largest components (None: no
    cap).  Both filters compose (intersection).
    """
    n = len(coords)
    if n == 0 or (min_size <= 1 and keep_top is None):
        return np.ones(n, bool)
    labels, sizes = connected_components(coords, backend)
    keep = sizes >= min_size
    if keep_top is not None and labels.size:
        n_comp = int(labels.max()) + 1
        comp_sizes = np.bincount(labels, minlength=n_comp)
        if n_comp > keep_top:
            top = np.argsort(comp_sizes)[::-1][: int(keep_top)]
            keep &= np.isin(labels, top)
    return keep
