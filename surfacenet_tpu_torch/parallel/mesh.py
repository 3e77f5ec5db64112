"""The (block, cube) rank grid.

Port of ``surfacenet_tpu/parallel/mesh.py``.  A "device" of the
reference's mesh is a rank here (one process each, ``distributed.py``):

  * ``block``: scene-volume blocks, the scan's cube lattice cut into
    contiguous slabs (``sweep_sharded.py::partition_cubes``); each block
    row owns its cubes' work and its ledger, and ray pooling across block
    faces sees its neighbours through ``halo.py``;
  * ``cube``: data parallel over the cubes of a block, and over the
    training minibatch.

``make_mesh(n_block)`` arranges ``WORLD_SIZE`` ranks row-major as
``(n_block, WORLD_SIZE // n_block)`` and makes one process group per block
row with more than one rank.  The reference's ``global_put``,
``fetch_rows`` and sharding helpers have no counterpart: there is no
global array, each rank holds only its own rows and the collectives move
what another rank needs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch.distributed as dist

from surfacenet_tpu_torch.parallel.distributed import process_info


@dataclasses.dataclass(frozen=True)
class RankMesh:
    """A rank grid and this process's place in it."""

    devices: np.ndarray  # (n_block, n_cube) global ranks, row-major
    axis_names: Tuple[str, str]
    rank: int
    # every rank (None in a world of 1), and this rank's block row (None
    # when the row is this rank alone)
    group: object = None
    row_group: object = None

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.devices.shape)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def block(self) -> int:
        """This rank's block row."""
        return self.rank // self.devices.shape[1]

    @property
    def cube(self) -> int:
        """This rank's column within its row (0: the row's first rank)."""
        return self.rank % self.devices.shape[1]


def make_mesh(n_block: Optional[int] = None,
              axis_names: Tuple[str, str] = ("block", "cube")) -> RankMesh:
    """The ``(n_block, world // n_block)`` grid of the process group's
    ranks (a 1 x 1 grid without one).  Every rank must call it, in the same
    order as the others, since it creates process groups."""
    rank, n = process_info()
    n_block = n_block or 1
    if n % n_block != 0:
        raise ValueError(f"n_block={n_block} does not divide {n} devices")
    devices = np.arange(n).reshape(n_block, n // n_block)
    group = row_group = None
    if n > 1:
        group = dist.group.WORLD
        if devices.shape[1] > 1:
            for row in devices:
                g = dist.new_group([int(r) for r in row])
                if rank in row:
                    row_group = g
    return RankMesh(devices, tuple(axis_names), rank, group, row_group)
