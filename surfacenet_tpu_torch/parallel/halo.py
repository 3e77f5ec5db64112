"""Halo exchange between neighbouring scene blocks.

Port of ``surfacenet_tpu/parallel/halo.py``.  The scene's voxel lattice
is cut into contiguous blocks along the mesh's ``block`` axis; each rank
holds its block's slab, and a voxel near a block face sees the neighbour's
boundary slab through this exchange: the top slab goes to the next block,
the bottom slab to the previous one, and the outermost blocks receive
zeros (no neighbour).  The reference permutes in a ring and zeroes the
wrapped edges; here only real neighbours exchange, which gives the same
result.

Point to point, between the ranks of one cube column; under gloo, which
sends only CPU tensors, the slabs pass through the host.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from surfacenet_tpu_torch.parallel.mesh import RankMesh


def exchange_halo_1d(vol: torch.Tensor, halo: int, mesh: RankMesh,
                     axis_name: str = "block") -> torch.Tensor:
    """This rank's block ``vol`` (Z_local, ...) padded with its
    neighbours' slabs: (Z_local + 2 halo, ...) = [slab from the block
    below | vol | slab from the block above]."""
    if axis_name != mesh.axis_names[0]:
        raise ValueError(f"halo exchange runs on the block axis "
                         f"{mesh.axis_names[0]!r}, not {axis_name!r}")
    if not 0 < halo <= vol.shape[0]:
        raise ValueError(f"halo={halo} must be in [1, {vol.shape[0]}]")
    n, b, c = mesh.shape[0], mesh.block, mesh.cube
    host = vol.is_cuda and n > 1 and dist.get_backend() == "gloo"
    src = vol.cpu() if host else vol
    top = src[-halo:].contiguous()  # to block b + 1
    bot = src[:halo].contiguous()  # to block b - 1
    below = torch.zeros_like(top)
    above = torch.zeros_like(bot)
    reqs = []
    if b + 1 < n:
        peer = int(mesh.devices[b + 1, c])
        reqs += [dist.isend(top, peer), dist.irecv(above, peer)]
    if b > 0:
        peer = int(mesh.devices[b - 1, c])
        reqs += [dist.isend(bot, peer), dist.irecv(below, peer)]
    for r in reqs:
        r.wait()
    if host:
        below, above = below.to(vol.device), above.to(vol.device)
    return torch.cat([below, vol, above], dim=0)


def halo_exchange(mesh: RankMesh, vol: torch.Tensor, halo: int,
                  axis_name: str = "block") -> torch.Tensor:
    """Public entry, the reference's signature: ``vol`` is this rank's
    block of the block-sharded volume; returns its haloed block."""
    return exchange_halo_1d(vol, halo, mesh, axis_name)
