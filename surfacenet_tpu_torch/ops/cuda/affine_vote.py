"""Wrapper of the affine-vote CUDA kernel (``csrc/affine_vote.cu``).

Replaces the Pallas TPU kernel ``surfacenet_tpu/ops/pallas/affine_pool.py::
_affine_vote_kernel``; computes what ``ops/ray_pooling.py::
ray_vote_affine_plain`` computes, bitwise.  The source files' headers
(``csrc/affine_vote.cu``, ``csrc/affine_ray.cuh``) state the kernel's bound
and design.  Its one C entry takes one of three routes, which
``affine_route`` names from the shapes alone (a route that fails to launch
raises; it never falls back to another):

- ``tile``: 1 <= window <= ``TILE_MAX_WINDOW`` and at most
  ``TILE_MAX_VIEWS`` views a cube (the sweep's window 2): each cube read
  tile by tile into shared memory with a halo, the shear offsets tabled;
- ``segment``: window 0, or a window of D - 1 or more (the same taps): two
  launches, a ray-maximum plane per (cube, view) into a scratch that this
  wrapper allocates, then the compare;
- ``direct``: any other window, the first design (one thread a voxel).

Limits: slopes must lie in [-1, 1] (``vote_params`` clamps them); a slope
outside (or NaN) makes the kernel trap, a CUDA error that the caller sees
at its next synchronisation and that leaves the CUDA context unusable, not
wrong output.  Each launch's grid is 1-D, so N times a cube's blocks (at D
64: 64 tiles, or 16 K plane blocks and 64 compare blocks) must stay below
2^31; above it the launch fails and this wrapper raises.

``affine_vote`` runs the plain version for tensors on the CPU and the
kernel for tensors on a CUDA device; there is no other route.
``affine_vote.launches`` counts entry calls that launched (the segment
route's call is two kernel launches), ``affine_vote.route_launches`` the
calls of each route, by ``affine_route``'s name.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from surfacenet_tpu_torch.ops.cuda import _build
from surfacenet_tpu_torch.ops.ray_pooling import (
    ray_vote_affine_plain, vote_params,
)

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
# the C entries' route codes (csrc/affine_ray.cuh: AffineRoute)
ROUTES = ("tile", "segment", "direct")
# csrc/affine_ray.cuh: the widest window the tile route is built for, and
# the views a cube whose offset tables it keeps in shared memory
TILE_MAX_WINDOW = 4
TILE_MAX_VIEWS = 64


def affine_route(D: int, K: int, window: int) -> str:
    """The route the affine kernels take for cubes of D^3, K views a cube
    (1 for the mask) and ``window``."""
    if window <= 0 or window >= D - 1:
        return "segment"
    if window <= TILE_MAX_WINDOW and K <= TILE_MAX_VIEWS:
        return "tile"
    return "direct"


def plane_scratch(route: str, n_planes: int, D: int, device):
    """The segment route's scratch, a D x D float32 plane per (item, view);
    None on the other routes."""
    if route != "segment":
        return None
    return torch.empty((n_planes, D, D), dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    fn = _build.load("affine_vote").affine_vote
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check(fused, axis, slopes):
    if fused.dim() != 4 or fused.dtype != torch.float32:
        raise ValueError(f"fused must be float32 (N, D, D, D), got {fused.dtype} {tuple(fused.shape)}")
    N, D = fused.shape[0], fused.shape[1]
    if fused.shape[1:] != (D, D, D):
        raise ValueError(f"fused volumes must be cubes, got {tuple(fused.shape)}")
    if axis.dim() != 2 or axis.shape[0] != N or axis.dtype != torch.int32:
        raise ValueError(f"axis must be int32 ({N}, K), got {axis.dtype} {tuple(axis.shape)}")
    K = axis.shape[1]
    if slopes.shape != (N, K, 2) or slopes.dtype != torch.float32:
        raise ValueError(f"slopes must be float32 ({N}, {K}, 2), got {slopes.dtype} {tuple(slopes.shape)}")
    for name, t in (("fused", fused), ("axis", axis), ("slopes", slopes)):
        if t.device != fused.device:
            raise ValueError(f"{name} is on {t.device}, fused on {fused.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def affine_vote(
    fused: torch.Tensor, axis: torch.Tensor, slopes: torch.Tensor,
    window: int = 0,
) -> torch.Tensor:
    """Ray-max votes (N, D, D, D) int32 of the active views of each cube.

    fused (N, D, D, D) float32; axis (N, K) int32 (-1 = inactive slot);
    slopes (N, K, 2) float32 in [-1, 1], as made by
    ``ray_pooling.vote_params`` (see the module docstring for the limits).
    """
    _check(fused, axis, slopes)
    if fused.device.type == "cpu":
        return ray_vote_affine_plain(fused, axis, slopes, window)
    if fused.device.type != "cuda":
        raise ValueError(f"affine_vote: unsupported device {fused.device}")
    N, D = fused.shape[0], fused.shape[1]
    K = axis.shape[1]
    votes = torch.empty((N, D, D, D), dtype=torch.int32, device=fused.device)
    route = affine_route(D, K, window)
    fn = _kernel_fn()
    with torch.cuda.device(fused.device):
        stream = torch.cuda.current_stream().cuda_stream
        planes = plane_scratch(route, N * K, D, fused.device)
        err = fn(fused.data_ptr(), axis.data_ptr(), slopes.data_ptr(),
                 votes.data_ptr(), planes.data_ptr() if planes is not None
                 else None, N, K, D, int(window), ROUTES.index(route), stream)
    if err != 0:
        raise RuntimeError(f"affine_vote kernel launch failed ({route} "
                           f"route): CUDA error {err}")
    affine_vote.launches += 1
    affine_vote.route_launches[route] += 1
    return votes


affine_vote.launches = 0
affine_vote.route_launches = dict.fromkeys(ROUTES, 0)


def ray_vote_affine(
    probs: torch.Tensor,
    origins: torch.Tensor,
    s: float,
    Ps_pool: torch.Tensor,
    view_mask: torch.Tensor,
    window: int = 0,
) -> torch.Tensor:
    """Counterpart of ``ray_vote_affine_pallas``: per-cube ray-max votes.

    probs (N, D, D, D); origins (N, 3); Ps_pool (N, K, 3, 4) pooling views;
    view_mask (N, K) bool, False = padded slot (no vote).
    Returns votes (N, D, D, D) int32.
    """
    D = probs.shape[1]
    axis, slopes = vote_params(origins, s, Ps_pool, view_mask, D)
    return affine_vote(probs.float().contiguous(), axis, slopes, window)
