"""Wrapper of the affine ray-pool mask CUDA kernel (``csrc/affine_pool.cu``).

Replaces the Pallas TPU kernel ``surfacenet_tpu/ops/pallas/affine_pool.py::
_affine_pool_kernel``; ``ray_max_mask_affine_cuda`` is the counterpart of
``ray_max_mask_affine_pallas`` and computes what ``ops/ray_pooling.py::
ray_max_mask_affine_batch`` computes, bitwise.  As in the reference, the
sweep does not call it (the sweep votes with ``affine_vote``); it is a
public function of its own.  The kernel is the affine vote's with one view
an item: the same three routes (``affine_vote.affine_route`` with K = 1),
the same slope and grid limits (``ops/cuda/affine_vote.py``'s docstring),
and the source files' headers state its bound and design.

``affine_pool`` runs the plain version for tensors on the CPU and the
kernel for tensors on a CUDA device; there is no other route.
``affine_pool.launches`` counts entry calls that launched (the segment
route's call is two kernel launches), ``affine_pool.route_launches`` the
calls of each route.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from surfacenet_tpu_torch.ops.cuda import _build
from surfacenet_tpu_torch.ops.cuda.affine_vote import (
    ROUTES, affine_route, plane_scratch,
)
from surfacenet_tpu_torch.ops.ray_pooling import (
    item_params, ray_max_mask_affine_plain,
)

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    fn = _build.load("affine_pool").affine_pool
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check(probs, axis, slopes):
    if probs.dim() != 4 or probs.dtype != torch.float32:
        raise ValueError(f"probs must be float32 (N, D, D, D), got {probs.dtype} {tuple(probs.shape)}")
    N, D = probs.shape[0], probs.shape[1]
    if probs.shape[1:] != (D, D, D):
        raise ValueError(f"probs volumes must be cubes, got {tuple(probs.shape)}")
    if axis.shape != (N,) or axis.dtype != torch.int32:
        raise ValueError(f"axis must be int32 ({N},), got {axis.dtype} {tuple(axis.shape)}")
    if slopes.shape != (N, 2) or slopes.dtype != torch.float32:
        raise ValueError(f"slopes must be float32 ({N}, 2), got {slopes.dtype} {tuple(slopes.shape)}")
    for name, t in (("probs", probs), ("axis", axis), ("slopes", slopes)):
        if t.device != probs.device:
            raise ValueError(f"{name} is on {t.device}, probs on {probs.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def affine_pool(
    probs: torch.Tensor, axis: torch.Tensor, slopes: torch.Tensor,
    window: int = 0,
) -> torch.Tensor:
    """Ray-max mask (N, D, D, D) bool of each item for its one view.

    probs (N, D, D, D) float32; axis (N,) int32 dominant ray axis (an item
    with none of 0, 1, 2 gets an all-False mask); slopes (N, 2) float32 in
    [-1, 1] (see ``ops/cuda/affine_vote.py``'s docstring for the limits).
    """
    _check(probs, axis, slopes)
    if probs.device.type == "cpu":
        return ray_max_mask_affine_plain(probs, axis, slopes, window)
    if probs.device.type != "cuda":
        raise ValueError(f"affine_pool: unsupported device {probs.device}")
    N, D = probs.shape[0], probs.shape[1]
    mask = torch.empty((N, D, D, D), dtype=torch.bool, device=probs.device)
    route = affine_route(D, 1, window)
    fn = _kernel_fn()
    with torch.cuda.device(probs.device):
        stream = torch.cuda.current_stream().cuda_stream
        planes = plane_scratch(route, N, D, probs.device)
        err = fn(probs.data_ptr(), axis.data_ptr(), slopes.data_ptr(),
                 mask.data_ptr(), planes.data_ptr() if planes is not None
                 else None, N, D, int(window), ROUTES.index(route), stream)
    if err != 0:
        raise RuntimeError(f"affine_pool kernel launch failed ({route} "
                           f"route): CUDA error {err}")
    affine_pool.launches += 1
    affine_pool.route_launches[route] += 1
    return mask


affine_pool.launches = 0
affine_pool.route_launches = dict.fromkeys(ROUTES, 0)


def ray_max_mask_affine_cuda(
    probs: torch.Tensor, origins: torch.Tensor, s: float, Ps: torch.Tensor,
    window: int = 0,
) -> torch.Tensor:
    """Counterpart of ``ray_max_mask_affine_pallas``: per-item ray-max masks.

    probs (N, D, D, D); origins (N, 3); Ps (N, 3, 4) one pooling view per
    item.  Returns (N, D, D, D) bool.
    """
    axis, slopes = item_params(origins, s, Ps, probs.shape[1])
    return affine_pool(probs.float().contiguous(), axis, slopes, window)
