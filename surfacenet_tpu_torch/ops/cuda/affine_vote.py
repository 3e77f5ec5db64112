"""Wrapper of the affine-vote CUDA kernel (``csrc/affine_vote.cu``).

Replaces the Pallas TPU kernel ``surfacenet_tpu/ops/pallas/affine_pool.py::
_affine_vote_kernel``; computes what ``ops/ray_pooling.py::
ray_vote_affine_plain`` computes.  The source file's header states the
kernel's bound and design.

``affine_vote`` runs the plain version for tensors on the CPU and the
kernel for tensors on a CUDA device; there is no other route.
``affine_vote.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from surfacenet_tpu_torch.ops.cuda import _build
from surfacenet_tpu_torch.ops.ray_pooling import (
    ray_vote_affine_plain, vote_params,
)

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


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
    slopes (N, K, 2) float32, as made by ``ray_pooling.vote_params``.
    """
    _check(fused, axis, slopes)
    if fused.device.type == "cpu":
        return ray_vote_affine_plain(fused, axis, slopes, window)
    if fused.device.type != "cuda":
        raise ValueError(f"affine_vote: unsupported device {fused.device}")
    N, D = fused.shape[0], fused.shape[1]
    K = axis.shape[1]
    votes = torch.empty((N, D, D, D), dtype=torch.int32, device=fused.device)
    fn = _kernel_fn()
    with torch.cuda.device(fused.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(fused.data_ptr(), axis.data_ptr(), slopes.data_ptr(),
                 votes.data_ptr(), N, K, D, int(window), stream)
    if err != 0:
        raise RuntimeError(f"affine_vote kernel launch failed: CUDA error {err}")
    affine_vote.launches += 1
    return votes


affine_vote.launches = 0


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
