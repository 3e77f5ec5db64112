"""Wrapper of the warp-gather CUDA kernel (``csrc/warp_gather.cu``).

Replaces the Pallas TPU kernel ``surfacenet_tpu/ops/pallas/warp_gather.py::
_warp_kernel``; computes what ``ops/cvc.py::build_cvc_views`` computes.
The source file's header states the kernel's bound and design.

``warp_gather`` runs the plain version for tensors on the CPU and the
kernel for tensors on a CUDA device; there is no other route.
``warp_gather.launches`` counts kernel launches, and
``warp_gather.entry_launches`` the launches of each entry (bf16, f32,
int8).  The kernel reads RGBx images (a fourth, unread channel: one aligned
load a pixel); three-channel images on a CUDA device are copied to RGBx
first.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from surfacenet_tpu_torch.ops.cuda import _build
from surfacenet_tpu_torch.ops.cvc import (
    assemble_pairs, build_cvc_views, pair_views,
)

_ARGTYPES = (
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_float,
                                                  ctypes.c_void_p]
)
_ENTRY = {torch.bfloat16: "warp_gather_bf16", torch.float32: "warp_gather_f32",
          torch.int8: "warp_gather_int8"}


def _kernel_fn(dtype):
    lib = _build.load("warp_gather")
    fn = getattr(lib, _ENTRY[dtype])
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check(images, Ps, view_idx, origins):
    dev = images.device
    if images.dim() != 4 or images.shape[-1] not in (3, 4):
        raise ValueError(
            f"images must be (V, H, W, 3) or (V, H, W, 4), got {tuple(images.shape)}")
    if images.dtype not in _ENTRY:
        raise TypeError(
            f"images must be bfloat16, float32 or int8, got {images.dtype}")
    V = images.shape[0]
    if Ps.shape != (V, 3, 4) or Ps.dtype != torch.float32:
        raise ValueError(f"Ps must be float32 ({V}, 3, 4), got {Ps.dtype} {tuple(Ps.shape)}")
    if view_idx.dim() != 1 or view_idx.dtype != torch.int32:
        raise ValueError(f"view_idx must be int32 (B,), got {view_idx.dtype} {tuple(view_idx.shape)}")
    B = view_idx.shape[0]
    if origins.shape != (B, 3) or origins.dtype != torch.float32:
        raise ValueError(f"origins must be float32 ({B}, 3), got {origins.dtype} {tuple(origins.shape)}")
    for name, t in (("images", images), ("Ps", Ps), ("view_idx", view_idx),
                    ("origins", origins)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, images on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def warp_gather(
    images: torch.Tensor,
    Ps: torch.Tensor,
    view_idx: torch.Tensor,
    origins: torch.Tensor,
    *,
    D: int,
    s: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Uncentered CVCs for (cube, view) items.

    Args:
      images: (V, H, W, 3) bfloat16 or float32, contiguous; or int8
        ``round(x * 127)`` (``ops/cvc.py::quantize_int8``), sampled as the
        reference's int8 kernel mode samples it.  (V, H, W, 4) is taken
        too (RGBx, ``pipeline/sweep.py::gather_images``): channel 3 is
        never read.  The kernel takes only RGBx; on a CUDA device
        three-channel images are copied to RGBx for the call.
      Ps: (V, 3, 4) float32; view_idx: (B,) int32 in [0, V);
      origins: (B, 3) float32 cube min corners (mm).

    Returns:
      colors (B, D, D, D, 3) float32, zero where invalid;
      valid (B, D, D, D) bool.
    """
    _check(images, Ps, view_idx, origins)
    if images.device.type == "cpu":
        return build_cvc_views(images, Ps, view_idx, origins, D, s)
    if images.device.type != "cuda":
        raise ValueError(f"warp_gather: unsupported device {images.device}")
    if D > 1024:
        raise ValueError(f"D={D} too large: the kernel takes D <= 1024")
    if images.shape[-1] == 3:
        images = F.pad(images, (0, 1)).contiguous()
    if images.data_ptr() % 16:
        raise ValueError("images must be 16-byte aligned")
    B = view_idx.shape[0]
    H, W = images.shape[1:3]
    colors = torch.empty((B, D, D, D, 3), dtype=torch.float32,
                         device=images.device)
    valid = torch.empty((B, D, D, D), dtype=torch.bool, device=images.device)
    fn = _kernel_fn(images.dtype)
    with torch.cuda.device(images.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            images.data_ptr(), Ps.data_ptr(), view_idx.data_ptr(),
            origins.data_ptr(), colors.data_ptr(), valid.data_ptr(),
            H, W, B, D, float(s), stream,
        )
    if err != 0:
        raise RuntimeError(f"warp_gather kernel launch failed: CUDA error {err}")
    warp_gather.launches += 1
    warp_gather.entry_launches[_ENTRY[images.dtype]] += 1
    return colors, valid


warp_gather.launches = 0
warp_gather.entry_launches = dict.fromkeys(_ENTRY.values(), 0)


def build_cvc_batch_cuda(
    images: torch.Tensor,
    Ps: torch.Tensor,
    pair_idx: torch.Tensor,
    origins: torch.Tensor,
    *,
    D: int,
    s: float,
    center_colors: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """CVC pairs for training items through one ``warp_gather`` call.

    Port of ``surfacenet_tpu/ops/pallas/warp_gather.py::
    build_cvc_batch_pallas``: the 2B items ``[a0..aB, b0..bB]`` are
    gathered at once, then centred and paired as
    ``ops/cvc.py::build_cvc_batch`` does.  ``images`` is the run's one
    gather copy (``pipeline/sweep.py::gather_images``; RGBx on the card, so
    that no step pads it again).  2B stays within the kernel's 65535 items
    a call (ROADMAP C5): training batches are tens of cubes.

    Returns (x (B, D, D, D, 6) float32, valid (B, D, D, D) bool).
    """
    views, origins2 = pair_views(pair_idx, origins)
    colors, valid = warp_gather(images, Ps, views, origins2, D=D, s=s)
    return assemble_pairs(colors, valid, center_colors)
