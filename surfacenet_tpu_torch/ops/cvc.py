"""Colored Voxel Cube (CVC) construction: the perspective-warp gather.

Port of ``surfacenet_tpu/ops/cvc.py``.  For a cube (origin, D^3 voxels of
size s) and a view, every voxel centre is projected through the view's
3x4 matrix and the image is sampled there bilinearly.

``build_cvc_views`` is the plain PyTorch version of the CUDA warp-gather
kernel (``ops/cuda/warp_gather.py``): it computes the same function with
the same arithmetic, in the same order, so the two agree to the last bit
wherever the compiler contracts nothing (the kernel is built with
``--fmad=false``).  Images of any float dtype are sampled in float32;
int8 images (``quantize_int8``) are sampled as the reference's int8 kernel
mode samples them, with 7-bit vertical weights and exact int32 sums.
"""

from __future__ import annotations

from typing import Tuple

import torch

from surfacenet_tpu_torch.geometry.camera import project_rows

# the int8 gather's scale of its exact int32 sums back to [0, 1]: 1/127^2,
# the double rounded once to float32 (as the reference's kernel takes it)
DEQUANT = torch.tensor(1.0 / (127.0 * 127.0), dtype=torch.float32).item()


def _bilinear(flat: torch.Tensor, base, u, v, H: int, W: int):
    """Bilinear sample of ``flat`` (rows of pixels, C channels) in float32.

    ``base`` is the row offset of each sample's image (or 0), u/v the
    fractional pixel coordinates.  Returns (colors (..., C), inside mask).
    """
    inside = (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    du = u - u0
    dv = v - v0
    # non-finite coordinates (points at the camera plane) are outside and
    # only need indices that do not fault: zero them before the cast
    u0 = torch.where(inside, u0, 0.0)
    v0 = torch.where(inside, v0, 0.0)
    u0i = u0.to(torch.int64).clamp(0, W - 1)
    v0i = v0.to(torch.int64).clamp(0, H - 1)
    u1i = (u0i + 1).clamp(max=W - 1)
    v1i = (v0i + 1).clamp(max=H - 1)

    if flat.dtype == torch.int8:
        return _bilinear_int8(flat, base, u0i, v0i, u1i, v1i, du, dv,
                              W), inside

    def tap(vi, ui):
        return flat[base + vi * W + ui].float()

    w00 = ((1 - dv) * (1 - du))[..., None]
    w01 = ((1 - dv) * du)[..., None]
    w10 = (dv * (1 - du))[..., None]
    w11 = (dv * du)[..., None]
    out = (
        tap(v0i, u0i) * w00 + tap(v0i, u1i) * w01
        + tap(v1i, u0i) * w10 + tap(v1i, u1i) * w11
    )
    return out, inside


def _bilinear_int8(flat, base, u0i, v0i, u1i, v1i, du, dv, W: int):
    """The int8 gather's interpolation (the reference's int8 kernel mode).

    Vertically, the two hat weights are rounded to 7 bits and each column's
    int32 sum ``q[v0] * hv0 + q[v1] * hv1`` is exact; it is converted to
    float32 and scaled by ``DEQUANT``.  Horizontally the float32 weights
    ``1 - du`` and ``du`` combine the two columns.
    """
    hv0 = torch.round((1 - dv) * 127).to(torch.int32)[..., None]
    hv1 = torch.round(dv * 127).to(torch.int32)[..., None]

    def column(ui):
        top = flat[base + v0i * W + ui].to(torch.int32)
        bottom = flat[base + v1i * W + ui].to(torch.int32)
        return (top * hv0 + bottom * hv1).float() * DEQUANT

    return (column(u0i) * (1 - du)[..., None]
            + column(u1i) * du[..., None])


def quantize_int8(images: torch.Tensor) -> torch.Tensor:
    """[0, 1] images -> int8 ``round(x * 127)`` (half to even), contiguous:
    the image copy the int8 gather samples (made once per sweep)."""
    return torch.round(images.float() * 127).to(torch.int8).contiguous()


def bilinear_sample(image: torch.Tensor, uv: torch.Tensor, fill: float = 0.0):
    """Bilinear sampling at fractional pixel coordinates.

    Args:
      image: (H, W, C), or (V, H, W, C) with uv (V, ..., 2) sampling view v
        of the image stack at uv[v].
      uv: (..., 2) with u = column, v = row.

    Returns:
      colors (..., C) float32; valid (...) bool (True = inside the image).
    """
    if image.dim() == 3:
        H, W, C = image.shape
        base = 0
    else:
        V, H, W, C = image.shape
        shape = (V,) + (1,) * (uv.dim() - 2)
        base = (torch.arange(V, device=uv.device) * (H * W)).reshape(shape)
    flat = image.reshape(-1, C)
    out, valid = _bilinear(flat, base, uv[..., 0], uv[..., 1], H, W)
    return torch.where(valid[..., None], out, fill), valid


def build_cvc(image, P, origin, D: int, s: float, center_colors: bool = True):
    """One Colored Voxel Cube: (D, D, D, C) colours and (D, D, D) validity."""
    colors, valid = build_cvc_views(
        image[None], P[None], torch.zeros(1, dtype=torch.long,
                                          device=image.device),
        origin[None], D, s,
    )
    if center_colors:
        colors = center_cvc(colors, valid)
    return colors[0], valid[0]


def center_cvc(colors: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Subtract the mean colour over valid voxels; zero invalid voxels.

    colors (..., D, D, D, C); valid (..., D, D, D).
    """
    v = valid[..., None]
    denom = v.sum(dim=(-4, -3, -2), keepdim=True).clamp(min=1).to(colors.dtype)
    mean = torch.where(v, colors, 0.0).sum(dim=(-4, -3, -2), keepdim=True)
    return torch.where(v, colors - mean / denom, 0.0)


def build_cvc_views(
    images: torch.Tensor,
    Ps: torch.Tensor,
    view_idx: torch.Tensor,
    origins: torch.Tensor,
    D: int,
    s: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Uncentered single-view CVCs for (cube, view) work items.

    The plain version of the warp-gather kernel.  For item b and flat voxel
    q = (i*D + j)*D + k, the centre ``origins[b] + s*([i, j, k] + 0.5)`` is
    projected through ``Ps[view_idx[b]]`` and ``images[view_idx[b]]`` is
    sampled bilinearly in float32.  A voxel is valid when it lies in front
    of the camera and projects inside the image; invalid voxels are zero.

    Args:
      images: (V, H, W, 3) float32 or bfloat16, or int8 from
        ``quantize_int8`` (see ``_bilinear_int8``); or (V, H, W, 4), RGBx,
        whose channel 3 is not read.
      Ps: (V, 3, 4) float32.
      view_idx: (B,) integer; origins: (B, 3) float32.

    Returns:
      colors (B, D, D, D, 3) float32; valid (B, D, D, D) bool.
    """
    V, H, W, C = images.shape
    B = view_idx.shape[0]
    dev = images.device
    P = Ps[view_idx.long()].float()  # (B, 3, 4)
    r = (torch.arange(D, dtype=torch.float32, device=dev) + 0.5) * s
    o = origins.float()
    fx = o[:, 0, None, None, None] + r[None, :, None, None]
    fy = o[:, 1, None, None, None] + r[None, None, :, None]
    fz = o[:, 2, None, None, None] + r[None, None, None, :]
    # rows summed left to right, as the kernel sums them
    nu, nv, den = project_rows(P.reshape(B, 1, 1, 3, 4), fx, fy, fz)
    d = den + 1e-8
    u = nu / d
    v = nv / d
    base = (view_idx.long() * (H * W)).reshape(B, 1, 1, 1)
    colors, inside = _bilinear(images.reshape(-1, C)[:, :3], base, u, v, H,
                               W)
    valid = inside & (den > 0)
    return torch.where(valid[..., None], colors, 0.0), valid


def pair_views(pair_idx: torch.Tensor, origins: torch.Tensor):
    """The gather's items for a batch of CVC pairs: every pair's first
    view, then every second view (``[a0..aB, b0..bB]``, the reference's
    ``pair_idx.T.reshape(-1)``), as int32, with the origins doubled."""
    views = pair_idx.t().reshape(-1).to(torch.int32).contiguous()
    return views, torch.cat([origins, origins]).float().contiguous()


def assemble_pairs(colors: torch.Tensor, valid: torch.Tensor,
                   center_colors: bool = True):
    """(2B, D, D, D, 3) single-view CVCs in ``pair_views`` order, zero
    where invalid (as the gather returns them) -> (x (B, D, D, D, 6)
    float32, valid (B, D, D, D)): each view centred over its valid voxels
    if ``center_colors``, the two views side by side, valid where both
    are."""
    if center_colors:
        colors = center_cvc(colors, valid)
    B = colors.shape[0] // 2
    return (torch.cat([colors[:B], colors[B:]], dim=-1),
            valid[:B] & valid[B:])


def build_cvc_batch(
    images: torch.Tensor,
    Ps: torch.Tensor,
    pair_idx: torch.Tensor,
    origins: torch.Tensor,
    D: int,
    s: float,
    center_colors: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """CVC pairs for (cube, view pair) training items: the plain version.

    Port of the reference's ``ops/cvc.py::build_cvc_batch``; the kernel
    route is ``ops/cuda/warp_gather.py::build_cvc_batch_cuda``.

    Args:
      images: (V, H, W, 3 or 4), as ``build_cvc_views`` takes them.
      Ps: (V, 3, 4) float32; pair_idx: (B, 2) integer; origins: (B, 3).

    Returns:
      x (B, D, D, D, 6) float32; valid (B, D, D, D) bool.
    """
    views, origins2 = pair_views(pair_idx, origins)
    colors, valid = build_cvc_views(images, Ps, views, origins2, D, s)
    return assemble_pairs(colors, valid, center_colors)
