"""Point-cloud renders for inspection.

Port of ``surfacenet_tpu/utils/viz.py``: orthographic splat renders of a
reconstruction along the three axes, enough to look at a ``.ply`` without
other tools.  numpy only; the PNGs are written by the port's own encoder
(``data/png.py``), so no PIL is needed.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from surfacenet_tpu_torch.data.png import write_png


def splat_orthographic(
    points: np.ndarray,
    colors: Optional[np.ndarray] = None,
    axis: int = 2,
    size: int = 512,
    pad: float = 0.05,
) -> np.ndarray:
    """Render points orthographically along an axis (max-depth splats).

    Args:
      points: (N, 3); colors: (N, 3) float [0,1] (default height-coded).
      axis: projection axis (dropped dimension).
      size: output image side (pixels).

    Returns:
      (size, size, 3) uint8 image.
    """
    if len(points) == 0:
        return np.zeros((size, size, 3), np.uint8)
    keep = [a for a in range(3) if a != axis]
    uv = points[:, keep]
    depth = points[:, axis]
    lo = uv.min(axis=0)
    hi = uv.max(axis=0)
    span = max((hi - lo).max(), 1e-6)
    lo = lo - pad * span
    span = span * (1 + 2 * pad)
    px = np.clip(((uv - lo) / span * (size - 1)).astype(int), 0, size - 1)

    if colors is None:
        t = (depth - depth.min()) / max(np.ptp(depth), 1e-6)
        colors = np.stack([t, 0.4 + 0.3 * t, 1.0 - t], axis=-1)

    img = np.zeros((size, size, 3), np.float32)
    # max-depth splat: depth-sorted assignment (the later, deeper wins)
    order = np.argsort(depth)
    img[px[order, 1], px[order, 0]] = colors[order]
    img = np.flipud(img)
    return np.clip(img * 255, 0, 255).astype(np.uint8)


def save_turntable(
    path_prefix: str,
    points: np.ndarray,
    colors: Optional[np.ndarray] = None,
    size: int = 512,
) -> Tuple[str, str, str]:
    """Write three axis-aligned splat renders: <prefix>_{xy,xz,yz}.png."""
    names = []
    for axis, tag in [(2, "xy"), (1, "xz"), (0, "yz")]:
        p = f"{path_prefix}_{tag}.png"
        write_png(p, splat_orthographic(points, colors, axis=axis, size=size))
        names.append(p)
    return tuple(names)
