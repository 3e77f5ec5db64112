"""Binary PLY point-cloud IO (own copy of ``surfacenet_tpu/utils/ply.py``).

The reference exports the merged occupied voxels as a colored .ply point
cloud consumed by the external DTU evaluation.  Minimal, dependency-free
binary-little-endian writer/reader.
"""

from __future__ import annotations

import io
from typing import Optional, Tuple

import numpy as np

_DTYPE = np.dtype(
    [
        ("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
        ("red", "u1"), ("green", "u1"), ("blue", "u1"),
    ]
)


def write_ply(
    path: str,
    points: np.ndarray,
    colors: Optional[np.ndarray] = None,
) -> None:
    """Write a colored point cloud.

    Args:
      points: (N, 3) float, mm.
      colors: (N, 3) float in [0, 1] or uint8; defaults to mid-gray.
    """
    points = np.asarray(points, np.float32)
    n = points.shape[0]
    if colors is None:
        colors_u8 = np.full((n, 3), 128, np.uint8)
    else:
        colors = np.asarray(colors)
        if colors.dtype != np.uint8:
            colors_u8 = np.clip(colors * 255.0, 0, 255).astype(np.uint8)
        else:
            colors_u8 = colors

    rec = np.empty(n, dtype=_DTYPE)
    rec["x"], rec["y"], rec["z"] = points[:, 0], points[:, 1], points[:, 2]
    rec["red"], rec["green"], rec["blue"] = (
        colors_u8[:, 0], colors_u8[:, 1], colors_u8[:, 2],
    )

    header = (
        "ply\n"
        "format binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(rec.tobytes())


def read_ply(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read a binary or ascii PLY with xyz (+ optional rgb).

    Returns (points (N,3) f32, colors (N,3) u8).
    """
    with open(path, "rb") as f:
        data = f.read()
    end = data.find(b"end_header\n")
    if end < 0:
        raise ValueError("not a PLY file (no end_header)")
    header = data[:end].decode("ascii", "replace").splitlines()
    body = data[end + len(b"end_header\n"):]

    n = 0
    props = []
    fmt = None
    for line in header:
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element" and parts[1] == "vertex":
            n = int(parts[2])
        elif parts[0] == "property" and len(parts) == 3:
            props.append((parts[2], parts[1]))

    _np = {
        "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
        "uchar": "u1", "uint8": "u1", "int": "<i4", "int32": "<i4",
        "short": "<i2", "ushort": "<u2",
    }
    if fmt == "ascii":
        arr = np.loadtxt(io.BytesIO(body), max_rows=n, ndmin=2)
        names = [p[0] for p in props]
        cols = {nm: arr[:, i] for i, nm in enumerate(names)}
    else:
        dt = np.dtype([(nm, _np[t]) for nm, t in props])
        rec = np.frombuffer(body, dtype=dt, count=n)
        cols = {nm: rec[nm] for nm, _ in props}

    pts = np.stack(
        [cols["x"], cols["y"], cols["z"]], axis=-1
    ).astype(np.float32)
    if "red" in cols:
        colors = np.stack(
            [cols["red"], cols["green"], cols["blue"]], axis=-1
        ).astype(np.uint8)
    else:
        colors = np.full((n, 3), 128, np.uint8)
    return pts, colors
