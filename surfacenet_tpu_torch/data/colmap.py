"""COLMAP sparse-model loading (BASELINE config 5: scenes beyond DTU, such
as Tanks and Temples, with COLMAP poses).

Own copy of ``surfacenet_tpu/data/colmap.py``.  Parses the text-format
sparse model (``cameras.txt`` + ``images.txt``) into 3x4 projection
matrices ``P = K [R|t]`` for ``geometry/camera.py`` and loads the images it
names; ``points3D.txt``, where present, gives the scene bbox.  Only
pinhole-family intrinsics are supported; radial distortion parameters are
ignored with a warning (undistort beforehand for metric results).  Images
are written and read by the port's PNG codec (``data/png.py``): no PIL.

Layout expected:
    model_dir/
      cameras.txt  images.txt  [points3D.txt]
    image_dir/ (default model_dir/../images)
      <names referenced by images.txt>
"""

from __future__ import annotations

import os
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np

from surfacenet_tpu_torch.data import png
from surfacenet_tpu_torch.data.dtu import Scan, _load_image


def _quat_to_rot(qw: float, qx: float, qy: float, qz: float) -> np.ndarray:
    """COLMAP quaternion (w, x, y, z) -> rotation matrix (world->cam)."""
    q = np.array([qw, qx, qy, qz], np.float64)
    q = q / np.linalg.norm(q)
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def parse_cameras(path: str) -> Dict[int, np.ndarray]:
    """cameras.txt -> {camera_id: K (3, 3)}."""
    out: Dict[int, np.ndarray] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cam_id = int(parts[0])
            model = parts[1]
            params = [float(p) for p in parts[4:]]
            if model == "PINHOLE":
                fx, fy, cx, cy = params[:4]
            elif model == "SIMPLE_PINHOLE":
                fx = fy = params[0]
                cx, cy = params[1:3]
            elif model in ("SIMPLE_RADIAL", "RADIAL", "OPENCV"):
                if model == "SIMPLE_RADIAL":
                    fx = fy = params[0]
                    cx, cy = params[1:3]
                else:
                    fx, fy, cx, cy = params[:4]
                warnings.warn(
                    f"camera {cam_id}: model {model} distortion ignored; "
                    "undistort images for metric accuracy"
                )
            else:
                raise ValueError(f"unsupported COLMAP camera model {model}")
            out[cam_id] = np.array(
                [[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64
            )
    return out


def parse_images(path: str) -> List[Tuple[str, int, np.ndarray, np.ndarray]]:
    """images.txt -> [(name, camera_id, R (3,3), t (3,))], sorted by name."""
    out = []
    with open(path) as f:
        lines = [
            ln.strip() for ln in f
            if ln.strip() and not ln.strip().startswith("#")
        ]
    # Records alternate image line / 2D-points line, but blank points lines
    # are common: an image line is told apart structurally (its 10th field
    # is a file name, not a number), not by position.
    for ln in lines:
        parts = ln.split()
        if len(parts) < 10:
            continue
        try:
            float(parts[9])
            continue  # 2D-points line (all numeric)
        except ValueError:
            pass
        try:
            qw, qx, qy, qz = map(float, parts[1:5])
            tx, ty, tz = map(float, parts[5:8])
            cam_id = int(parts[8])
        except ValueError:
            continue
        out.append((parts[9], cam_id, _quat_to_rot(qw, qx, qy, qz),
                    np.array([tx, ty, tz])))
    return sorted(out, key=lambda r: r[0])


def load_colmap_scan(
    model_dir: str,
    image_dir: Optional[str] = None,
    max_views: Optional[int] = None,
    downsample: int = 1,
) -> Scan:
    """Load a COLMAP sparse model and its images as a Scan (P = K [R|t]);
    the bbox spans the 2nd-98th percentiles of ``points3D.txt``, padded by
    10% a side (None without that file)."""
    Ks = parse_cameras(os.path.join(model_dir, "cameras.txt"))
    recs = parse_images(os.path.join(model_dir, "images.txt"))
    if max_views:
        recs = recs[:max_views]
    image_dir = image_dir or os.path.join(
        os.path.dirname(os.path.normpath(model_dir)), "images"
    )

    images, Ps = [], []
    for name, cam_id, R, t in recs:
        img = _load_image(os.path.join(image_dir, name))
        P = Ks[cam_id] @ np.concatenate([R, t[:, None]], axis=1)
        if downsample > 1:
            img = img[::downsample, ::downsample]
            P = P.copy()
            P[:2] /= downsample
        images.append(img)
        Ps.append(P)

    bbox_min = bbox_max = None
    pts_path = os.path.join(model_dir, "points3D.txt")
    if os.path.exists(pts_path):
        pts = []
        with open(pts_path) as f:
            for ln in f:
                ln = ln.strip()
                if not ln or ln.startswith("#"):
                    continue
                parts = ln.split()
                pts.append([float(parts[1]), float(parts[2]), float(parts[3])])
        if pts:
            lo, hi = np.percentile(np.asarray(pts), [2, 98], axis=0)
            pad = 0.1 * (hi - lo)
            bbox_min, bbox_max = lo - pad, hi + pad

    return Scan(
        images=np.stack(images),
        Ps=np.stack(Ps),
        bbox_min=bbox_min,
        bbox_max=bbox_max,
        name=os.path.basename(os.path.normpath(model_dir)),
    )


def write_colmap_model(
    model_dir: str,
    images: np.ndarray,
    Ks: np.ndarray,
    Rs: np.ndarray,
    ts: np.ndarray,
    points3d: Optional[np.ndarray] = None,
    image_dir: Optional[str] = None,
) -> None:
    """Write a minimal COLMAP text model (fixtures / export): one PINHOLE
    camera and one image (``0000.png`` ...) a view, written as 8-bit PNG."""
    from scipy.spatial.transform import Rotation

    os.makedirs(model_dir, exist_ok=True)
    image_dir = image_dir or os.path.join(
        os.path.dirname(os.path.normpath(model_dir)), "images"
    )
    os.makedirs(image_dir, exist_ok=True)

    with open(os.path.join(model_dir, "cameras.txt"), "w") as f:
        f.write("# cameras\n")
        for i, K in enumerate(Ks):
            H, W = images[i].shape[:2]
            f.write(
                f"{i + 1} PINHOLE {W} {H} {K[0, 0]} {K[1, 1]} "
                f"{K[0, 2]} {K[1, 2]}\n"
            )

    with open(os.path.join(model_dir, "images.txt"), "w") as f:
        f.write("# images\n")
        for i, (R, t) in enumerate(zip(Rs, ts)):
            x, y, z, w = Rotation.from_matrix(R).as_quat()
            name = f"{i:04d}.png"
            f.write(
                f"{i + 1} {w} {x} {y} {z} "
                f"{t[0]} {t[1]} {t[2]} {i + 1} {name}\n\n"
            )
            u8 = np.clip(images[i] * 255, 0, 255).astype(np.uint8)
            png.write_png(os.path.join(image_dir, name), u8)

    if points3d is not None:
        with open(os.path.join(model_dir, "points3D.txt"), "w") as f:
            f.write("# points\n")
            for i, p in enumerate(points3d):
                f.write(f"{i + 1} {p[0]} {p[1]} {p[2]} 128 128 128 0.5\n")
