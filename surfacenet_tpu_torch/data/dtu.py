"""DTU MVS dataset loading (own copy of ``surfacenet_tpu/data/dtu.py``).

The reference consumes the DTU "SampleSet" layout: per-scan rectified images
(``rect_###_<light>_r5000.png``) plus per-view 3x4 projection matrices in
``pos_###.txt`` calibration files.  This loader supports that layout and a
simpler generic one, and includes a writer so synthetic scenes can be
round-tripped through the on-disk format in tests.  PNGs are read and
written by the port's own decoder (``data/png.py``), so a scan of PNGs
needs no PIL; another format, or a PNG variant that decoder does not take,
is read through PIL where PIL is installed and otherwise raises.

Generic scan layout:
    scan_dir/
      images/  000.png 001.png ...        (PNG; other formats through PIL)
      cams/    pos_000.txt pos_001.txt    (3 rows x 4 floats, whitespace)
      bbox.txt                            (2 rows x 3 floats: min, max) [opt]
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import List, Optional, Tuple

import numpy as np

from surfacenet_tpu_torch.data import png


@dataclasses.dataclass
class Scan:
    images: np.ndarray  # (V, H, W, 3) float32 in [0, 1]
    Ps: np.ndarray  # (V, 3, 4) float64
    bbox_min: Optional[np.ndarray]  # (3,) mm or None
    bbox_max: Optional[np.ndarray]
    name: str = ""


def read_projection_matrix(path: str) -> np.ndarray:
    """Parse a DTU ``pos_###.txt``: 3 rows of 4 floats (whitespace/newline)."""
    vals = np.loadtxt(path, dtype=np.float64)
    P = np.asarray(vals, np.float64).reshape(3, 4)
    return P


def write_projection_matrix(path: str, P: np.ndarray) -> None:
    np.savetxt(path, np.asarray(P, np.float64).reshape(3, 4), fmt="%.10e")


def _load_image(path: str) -> np.ndarray:
    """(H, W, 3) float32 in [0, 1]; PNG without PIL, anything else with it."""
    with open(path, "rb") as fh:
        is_png = fh.read(8) == png.SIGNATURE
    if is_png:
        try:
            return png.read_png(path).astype(np.float32) / 255.0
        except png.PNGUnsupported as e:
            reason = str(e)
    else:
        reason = f"{path}: not a PNG file"
    try:
        from PIL import Image
    except ImportError:
        raise ValueError(
            f"{reason}; without PIL only the {png.SUPPORTED} can be read"
        ) from None
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.float32) / 255.0


def load_scan(
    scan_dir: str,
    light: str = "3",
    max_views: Optional[int] = None,
    downsample: int = 1,
) -> Scan:
    """Load a scan from either the generic or the DTU SampleSet layout.

    Args:
      light: DTU lighting condition index used for ``rect_###_{light}_*``
        images (ignored for the generic layout).
      downsample: integer image downsampling factor; projection matrices are
        rescaled accordingly (P's first two rows divide by the factor).
    """
    img_paths: List[str]
    cam_paths: List[str]

    generic_imgs = sorted(
        glob.glob(os.path.join(scan_dir, "images", "*"))
    )
    if generic_imgs:
        img_paths = generic_imgs
        cam_paths = sorted(
            glob.glob(os.path.join(scan_dir, "cams", "pos_*.txt"))
        )
    else:
        # DTU SampleSet: rect_001_3_r5000.png, 1-indexed views
        pat = os.path.join(scan_dir, f"rect_*_{light}_r5000.png")
        img_paths = sorted(glob.glob(pat))
        if not img_paths:
            pat = os.path.join(scan_dir, "rect_*.png")
            img_paths = sorted(glob.glob(pat))
        cal_dir = os.path.join(scan_dir, "cal")
        parent = os.path.dirname(os.path.normpath(scan_dir))
        for cand in (
            cal_dir,
            # sibling of the scan dir, and the real SampleSet layout where
            # Calibration/cal18 is a sibling of the Rectified/ folder:
            #   SampleSet/MVS Data/Rectified/scan6/rect_*.png
            #   SampleSet/MVS Data/Calibration/cal18/pos_*.txt
            os.path.join(parent, "Calibration", "cal18"),
            os.path.join(
                os.path.dirname(parent), "Calibration", "cal18"
            ),
            os.path.join(scan_dir, "pos"),
        ):
            if os.path.isdir(cand):
                cam_paths = sorted(
                    glob.glob(os.path.join(cand, "pos_*.txt"))
                )
                break
        else:
            cam_paths = []

    if not img_paths:
        raise FileNotFoundError(f"no images found in {scan_dir}")
    if max_views:
        img_paths = img_paths[:max_views]
        cam_paths = cam_paths[: max_views]
    if len(cam_paths) < len(img_paths):
        raise FileNotFoundError(
            f"{scan_dir}: {len(img_paths)} images but "
            f"{len(cam_paths)} calibration files"
        )

    images = np.stack([_load_image(p) for p in img_paths])
    Ps = np.stack(
        [read_projection_matrix(p) for p in cam_paths[: len(img_paths)]]
    )

    if downsample > 1:
        images = images[:, ::downsample, ::downsample]
        Ps = Ps.copy()
        Ps[:, :2] /= downsample

    bbox_min = bbox_max = None
    bbox_path = os.path.join(scan_dir, "bbox.txt")
    if os.path.exists(bbox_path):
        bb = np.loadtxt(bbox_path).reshape(2, 3)
        bbox_min, bbox_max = bb[0], bb[1]

    return Scan(
        images=images,
        Ps=Ps,
        bbox_min=bbox_min,
        bbox_max=bbox_max,
        name=os.path.basename(os.path.normpath(scan_dir)),
    )


def write_scan(
    scan_dir: str,
    images: np.ndarray,
    Ps: np.ndarray,
    bbox_min: Optional[np.ndarray] = None,
    bbox_max: Optional[np.ndarray] = None,
) -> None:
    """Write a scan in the generic layout (test fixtures / dataset export)."""
    os.makedirs(os.path.join(scan_dir, "images"), exist_ok=True)
    os.makedirs(os.path.join(scan_dir, "cams"), exist_ok=True)
    for i, (img, P) in enumerate(zip(images, Ps)):
        u8 = np.clip(np.asarray(img) * 255.0, 0, 255).astype(np.uint8)
        png.write_png(os.path.join(scan_dir, "images", f"{i:03d}.png"), u8)
        write_projection_matrix(
            os.path.join(scan_dir, "cams", f"pos_{i:03d}.txt"), P
        )
    if bbox_min is not None and bbox_max is not None:
        np.savetxt(
            os.path.join(scan_dir, "bbox.txt"),
            np.stack([bbox_min, bbox_max]),
        )


def write_scan_sampleset(
    root: str,
    scan_name: str,
    images: np.ndarray,
    Ps: np.ndarray,
    light: str = "3",
) -> str:
    """Write a scan in the real DTU SampleSet layout (full-fidelity fixture):

        root/Rectified/<scan_name>/rect_001_<light>_r5000.png   (1-indexed)
        root/Calibration/cal18/pos_001.txt

    and return the scan directory (``root/Rectified/<scan_name>``) for
    ``load_scan`` and ``cli reconstruct-all``.
    """
    scan_dir = os.path.join(root, "Rectified", scan_name)
    cal_dir = os.path.join(root, "Calibration", "cal18")
    os.makedirs(scan_dir, exist_ok=True)
    os.makedirs(cal_dir, exist_ok=True)
    for i, (img, P) in enumerate(zip(images, Ps), start=1):
        u8 = np.clip(np.asarray(img) * 255.0, 0, 255).astype(np.uint8)
        png.write_png(
            os.path.join(scan_dir, f"rect_{i:03d}_{light}_r5000.png"), u8
        )
        write_projection_matrix(os.path.join(cal_dir, f"pos_{i:03d}.txt"), P)
    return scan_dir


# DTU eval-split scan ids of the reference benchmark (paper SS6).
DTU_EVAL_SCANS = [
    1, 4, 9, 10, 11, 12, 13, 15, 23, 24, 29, 32, 33, 34, 48, 49, 62, 75,
    77, 110, 114, 118,
]
