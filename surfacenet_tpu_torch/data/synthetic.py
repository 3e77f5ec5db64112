"""Synthetic golden scene with analytic geometry (the sphere).

Own copy of the sphere half of ``surfacenet_tpu/data/synthetic.py``: a
textured sphere ray-traced from a ring of calibrated cameras, so every
stage of the pipeline can be checked against the analytic surface without
a dataset.  Host-side numpy; the images and matrices are bit-identical to
the JAX package's ``make_sphere_scene`` for the same arguments.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from surfacenet_tpu_torch.geometry.camera import look_at_projection


@dataclasses.dataclass
class SyntheticScene:
    images: np.ndarray  # (V, H, W, 3) float32 in [0, 1]
    Ps: np.ndarray  # (V, 3, 4) float64
    bbox_min: np.ndarray  # (3,) mm
    bbox_max: np.ndarray  # (3,) mm
    center: np.ndarray  # (3,) sphere centre
    radius: float

    def surface_points(self, n: int, seed: int = 0) -> np.ndarray:
        """Uniform samples on the analytic surface."""
        rng = np.random.default_rng(seed)
        v = rng.normal(size=(n, 3))
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        return self.center + self.radius * v

    def surface_distance(self, pts: np.ndarray) -> np.ndarray:
        """Unsigned distance from points to the analytic surface (mm)."""
        return np.abs(
            np.linalg.norm(pts - self.center, axis=-1) - self.radius
        )


def _texture(pts: np.ndarray, center: np.ndarray) -> np.ndarray:
    """High-frequency procedural RGB texture on the surface."""
    q = (pts - center) * 0.35
    r = 0.5 + 0.5 * np.sin(3.1 * q[..., 0] + 1.7 * np.sin(2.3 * q[..., 1]))
    g = 0.5 + 0.5 * np.sin(2.7 * q[..., 1] + 1.3 * np.sin(1.9 * q[..., 2]))
    b = 0.5 + 0.5 * np.sin(3.7 * q[..., 2] + 2.1 * np.sin(2.9 * q[..., 0]))
    return np.stack([r, g, b], axis=-1)


def _trace_sphere(
    P: np.ndarray,
    hw: Tuple[int, int],
    center: np.ndarray,
    radius: float,
    bg: float = 0.1,
) -> np.ndarray:
    """Ray-trace a textured sphere for one camera (vectorized over pixels)."""
    H, W = hw
    M = P[:, :3]
    cam = -np.linalg.solve(M, P[:, 3])
    Minv = np.linalg.inv(M)

    u, v = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
    pix = np.stack([u, v, np.ones_like(u)], axis=-1)  # (H, W, 3)
    dirs = pix @ Minv.T
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)

    oc = cam - center
    b = np.sum(dirs * oc, axis=-1)
    c = np.dot(oc, oc) - radius**2
    disc = b * b - c
    hit = disc > 0
    t = -b - np.sqrt(np.maximum(disc, 0.0))
    hit &= t > 0

    pts = cam + dirs * t[..., None]
    img = np.full((H, W, 3), bg, np.float64)
    img[hit] = _texture(pts[hit], center)
    return img.astype(np.float32)


def make_sphere_scene(
    n_views: int = 8,
    hw: Tuple[int, int] = (120, 160),
    radius: float = 30.0,
    cam_dist: float = 120.0,
    focal: float = 200.0,
    seed: int = 0,
) -> SyntheticScene:
    """Ring of cameras looking at a textured sphere at the origin (mm)."""
    center = np.zeros(3)
    H, W = hw
    Ps = []
    images = []
    rng = np.random.default_rng(seed)
    for i in range(n_views):
        ang = 2 * np.pi * i / n_views
        elev = 0.35 + 0.1 * rng.standard_normal()
        eye = center + cam_dist * np.array(
            [
                np.cos(ang) * np.cos(elev),
                np.sin(ang) * np.cos(elev),
                np.sin(elev),
            ]
        )
        P = look_at_projection(
            eye, center, np.array([0.0, 0.0, 1.0]), focal, (W / 2, H / 2)
        )
        Ps.append(P)
        images.append(_trace_sphere(P, hw, center, radius))

    pad = radius * 0.4
    return SyntheticScene(
        images=np.stack(images),
        Ps=np.stack(Ps),
        bbox_min=center - radius - pad,
        bbox_max=center + radius + pad,
        center=center,
        radius=radius,
    )
