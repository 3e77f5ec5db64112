"""Synthetic golden scenes with analytic geometry: the sphere and the tori.

Own copy of the sphere and tori scenes of ``surfacenet_tpu/data/synthetic.py``:
textured bodies ray-traced from a ring of calibrated cameras, so every
stage of the pipeline can be checked against the analytic surface without
a dataset.  Host-side numpy; the images and matrices are bit-identical to
the JAX package's ``make_sphere_scene`` and ``make_tori_scene`` for the
same arguments.
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

    def occupancy(self, centers: np.ndarray, s: float) -> np.ndarray:
        """Training labels: a voxel centre within half a voxel diagonal
        of the surface (the reference's voxelization rule)."""
        return self.surface_distance(centers) <= (s * np.sqrt(3) / 2)


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


@dataclasses.dataclass
class SDFScene:
    """Golden scene defined by a signed-distance field: occlusions,
    concavities and several bodies.  The same API as ``SyntheticScene``;
    ``tori`` lists (center, axis, R, r), the analytic truth."""

    images: np.ndarray
    Ps: np.ndarray
    bbox_min: np.ndarray
    bbox_max: np.ndarray
    tori: Tuple

    def _sdf(self, p: np.ndarray) -> np.ndarray:
        d = None
        for center, axis, R, r in self.tori:
            q = p - center
            h = q @ axis
            radial = np.linalg.norm(
                q - h[..., None] * axis, axis=-1
            )
            di = np.sqrt((radial - R) ** 2 + h**2) - r
            d = di if d is None else np.minimum(d, di)
        return d

    def surface_points(self, n: int, seed: int = 0) -> np.ndarray:
        """~Area-uniform samples on the union surface (rejection on the
        ring-angle Jacobian; samples inside the other torus discarded)."""
        rng = np.random.default_rng(seed)
        out = []
        remaining = n
        while remaining > 0:
            m = remaining * 2 + 16
            ti = rng.integers(0, len(self.tori), m)
            pts = np.zeros((m, 3))
            for i, (center, axis, R, r) in enumerate(self.tori):
                sel = ti == i
                k = int(sel.sum())
                if k == 0:
                    continue
                u = rng.uniform(0, 2 * np.pi, k)
                v = rng.uniform(0, 2 * np.pi, k)
                keep = rng.uniform(0, 1, k) < (
                    (R + r * np.cos(v)) / (R + r)
                )
                axis = np.asarray(axis, np.float64)
                e1 = np.cross(axis, [0.917, 0.312, 0.248])
                e1 /= np.linalg.norm(e1)
                e2 = np.cross(axis, e1)
                ring = (R + r * np.cos(v))[:, None] * (
                    np.cos(u)[:, None] * e1 + np.sin(u)[:, None] * e2
                )
                p = center + ring + (r * np.sin(v))[:, None] * axis
                p[~keep] = np.nan
                pts[sel] = p
            ok = ~np.isnan(pts[:, 0])
            # drop samples buried inside the OTHER torus
            ok &= self._sdf(pts) > -1e-6
            out.append(pts[ok][:remaining])
            remaining -= len(out[-1])
        return np.concatenate(out)[:n]

    def surface_distance(self, pts: np.ndarray) -> np.ndarray:
        return np.abs(self._sdf(pts))

    def occupancy(self, centers: np.ndarray, s: float) -> np.ndarray:
        return self.surface_distance(centers) <= (s * np.sqrt(3) / 2)


def _trace_sdf(
    P: np.ndarray,
    hw: Tuple[int, int],
    scene_sdf,
    t_near: float,
    t_far: float,
    bg: float = 0.1,
    n_steps: int = 96,
) -> np.ndarray:
    """Sphere-trace an SDF for one camera (vectorized over pixels)."""
    H, W = hw
    M = P[:, :3]
    p4 = P[:, 3]
    cam = -np.linalg.solve(M, p4)
    Minv = np.linalg.inv(M)

    u, v = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
    pix = np.stack([u, v, np.ones_like(u)], axis=-1)
    dirs = pix @ Minv.T
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)

    t = np.full((H, W), t_near)
    hit = np.zeros((H, W), bool)
    live = np.ones((H, W), bool)
    for _ in range(n_steps):
        pts = cam + dirs * t[..., None]
        d = scene_sdf(pts)
        newly = live & (d < 1e-3)
        hit |= newly
        live &= ~newly
        t = np.where(live, t + np.maximum(d, 1e-3), t)
        live &= t < t_far
        if not live.any():
            break
    pts = cam + dirs * t[..., None]
    img = np.full((H, W, 3), bg, np.float64)
    img[hit] = _texture(pts[hit], np.zeros(3))
    return img.astype(np.float32)


def make_tori_scene(
    n_views: int = 8,
    hw: Tuple[int, int] = (120, 160),
    R: float = 18.0,
    r: float = 5.0,
    cam_dist: float = 120.0,
    focal: float = 200.0,
    seed: int = 0,
) -> SDFScene:
    """Two interlocking textured tori: occlusions, concavities and a
    through-hole.  Torus A lies in the xy-plane at the origin; torus B in
    the xz-plane threads through A's hole.  Tube circles stay > 2r apart, so
    the union surface is the analytic truth everywhere."""
    tori = (
        (np.zeros(3), np.array([0.0, 0.0, 1.0]), R, r),
        (np.array([R, 0.0, 0.0]), np.array([0.0, 1.0, 0.0]), R, r),
    )
    probe = SDFScene(
        images=np.zeros((0,)), Ps=np.zeros((0,)),
        bbox_min=np.zeros(3), bbox_max=np.zeros(3), tori=tori,
    )

    center = np.array([R / 2, 0.0, 0.0])
    H, W = hw
    Ps = []
    images = []
    rng = np.random.default_rng(seed)
    for i in range(n_views):
        ang = 2 * np.pi * i / n_views
        elev = 0.45 + 0.12 * rng.standard_normal()
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
        images.append(
            _trace_sdf(
                P, hw, probe._sdf,
                t_near=cam_dist - 3 * R, t_far=cam_dist + 3 * R,
            )
        )

    pad = r
    lo = center - (1.5 * R + r + pad)
    hi = center + (1.5 * R + r + pad)
    return SDFScene(
        images=np.stack(images),
        Ps=np.stack(Ps),
        bbox_min=lo,
        bbox_max=hi,
        tori=tori,
    )
