"""Synthetic golden scenes with analytic geometry: the sphere, the tori,
the occluded sphere, and degraded copies of any of them.

Own copy of the scenes of ``surfacenet_tpu/data/synthetic.py``: textured
bodies ray-traced from a ring of calibrated cameras, so every stage of the
pipeline can be checked against the analytic surface without a dataset.
Host-side numpy; the images and matrices are bit-identical to the JAX
package's ``make_sphere_scene``, ``make_tori_scene``,
``make_occluded_scene`` and ``degrade_scene`` for the same arguments.
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
    """Sphere-trace an SDF for one camera (vectorized over pixels).

    Each step evaluates the SDF on the rays still marching only; every ray
    takes the reference's steps, so the image is bitwise the reference's.
    """
    H, W = hw
    M = P[:, :3]
    p4 = P[:, 3]
    cam = -np.linalg.solve(M, p4)
    Minv = np.linalg.inv(M)

    u, v = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
    pix = np.stack([u, v, np.ones_like(u)], axis=-1)
    dirs = pix @ Minv.T
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)

    rays = dirs.reshape(-1, 3)
    t = np.full(H * W, t_near)
    hit = np.zeros(H * W, bool)
    live = np.arange(H * W)  # flat indices of the marching rays
    for _ in range(n_steps):
        d = scene_sdf(cam + rays[live] * t[live, None])
        newly = d < 1e-3
        hit[live[newly]] = True
        live, d = live[~newly], d[~newly]
        t[live] = t[live] + np.maximum(d, 1e-3)
        live = live[t[live] < t_far]
        if not live.size:
            break
    t, hit = t.reshape(H, W), hit.reshape(H, W)
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


def degrade_scene(
    scene,
    *,
    noise_std: float = 0.0,
    exposure_jitter: float = 0.0,
    wb_jitter: float = 0.0,
    n_clutter: int = 0,
    calib_sigma_px: float = 0.0,
    bg: float = 0.1,
    seed: int = 0,
):
    """A copy of ``scene`` with real-imaging degradations; the analytic
    surface is untouched.

    Args:
      noise_std: additive Gaussian sensor noise per pixel (full scale 1).
      exposure_jitter: per-view log-normal gain sigma.
      wb_jitter: per-view, per-channel log-normal gain sigma.
      n_clutter: textured rectangles pasted per view onto background
        pixels only (pixels still at the render background ``bg``).
      calib_sigma_px: per-view principal-point shift sigma in pixels,
        applied as ``P[0] += du * P[2]``, ``P[1] += dv * P[2]``.
    """
    rng = np.random.default_rng(seed)
    imgs = np.asarray(scene.images, np.float32).copy()
    V, H, W, _ = imgs.shape

    if n_clutter:
        bg_mask = np.all(np.abs(imgs - bg) < 1e-3, axis=-1)  # (V, H, W)
        for v in range(V):
            for _ in range(n_clutter):
                ch = int(rng.integers(H // 12, H // 4))
                cw = int(rng.integers(W // 12, W // 4))
                y0 = int(rng.integers(0, H - ch))
                x0 = int(rng.integers(0, W - cw))
                yy, xx = np.meshgrid(
                    np.arange(ch), np.arange(cw), indexing="ij"
                )
                f = rng.uniform(0.1, 0.7, 2)
                ph = rng.uniform(0, 2 * np.pi, 3)
                tex = 0.5 + 0.45 * np.sin(
                    f[0] * yy[..., None] + f[1] * xx[..., None] + ph
                )
                sel = bg_mask[v, y0: y0 + ch, x0: x0 + cw]
                imgs[v, y0: y0 + ch, x0: x0 + cw][sel] = tex[sel]

    if exposure_jitter:
        imgs = imgs * np.exp(
            rng.normal(0.0, exposure_jitter, (V, 1, 1, 1))
        ).astype(np.float32)
    if wb_jitter:
        imgs = imgs * np.exp(
            rng.normal(0.0, wb_jitter, (V, 1, 1, 3))
        ).astype(np.float32)
    if noise_std:
        imgs = imgs + rng.normal(0.0, noise_std, imgs.shape)
    imgs = np.clip(imgs, 0.0, 1.0).astype(np.float32)

    Ps = np.asarray(scene.Ps, np.float64).copy()
    if calib_sigma_px:
        duv = rng.normal(0.0, calib_sigma_px, (V, 2))
        for v in range(V):
            Ps[v, 0] += duv[v, 0] * Ps[v, 2]
            Ps[v, 1] += duv[v, 1] * Ps[v, 2]

    return dataclasses.replace(scene, images=imgs, Ps=Ps)


def _occluder_texture(pts: np.ndarray) -> np.ndarray:
    """Repeated high-frequency tiles (~7 mm period): locally textured,
    globally ambiguous, unlike the sphere's texture."""
    q = pts * 0.9
    r = 0.5 + 0.5 * np.sign(np.sin(0.9 * q[..., 0]) * np.sin(0.9 * q[..., 1]))
    g = 0.5 + 0.5 * np.sin(5.0 * q[..., 2])
    b = np.full_like(r, 0.25)
    return np.stack([r, 0.6 * g, b], axis=-1)


def _camera_center(P: np.ndarray) -> np.ndarray:
    return -np.linalg.solve(P[:, :3], P[:, 3])


def _trace_occluded_sphere(
    P: np.ndarray,
    hw: Tuple[int, int],
    center: np.ndarray,
    radius: float,
    occ_center: np.ndarray,
    occ_normal: np.ndarray,
    occ_radius: float,
    specular: float = 0.0,
    bg: float = 0.1,
) -> np.ndarray:
    """Ray-trace the textured sphere behind a textured occluder disk (the
    nearest hit wins), with an optional view-dependent specular lobe on the
    sphere."""
    H, W = hw
    cam = _camera_center(P)
    Minv = np.linalg.inv(P[:, :3])

    u, v = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
    pix = np.stack([u, v, np.ones_like(u)], axis=-1)
    dirs = pix @ Minv.T
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)

    oc = cam - center
    b = np.sum(dirs * oc, axis=-1)
    c = np.dot(oc, oc) - radius**2
    disc = b * b - c
    s_hit = disc > 0
    t_s = -b - np.sqrt(np.maximum(disc, 0.0))
    s_hit &= t_s > 0

    denom = dirs @ occ_normal
    t_d = np.where(
        np.abs(denom) > 1e-9,
        ((occ_center - cam) @ occ_normal) / denom,
        -1.0,
    )
    p_d = cam + dirs * t_d[..., None]
    d_hit = (t_d > 0) & (
        np.linalg.norm(p_d - occ_center, axis=-1) < occ_radius
    )

    img = np.full((H, W, 3), bg, np.float64)
    sphere_front = s_hit & (~d_hit | (t_s < t_d))
    pts_s = cam + dirs * t_s[..., None]
    col = _texture(pts_s[sphere_front], center)
    if specular > 0.0:
        # a light fixed above the scene; the highlight follows the camera
        n_s = pts_s[sphere_front] - center
        n_s /= np.linalg.norm(n_s, axis=-1, keepdims=True)
        light = np.array([0.3, -0.2, 1.0])
        light = light / np.linalg.norm(light)
        refl = 2 * (n_s @ light)[:, None] * n_s - light
        view = -dirs[sphere_front]
        spec = np.clip(np.sum(refl * view, axis=-1), 0.0, 1.0) ** 24
        col = np.clip(col + specular * spec[:, None], 0.0, 1.0)
    img[sphere_front] = col
    disk_front = d_hit & (~sphere_front | (t_d < t_s))
    img[disk_front] = _occluder_texture(p_d[disk_front])
    return img.astype(np.float32)


@dataclasses.dataclass
class OccludedScene(SyntheticScene):
    """The sphere scene plus its occluder disk's analytic parameters."""

    occ_center: np.ndarray = None
    occ_normal: np.ndarray = None
    occ_radius: float = 0.0

    def point_occlusion_matrix(self, pts: np.ndarray) -> np.ndarray:
        """(N, V) bool: does view v's ray to point p cross the disk?"""
        pts = np.asarray(pts, np.float64)
        V = self.Ps.shape[0]
        out = np.zeros((len(pts), V), bool)
        for v in range(V):
            cam = _camera_center(self.Ps[v])
            d = pts - cam
            denom = d @ self.occ_normal
            safe = np.where(np.abs(denom) < 1e-9, np.inf, denom)
            t = ((self.occ_center - cam) @ self.occ_normal) / safe
            p = cam + t[:, None] * d
            out[:, v] = (
                (t > 0.0) & (t < 1.0)
                & (np.linalg.norm(p - self.occ_center, axis=-1)
                   < self.occ_radius)
            )
        return out

    def occluded_views(self) -> np.ndarray:
        """Views whose ray to the sphere centre crosses the disk."""
        out = []
        for v in range(self.Ps.shape[0]):
            cam = _camera_center(self.Ps[v])
            d = self.center - cam
            denom = d @ self.occ_normal
            if abs(denom) < 1e-9:
                continue
            t = ((self.occ_center - cam) @ self.occ_normal) / denom
            if not 0.0 < t < 1.0:
                continue
            if np.linalg.norm(cam + t * d - self.occ_center) < self.occ_radius:
                out.append(v)
        return np.asarray(out, int)


def make_occluded_scene(
    n_views: int = 12,
    hw: Tuple[int, int] = (120, 160),
    radius: float = 30.0,
    cam_dist: float = 120.0,
    focal: float = 200.0,
    occ_dist: float = 52.0,
    occ_radius: float = 55.0,
    specular: float = 0.35,
    seed: int = 0,
) -> OccludedScene:
    """The occluded golden scene: the sphere scene's ring of cameras, a
    specular lobe on the sphere, and a tiled occluder disk at azimuth 0,
    outside the sweep's bbox, that hides the sphere from the views nearest
    +x.  No frustum or baseline test can tell those views apart; a learned
    patch similarity can."""
    center = np.zeros(3)
    occ_dir = np.array([1.0, 0.0, 0.0])
    occ_center = center + occ_dist * occ_dir
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
        images.append(
            _trace_occluded_sphere(
                P, hw, center, radius,
                occ_center, -occ_dir, occ_radius, specular=specular,
            )
        )

    pad = radius * 0.35
    if not occ_dist > radius + pad:
        raise ValueError(f"occ_dist={occ_dist} must lie outside the bbox "
                         f"(> {radius + pad})")
    return OccludedScene(
        images=np.stack(images),
        Ps=np.stack(Ps),
        bbox_min=center - radius - pad,
        bbox_max=center + radius + pad,
        center=center,
        radius=radius,
        occ_center=occ_center,
        occ_normal=-occ_dir,
        occ_radius=occ_radius,
    )
