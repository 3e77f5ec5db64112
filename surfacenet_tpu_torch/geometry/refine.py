"""Self-calibration refinement prepass (photometric bundle adjustment).

Port of ``surfacenet_tpu/geometry/refine.py``.  Per-view image-space
corrections duv (V, 2) are optimized against cross-view photo-consistency
of a set of textured probe points, with alternating Adam phases over the
probe slack dx and the view shifts duv on a mean-pooled image pyramid.
The JAX package's module docstring gives the measurements behind each
design choice.

The optimizer is PyTorch's autograd with a hand-written Adam step equal
to ``optax.adam`` (b1 0.9, b2 0.999, eps 1e-8, bias-corrected).  Like the
reference, ``refine_calibration`` applies the shifts to a float32 copy of
the matrices and returns float32 whatever dtype came in.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from surfacenet_tpu_torch.device import resolve_device
from surfacenet_tpu_torch.geometry.camera import project
from surfacenet_tpu_torch.ops.cvc import bilinear_sample


def apply_uv_shift(Ps, duv):
    """P'[0] = P[0] + du*P[2]; P'[1] = P[1] + dv*P[2].  (V,3,4), (V,2) -> (V,3,4)."""
    row0 = Ps[:, 0] + duv[:, 0:1] * Ps[:, 2]
    row1 = Ps[:, 1] + duv[:, 1:2] * Ps[:, 2]
    return torch.stack([row0, row1, Ps[:, 2]], dim=1)


def _sample_views(images, uv, w):
    """images (V,H,W,3), uv (V,K,2), w (V,K) -> colors (V,K,3), valid (V,K)."""
    colors, valid = bilinear_sample(images, uv)
    return colors, valid & (w > 0)


def _robust_view_stats(c, m, *, T: float = 0.02, iters: int = 2):
    """IRLS-robust per-probe cross-view colour statistics.

    c (V, K, 3) colours, m (V, K) valid.  Returns (mean (K, 3),
    weights (V, K), weighted variance (K,)).
    """
    mf = m.float()
    w = mf
    for _ in range(iters + 1):
        denom = torch.clamp(w.sum(dim=0), min=1e-6)
        mean = torch.einsum("vk,vkc->kc", w, c) / denom[:, None]
        d2 = torch.mean((c - mean[None]) ** 2, dim=-1)
        w = mf * torch.exp(-d2 / T)
    denom = torch.clamp(w.sum(dim=0), min=1e-6)
    var = torch.sum(w * d2, dim=0) / denom
    return mean, w, var


def _build_pyramid(images, levels: Tuple[int, ...]):
    """Mean-pool pyramid of (V, H, W, 3) at the given integer factors."""
    pyr = {}
    for lv in sorted(set(levels), reverse=True):
        if lv == 1:
            pyr[1] = images
            continue
        V, H, W, C = images.shape
        Hc, Wc = (H // lv) * lv, (W // lv) * lv
        x = images[:, :Hc, :Wc].reshape(V, Hc // lv, lv, Wc // lv, lv, C)
        pyr[lv] = x.mean(dim=(2, 4))
    return pyr


def _probe_score(imgs_p, Ps, pts, pool: int, texture_eps_mm: float):
    """Texture-gated robust consistency score of points (see
    ``photometric_probes``)."""

    def sample(p):
        uv, w = project(Ps, p)
        return _sample_views(imgs_p, (uv + 0.5) / pool - 0.5, w)

    c, m = sample(pts)
    _, wts, var = _robust_view_stats(c, m)
    consistency = torch.exp(-var * 60.0)
    eye = torch.eye(3, dtype=pts.dtype, device=pts.device)
    offs = torch.cat([eye, -eye], dim=0) * texture_eps_mm
    tex_acc = 0.0
    for o in offs:
        c_o, m_o = sample(pts + o[None])
        tex_acc = tex_acc + torch.mean((c_o - c) ** 2, dim=-1) * m_o.float()
    denom = torch.clamp(wts.sum(dim=0), min=1e-6)
    tau = 1e-4  # weighted harmonic mean: a textureless view vetoes
    tex = denom / torch.clamp(
        torch.sum(wts / (tex_acc + tau), dim=0), min=1e-9
    ) - tau
    texture_gate = 1.0 - torch.exp(-tex * 300.0)
    enough = (denom >= 3.0).float()
    return consistency * texture_gate * enough


def photometric_probes(
    images: torch.Tensor,
    Ps: torch.Tensor,
    bbox_min,
    bbox_max,
    *,
    n_probes: int = 2048,
    grid: int = 48,
    texture_eps_mm: float | None = None,
    pool: int = 4,
) -> np.ndarray:
    """Top-K photo-consistent, textured points on a coarse bbox grid.

    images (V, H, W, 3) float32 and Ps (V, 3, 4) float32, on one device.
    Returns (n_probes, 3) float32 world points (numpy).
    """
    bbox_min = np.asarray(bbox_min, np.float64)
    bbox_max = np.asarray(bbox_max, np.float64)
    step = (bbox_max - bbox_min) / grid
    if texture_eps_mm is None:
        texture_eps_mm = float(np.min(step))
    axes = [bbox_min[i] + (np.arange(grid) + 0.5) * step[i] for i in range(3)]
    gx, gy, gz = np.meshgrid(*axes, indexing="ij")
    centers = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)

    dev = images.device
    imgs_p = _build_pyramid(images, (pool,))[pool]
    CH = 65536

    def score(pts: np.ndarray) -> np.ndarray:
        out = []
        for i in range(0, len(pts), CH):
            p = torch.as_tensor(pts[i: i + CH], dtype=torch.float32,
                                device=dev)
            out.append(
                _probe_score(imgs_p, Ps, p, pool, texture_eps_mm).cpu().numpy()
            )
        return np.concatenate(out)

    with torch.no_grad():
        scores = score(centers)
        k = min(n_probes, len(centers))
        top = np.argpartition(-scores, k - 1)[:k]
        probes = centers[top].astype(np.float32)
        # sub-cell localization: hill-climb the 27-neighbourhood argmax
        offs27 = np.array(
            [[i, j, l] for i in (-1, 0, 1) for j in (-1, 0, 1)
             for l in (-1, 0, 1)], np.float32
        )
        h = np.asarray(step, np.float32) / 2.0
        for _ in range(3):
            cand = (probes[:, None, :] + offs27[None] * h[None, None])
            sc = score(cand.reshape(-1, 3)).reshape(len(probes), 27)
            probes = cand[np.arange(len(probes)), np.argmax(sc, axis=1)]
            h = h / 2.0
    return probes.astype(np.float32)


def _remove_rigid(dx: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Project the best-fit rigid motion (translation + infinitesimal
    rotation) out of a per-point displacement field."""
    t = dx.mean(dim=0)
    xc = x - x.mean(dim=0)
    r = dx - t
    x2 = torch.sum(xc * xc, dim=-1)[:, None, None]
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    A = torch.sum(x2 * eye[None] - xc[:, :, None] * xc[:, None, :], dim=0)
    b = torch.linalg.cross(xc, r).sum(dim=0)
    omega = torch.linalg.solve(A + 1e-6 * eye, b)
    return r - torch.linalg.cross(omega.expand_as(xc), xc)


class OptaxAdam:
    """``optax.adam``: b1 0.9, b2 0.999, eps 1e-8 (outside the root),
    bias-corrected moments, update ``p -= lr * m_hat / (sqrt(v_hat) + eps)``.
    Each moment update keeps optax's operation order,
    ``(1 - b) * g**k + b * t``."""

    def __init__(self, param: torch.Tensor, lr: float,
                 b1=0.9, b2=0.999, eps=1e-8):
        self.p, self.lr, self.b1, self.b2, self.eps = param, lr, b1, b2, eps
        self.m = torch.zeros_like(param)
        self.v = torch.zeros_like(param)
        self.count = 0

    @torch.no_grad()
    def step(self, g: torch.Tensor) -> None:
        self.count += 1
        self.m.mul_(self.b1).add_((1 - self.b1) * g)
        self.v.mul_(self.b2).add_((1 - self.b2) * (g * g))
        # bias corrections in float32, as optax computes them
        c1 = 1 - np.float32(self.b1) ** np.float32(self.count)
        c2 = 1 - np.float32(self.b2) ** np.float32(self.count)
        m_hat = self.m / float(c1)
        v_hat = self.v / float(c2)
        self.p.sub_(self.lr * (m_hat / (torch.sqrt(v_hat) + self.eps)))


def refine_calibration(
    images,
    Ps,
    bbox_min,
    bbox_max,
    *,
    n_probes: int = 2048,
    grid: int = 64,
    slack_mm: float = 0.5,
    levels: Tuple[int, ...] = (8, 4, 2, 1),
    steps_per_level: int = 80,
    lr: float = 0.3,
    huber_delta: float = 0.1,
    probe_pool: int = 4,
    device="cuda",
):
    """Estimate and apply per-view image-space calibration corrections.

    ``images`` (V, H, W, 3) may be numpy or a tensor; it is used in float32
    on ``device``.  Returns (Ps_refined (V, 3, 4) float32 numpy, info
    dict with ``duv_px``, ``max_shift_px``, ``level_losses``).
    """
    dev = resolve_device(device)
    Ps_np = np.asarray(Ps)
    images_t = torch.as_tensor(images, dtype=torch.float32, device=dev)
    Ps_t = torch.as_tensor(Ps_np, dtype=torch.float32, device=dev)
    probes = torch.as_tensor(
        photometric_probes(
            images_t, Ps_t, bbox_min, bbox_max,
            n_probes=n_probes, grid=grid, pool=probe_pool,
        ),
        device=dev,
    )
    V, K = Ps_t.shape[0], probes.shape[0]
    pyr = _build_pyramid(images_t, tuple(levels))

    def loss_fn(duv, dx_raw, imgs_lv, lv):
        dx = _remove_rigid(torch.tanh(dx_raw) * slack_mm, probes)
        duv = duv - duv.mean(dim=0, keepdim=True)
        uv, w = project(apply_uv_shift(Ps_t, duv), probes + dx)
        c, m = _sample_views(imgs_lv, (uv + 0.5) / lv - 0.5, w)
        mean, wts, _ = _robust_view_stats(c, m)
        # the robust weights pick the visible views: a weighting, not an
        # objective term, so no gradient flows through them
        wts = wts.detach()[..., None]
        r = c - mean[None]
        hub = torch.where(
            r.abs() <= huber_delta,
            0.5 * r * r,
            huber_delta * (r.abs() - 0.5 * huber_delta),
        )
        wsum = torch.clamp(wts.sum(dim=(0, 2)), min=1e-6)
        r_probe = torch.sum(hub * wts, dim=(0, 2)) / wsum  # (K,)
        med = torch.quantile(r_probe.detach(), 0.5)
        w_probe = torch.exp(
            -r_probe / torch.clamp(2.0 * med, min=1e-8)
        ).detach()
        num = torch.sum(r_probe * w_probe * wsum)
        return num / torch.clamp(torch.sum(w_probe * wsum), min=1e-6)

    duv = torch.zeros((V, 2), dtype=torch.float32, device=dev)
    dx = torch.zeros((K, 3), dtype=torch.float32, device=dev)
    info = {"level_losses": []}

    def run_phase(imgs_lv, lv, which: str, n_steps: int):
        """One Adam phase optimizing only ``which`` (alternating, as the
        reference does: the joint problem has a near-null-space)."""
        param = dx if which == "dx" else duv
        opt = OptaxAdam(param, lr)
        losses = []
        for _ in range(n_steps):
            param.requires_grad_(True)
            loss = loss_fn(duv, dx, imgs_lv, lv)
            (g,) = torch.autograd.grad(loss, [param])
            param.requires_grad_(False)
            opt.step(g)
            losses.append(loss.detach())
        return losses

    for lv in levels:
        l_dx = run_phase(pyr[lv], lv, "dx", steps_per_level)
        l_duv = run_phase(pyr[lv], lv, "duv", steps_per_level)
        info["level_losses"].append(
            (int(lv), float(l_dx[0]), float(l_duv[-1]))
        )

    duv_np = (duv - duv.mean(dim=0, keepdim=True)).cpu().numpy()
    info["duv_px"] = duv_np
    info["max_shift_px"] = float(np.abs(duv_np).max())
    # float32 whatever came in, as the reference applies the shift to its
    # float32 copy of the matrices
    Ps_out = apply_uv_shift(
        torch.as_tensor(Ps_np, dtype=torch.float32), torch.as_tensor(duv_np),
    ).numpy()
    return Ps_out, info


def refine_calibration_auto(
    images,
    Ps,
    bbox_min,
    bbox_max,
    *,
    second_pass_threshold_px: float = 1.0,
    deep_restart_threshold_px: float = float("inf"),
    **kw,
):
    """Production entry: one pass; a polish pass from the corrected matrices
    when the first detects shifts beyond ``second_pass_threshold_px``; and
    optionally (finite ``deep_restart_threshold_px``) a restart with a
    deeper pyramid.  Returns (Ps_refined, info); info["duv_px"] is the total
    correction."""
    Ps1, i1 = refine_calibration(images, Ps, bbox_min, bbox_max, **kw)
    passes = ["default"]
    if i1["max_shift_px"] <= second_pass_threshold_px:
        i1["passes"] = 1
        return Ps1, i1
    if i1["max_shift_px"] > deep_restart_threshold_px:
        deep_kw = dict(kw, levels=(16, 8, 4, 2, 1), probe_pool=8)
        Ps1, i1 = refine_calibration(images, Ps, bbox_min, bbox_max, **deep_kw)
        passes = ["deep_restart"]
    Ps2, i2 = refine_calibration(images, Ps1, bbox_min, bbox_max, **kw)
    passes.append("polish")
    total = i1["duv_px"] + i2["duv_px"]
    return Ps2, {
        "passes": len(passes),
        "pass_kinds": passes,
        "duv_px": total,
        "max_shift_px": float(np.abs(total).max()),
        "level_losses": i1["level_losses"] + i2["level_losses"],
    }
