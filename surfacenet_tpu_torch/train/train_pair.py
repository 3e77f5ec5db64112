"""Triplet training of the pair net (``models/pairnet.py``).

Port of ``surfacenet_tpu/train/train_pair.py``.  Anchor and positive are
patches of one surface point seen from two views; the negative is a patch
of another point, or, on a scene with an analytic occluder, of the same
point seen through the occluder (a hard negative).  The net trains with a
margin triplet loss and the optax-equal Adam of ``geometry/refine.py``.

Sampling is on the host and draws the reference's numbers for the same
``np.random.Generator``; crops are one indexed gather (``extract_patches``)
at the pixels the reference's crops take.  Checkpoints are ``.npz`` files
``pairnet_<step>.npz`` (the reference writes Orbax directories of the
same name; ``models/convert.py`` converts those).
"""

from __future__ import annotations

import os
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from surfacenet_tpu_torch.config import Config, PairNetConfig
from surfacenet_tpu_torch.device import resolve_device
from surfacenet_tpu_torch.geometry.camera import project_crop
from surfacenet_tpu_torch.geometry.refine import OptaxAdam
from surfacenet_tpu_torch.models.convert import load_npz, save_npz
from surfacenet_tpu_torch.models.pairnet import (
    PairNet, init_pairnet, triplet_loss,
)


def extract_patches(images: torch.Tensor, view_idx, uv: torch.Tensor,
                    size: int) -> torch.Tensor:
    """Integer crops with zero padding, as one indexed gather.

    Args:
      images: (V, H, W, C); view_idx: (B,) int; uv: (B, 2) float pixel
        centres.  A crop starts at ``round(uv) - size // 2`` (rounding half
        to even, as ``np.round``).
    Returns:
      (B, size, size, C) on ``images``' device.
    """
    V, H, W, C = images.shape
    dev = images.device
    view_idx = torch.as_tensor(view_idx, device=dev).long()
    corner = torch.round(uv.to(dev)).long() - size // 2  # (B, 2): u0, v0
    r = torch.arange(size, device=dev)
    xs = corner[:, 0, None] + r  # (B, size)
    ys = corner[:, 1, None] + r
    inside = (((ys >= 0) & (ys < H))[:, :, None]
              & ((xs >= 0) & (xs < W))[:, None, :])
    idx = ((view_idx[:, None, None] * H + ys.clamp(0, H - 1)[:, :, None])
           * W + xs.clamp(0, W - 1)[:, None, :])
    crops = images.reshape(V * H * W, C).index_select(
        0, idx.reshape(-1)).reshape(idx.shape + (C,))
    return torch.where(inside[..., None], crops, 0.0).to(images.dtype)


def sample_triplets(
    scene,
    cfg: Config,
    rng: np.random.Generator,
    batch: Optional[int] = None,
    hard_negative_frac: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(anchor, positive, negative) patch batches, (B, P, P, 3) float32.

    Points and view pairs are drawn again until the point projects inside
    both views' patch bounds.  A negative is the positive patch of the
    round's previous point (``np.roll``); a one-point round takes the
    previous row's positive.  With ``hard_negative_frac`` on a scene that
    has ``point_occlusion_matrix``, anchors and positives are unoccluded
    views of their point, and that fraction of negatives is the same point
    through the occluder, where such a view projects inside the bounds.

    Raises ValueError for a batch below 2: its one row has no other point
    to take a negative from (the reference loops forever there).
    """
    B = batch or cfg.train.batch_size
    if B < 2:
        raise ValueError(f"sample_triplets needs a batch of at least 2, "
                         f"got {B}: a negative is another row's point")
    P = cfg.pairnet.patch_size
    V = scene.Ps.shape[0]
    H, W = scene.images.shape[1:3]
    images = torch.from_numpy(np.ascontiguousarray(scene.images, np.float32))
    Ps = torch.from_numpy(np.asarray(scene.Ps)).float()

    anchors = np.zeros((B, P, P, 3), np.float32)
    positives = np.zeros((B, P, P, 3), np.float32)
    negatives = np.zeros((B, P, P, 3), np.float32)
    occ_aware = hard_negative_frac > 0.0 and hasattr(
        scene, "point_occlusion_matrix")

    def in_patch_bounds(uv):
        return ((uv > P // 2).all(-1)
                & (uv < [W - P // 2, H - P // 2]).all(-1))

    def crops(views, uv):
        return extract_patches(images, views, torch.from_numpy(uv),
                               P).numpy()

    filled = 0
    while filled < B:
        n = (B - filled) * 2
        pts = scene.surface_points(n, seed=int(rng.integers(1 << 31)))
        va = rng.integers(0, V, n)
        vb = (va + rng.integers(1, max(V // 3, 2), n)) % V
        pts_t = torch.from_numpy(pts).float()
        uv_a, wa = (t.numpy() for t in project_crop(Ps[va], pts_t))
        uv_b, wb = (t.numpy() for t in project_crop(Ps[vb], pts_t))
        ok = ((wa > 0) & (wb > 0) & in_patch_bounds(uv_a)
              & in_patch_bounds(uv_b))
        occ_mat = None
        if occ_aware:
            occ_mat = scene.point_occlusion_matrix(pts)  # (n, V)
            ok &= ~occ_mat[np.arange(n), va] & ~occ_mat[np.arange(n), vb]
        idx = np.nonzero(ok)[0][: B - filled]
        if len(idx) == 0:
            continue
        k = len(idx)
        anchors[filled: filled + k] = crops(va[idx], uv_a[idx])
        positives[filled: filled + k] = crops(vb[idx], uv_b[idx])
        if k == 1 and filled == 0:
            continue  # no earlier row to borrow a negative from: redraw
        perm = np.roll(idx, 1)
        neg = crops(vb[perm], uv_b[perm])
        if k == 1:
            neg[0] = positives[filled - 1]
        if occ_aware:
            want_hard = rng.random(k) < hard_negative_frac
            for j in np.nonzero(want_hard)[0]:
                pi = idx[j]
                cand = np.nonzero(occ_mat[pi])[0]
                if not len(cand):
                    continue
                vc = int(rng.choice(cand))
                uv_c, wc = project_crop(Ps[vc], pts_t[pi][None])
                uv_c = uv_c.numpy()
                if float(wc[0]) <= 0 or not in_patch_bounds(uv_c)[0]:
                    continue
                neg[j] = crops(np.asarray([vc]), uv_c)[0]
        negatives[filled: filled + k] = neg
        filled += k
    return anchors, positives, negatives


def make_optimizer(model: PairNet, lr: float) -> List[OptaxAdam]:
    """``optax.adam(lr)``: one optax-equal Adam state per parameter."""
    return [OptaxAdam(p, lr) for p in model.parameters()]


def pair_train_step(model: PairNet, optimizer: Sequence[OptaxAdam],
                    anc: torch.Tensor, pos: torch.Tensor, neg: torch.Tensor,
                    *, margin: float) -> torch.Tensor:
    """One Adam step on the triplet loss; returns the loss (a 0-d tensor,
    not synchronised).  The three batches go through one forward."""
    B = anc.shape[0]
    model.zero_grad(set_to_none=True)
    emb = model(torch.cat([anc, pos, neg]))
    loss = triplet_loss(emb[:B], emb[B: 2 * B], emb[2 * B:], margin)
    loss.backward()
    for opt in optimizer:
        opt.step(opt.p.grad)
    return loss.detach()


def _upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    x = torch.from_numpy(a)
    if dev.type == "cuda":  # pinned, so the copy does not stall the host
        return x.pin_memory().to(dev, non_blocking=True)
    return x


def train_pairnet(
    scene,
    cfg: Config,
    n_steps: int = 200,
    lr: float = 1e-3,
    hard_negative_frac: float = 0.0,
    device="cuda",
) -> Tuple[PairNet, list]:
    """Train the pair net from ``init_pairnet``; returns (model, losses).

    ``scene`` may be one scene or a list of scenes; each step samples its
    batch from a scene drawn from the same generator
    (``np.random.default_rng(cfg.train.seed)``).  Sampling runs on the
    host while the device runs the previous step; the losses are read once,
    at the end.
    """
    dev = resolve_device(device)
    scenes = scene if isinstance(scene, (list, tuple)) else [scene]
    rng = np.random.default_rng(cfg.train.seed)
    model = init_pairnet(cfg.pairnet,
                         torch.Generator().manual_seed(cfg.train.seed))
    model = model.to(dev).train()
    optimizer = make_optimizer(model, lr)
    losses = []
    for _ in range(n_steps):
        sc = scenes[int(rng.integers(len(scenes)))]
        anc, pos, neg = sample_triplets(
            sc, cfg, rng, hard_negative_frac=hard_negative_frac)
        losses.append(pair_train_step(
            model, optimizer, _upload(anc, dev), _upload(pos, dev),
            _upload(neg, dev), margin=cfg.pairnet.margin))
    losses = torch.stack(losses).cpu().tolist() if losses else []
    return model.eval(), losses


def save_pairnet(ckpt_dir: str, model: PairNet, step: int = 0) -> str:
    """Write ``<ckpt_dir>/pairnet_<step>.npz``; returns its path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"pairnet_{step}.npz")
    save_npz(model.state_dict(), path)
    return path


def restore_pairnet(path: str, cfg: PairNetConfig,
                    step: Optional[int] = None) -> PairNet:
    """A ``PairNet`` (eval mode, CPU) from a checkpoint.

    ``path`` names a ``pairnet_<step>.npz`` file, or a directory holding
    such files (``step`` picks one; default the highest).  A missing file
    or one whose tensors do not fit ``cfg`` raises.
    """
    if not os.path.basename(os.path.normpath(path)).startswith("pairnet_"):
        if step is None:
            steps = sorted(
                int(m.group(1)) for m in (
                    re.fullmatch(r"pairnet_(\d+)\.npz", f)
                    for f in os.listdir(path)) if m
            )
            if not steps:
                raise FileNotFoundError(
                    f"no pairnet_<step>.npz checkpoints under {path}")
            step = steps[-1]
        path = os.path.join(path, f"pairnet_{step}.npz")
    model = PairNet(cfg)
    model.load_state_dict(load_npz(path))
    return model.eval()
