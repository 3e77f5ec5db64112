"""SurfaceNet training on one card, or data parallel over ranks.

Port of ``surfacenet_tpu/train/train_surface.py``: cubes sampled around
the ground-truth surface, voxelized
occupancy labels, the CVC-pair gather, class-balanced BCE, SGD with
momentum and weight decay (the reference's ``add_decayed_weights`` then
``sgd`` make ``torch.optim.SGD``'s update) under an optional cosine
schedule, and ``.npz`` checkpoints.

``train_surfacenet`` keeps the reference's three loops:

  * the analytic scan path (synthetic scenes): a candidate table of surface
    points and their top-k view pairs is built once; every step draws
    cubes, jitter, labels and a pair on the device, and K steps
    (``train.scan_chunk``) run back to back with their losses read once a
    chunk, where the reference runs them as one ``lax.scan`` dispatch;
  * the pool path (a ``PointCloudScene``, or several scenes of one image
    size): a pool of cubes with bit-packed labels built on the host once
    (and at each refresh), drawn from on the device;
  * the host loop (``scan_chunk == 0``, or scenes of mixed image sizes):
    ``sample_training_batch`` in numpy every step.

The gather: ``build_cvc_batch_cuda``, the warp-gather kernel on the card
and its plain version on the CPU, on one copy of the images made once a
run (``gather_copy``): bf16 RGBx on the card with
``sweep.use_pallas_gather`` (the reference's training gather samples bf16
whatever ``sweep.gather_dtype`` says), else float32, the reference's
oracle's images.  Its crop windows are a TPU workaround the oracle does
not have, and the port has none.

Random draws come from ``torch.Generator`` objects on the step's device,
so they are not the reference's ``jax.random`` bits; the host sampler is
numpy and draws the reference's numbers for the same generator.  A
resumed run (``start_step`` > 0) takes a new stream per start offset, as
the reference folds the offset into its key, not a replay.

Data parallel (``train_surfacenet(mesh=...)``, ``cli train --sharded``):
every rank holds the same model and optimizer, draws the same global
batch from the same generator (so the streams are the single process's),
and gathers and runs only its rows; BatchNorm normalises by the global
batch's statistics and the loss divides by the global batch's weight
(``SyncBatchNormFn``, ``class_balanced_bce(group=)``), so the ranks'
losses add up to the single process's, and their gradients are
all-reduced as a sum (``DistributedDataParallel`` would average them).
A pool of point-cloud cubes is built on rank 0 and broadcast: its host
build is the slow part (minutes at ``pool_size`` 2048), and the ranks
would build the same bytes.  Checkpoints come from rank 0.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from surfacenet_tpu_torch.config import Config, TrainConfig
from surfacenet_tpu_torch.data.synthetic import SDFScene, SyntheticScene
from surfacenet_tpu_torch.device import resolve_device
from surfacenet_tpu_torch.models.convert import (
    load_npz, load_surfacenet, save_npz,
)
from surfacenet_tpu_torch.models.surfacenet import SurfaceNet, init_surfacenet
from surfacenet_tpu_torch.ops.cuda.warp_gather import build_cvc_batch_cuda
from surfacenet_tpu_torch.ops.view_pairs import select_pairs_geometric
from surfacenet_tpu_torch.parallel.distributed import (
    all_reduce_, broadcast_object,
)
from surfacenet_tpu_torch.pipeline.sweep import gather_images
from surfacenet_tpu_torch.train.losses import class_balanced_bce

# optax.cosine_decay_schedule's alpha in the reference: the floor of the
# cosine as a fraction of the base learning rate
COSINE_ALPHA = 0.05


@dataclasses.dataclass
class TrainState:
    """The model (float32 master weights on the device, ``train()``
    mode while a step runs), its optimizer and the count of updates made:
    the reference's flax ``TrainState`` with ``batch_stats`` in the
    model's BatchNorm buffers.  ``group``: the data-parallel process group
    (None: one process)."""

    model: SurfaceNet
    optimizer: torch.optim.SGD
    train_cfg: TrainConfig
    step: int = 0
    group: object = None


def learning_rate(tcfg: TrainConfig, step: int) -> float:
    """The learning rate of the update made at ``step`` (updates counted
    before it, as optax counts): constant, or optax's
    ``cosine_decay_schedule(lr, max(n_steps, 1), alpha=0.05)``."""
    if tcfg.lr_decay == "none":
        return tcfg.lr
    if tcfg.lr_decay == "cosine":
        T = max(tcfg.n_steps, 1)
        cosine = 0.5 * (1.0 + math.cos(math.pi * min(step, T) / T))
        return tcfg.lr * ((1.0 - COSINE_ALPHA) * cosine + COSINE_ALPHA)
    raise ValueError(f"unknown lr_decay {tcfg.lr_decay!r}")


def create_train_state(cfg: Config, generator: Optional[torch.Generator] = None,
                       device="cuda") -> TrainState:
    """A fresh model (seeded from ``generator``, else ``cfg.train.seed``)
    in float32 on ``device``, channels-last, with SGD over every
    parameter, BatchNorm scale and shift included (optax's
    ``add_decayed_weights`` has no mask)."""
    learning_rate(cfg.train, 0)  # an unknown schedule fails here
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.train.seed)
    model = init_surfacenet(cfg.model, generator).to(dev)
    model = model.to(memory_format=torch.channels_last_3d).train()
    opt = torch.optim.SGD(model.parameters(), lr=cfg.train.lr,
                          momentum=cfg.train.momentum,
                          weight_decay=cfg.train.weight_decay)
    return TrainState(model, opt, cfg.train)


def state_from_weights(cfg: Config, path: str, device="cuda") -> TrainState:
    """A fresh ``TrainState`` whose model holds a ``save_npz`` file's
    weights, BatchNorm statistics and counters (copied in place: float32,
    channels-last), with no momentum and ``step`` 0: the reference's
    ``create_train_state`` then ``state.replace(params=...,
    batch_stats=...)``, the start of a fine-tune from a trained net
    (``scripts/calib_finetune_eval.py``)."""
    state = create_train_state(cfg, device=device)
    state.model.load_state_dict(load_npz(path))
    return state


def perturb_calibration(Ps: torch.Tensor, duv: torch.Tensor) -> torch.Tensor:
    """Per-view principal-point shift by ``duv`` (V, 2) pixels: P[0] +=
    du P[2], P[1] += dv P[2] (the reference draws duv = sigma N(0, 1) per
    step; ``train_step`` draws it from its generator)."""
    Ps = Ps.clone()
    Ps[:, 0] += duv[:, 0, None] * Ps[:, 2]
    Ps[:, 1] += duv[:, 1, None] * Ps[:, 2]
    return Ps


def gather_copy(images, cfg: Config, device) -> torch.Tensor:
    """The run's one image copy for the gather (``gather_images``): bf16
    on the card with ``sweep.use_pallas_gather``, else float32 (the
    reference samples float32 on its CPU backend and without the flag);
    RGBx on the card."""
    dev = resolve_device(device)
    bf16 = cfg.sweep.use_pallas_gather and dev.type == "cuda"
    if not torch.is_tensor(images):  # make_pool_sampler_multi gives a tensor
        images = torch.from_numpy(np.asarray(images))
    t = images.to(dev, torch.float32)
    return gather_images(t, torch.bfloat16 if bf16 else torch.float32)


def train_step(
    state: TrainState,
    images: torch.Tensor,  # gather_copy
    Ps: torch.Tensor,  # (V, 3, 4) float32
    origins: torch.Tensor,  # (B, 3) float32
    pair_idx: torch.Tensor,  # (B, 2) int
    labels: torch.Tensor,  # (B, D, D, D)
    generator: Optional[torch.Generator] = None,
    *,
    D: int,
    s: float,
    balanced: bool,
    center_colors: bool,
    aug_sigma_px: float = 0.0,
    aug_anneal_steps: int = 0,
) -> torch.Tensor:
    """One gather + forward + backward + update; updates ``state`` in
    place and returns the loss as a device scalar (not synchronised).

    With ``aug_sigma_px`` > 0 and a generator, the views' principal points
    move by N(0, sigma) pixels first; ``aug_anneal_steps`` > 0 decays
    sigma linearly to 0 at that step, counted by ``state.step`` (so a
    resumed run anneals as the unbroken one would).

    With ``state.group`` every rank passes the same global batch and runs
    its contiguous share of the rows; the gradients and the returned loss
    are the group's sums (the loss is then synchronised)."""
    group = state.group
    if group is not None:
        r, w = dist.get_rank(group), dist.get_world_size(group)
        n = origins.shape[0] // w
        origins, pair_idx, labels = (t[r * n:(r + 1) * n]
                                     for t in (origins, pair_idx, labels))
    if aug_sigma_px > 0.0 and generator is not None:
        sigma = aug_sigma_px
        if aug_anneal_steps > 0:
            sigma *= min(max(1.0 - state.step / aug_anneal_steps, 0.0), 1.0)
        duv = sigma * torch.randn((Ps.shape[0], 2), generator=generator,
                                  device=Ps.device)
        Ps = perturb_calibration(Ps, duv)
    x, valid = build_cvc_batch_cuda(images, Ps, pair_idx, origins, D=D, s=s,
                                    center_colors=center_colors)
    logits = state.model.train()(x, return_logits=True, bn_group=group)
    loss = class_balanced_bce(logits, labels, valid, balanced, group=group)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    loss = loss.detach()
    if group is not None:
        grads = [p.grad for p in state.model.parameters()]
        flat = all_reduce_(_flatten_dense_tensors(grads), group)
        for g, total in zip(grads, _unflatten_dense_tensors(flat, grads)):
            g.copy_(total)
        loss = all_reduce_(loss.reshape(1), group)[0]
    lr = learning_rate(state.train_cfg, state.step)
    for param_group in state.optimizer.param_groups:
        param_group["lr"] = lr
    state.optimizer.step()
    state.step += 1
    return loss


@torch.no_grad()
def eval_step(state: TrainState, images, Ps, origins, pair_idx, labels, *,
              D: int, s: float, center_colors: bool):
    """Balanced loss and IoU at 0.5 on a batch, running statistics, no
    update: (loss, iou) device scalars."""
    x, valid = build_cvc_batch_cuda(images, Ps, pair_idx, origins, D=D, s=s,
                                    center_colors=center_colors)
    logits = state.model.eval()(x, return_logits=True)
    loss = class_balanced_bce(logits, labels, valid, balanced=True)
    pred = (torch.sigmoid(logits) > 0.5) & valid
    gt = (labels > 0.5) & valid
    union = torch.clamp((pred | gt).sum(), min=1)
    return loss, (pred & gt).sum() / union


def voxel_offsets(D: int, s: float, device=None) -> torch.Tensor:
    """(D, D, D, 3) float32 voxel centres relative to a cube's origin."""
    r = (torch.arange(D, dtype=torch.float32, device=device) + 0.5) * s
    return torch.stack(torch.meshgrid(r, r, r, indexing="ij"), dim=-1)


def _select_pairs(scene, origins, cfg: Config, device):
    k = max(cfg.fusion.n_view_pairs, 2)
    sel, _ = select_pairs_geometric(
        scene.Ps, origins, n_pairs=k, image_hw=scene.images.shape[1:3],
        extent_mm=cfg.voxel.cube_extent_mm,
        dist_sigma_frac=cfg.fusion.pair_dist_sigma_frac, device=device,
    )
    return sel


def sample_training_batch(scene, cfg: Config, rng: np.random.Generator,
                          batch: Optional[int] = None, device="cuda"):
    """Host sampling of (origins (B, 3) float32, pair_idx (B, 2) int32,
    labels (B, D, D, D) float32) for one step: cubes centred near random
    surface points with jitter, labels voxelizing the surface, a pair
    drawn from the cube's top-k geometric pairs (the inference selector,
    scored on ``device``).  Draws the reference's numbers for the same
    ``rng``."""
    B = batch or cfg.train.batch_size
    D = cfg.voxel.cube_size
    s = cfg.voxel.voxel_size_mm
    pts = scene.surface_points(B, seed=int(rng.integers(1 << 31)))
    jitter = rng.uniform(-0.25, 0.25, (B, 3)) * D * s
    origins = pts - D * s / 2.0 + jitter
    r = (np.arange(D) + 0.5) * s
    local = np.stack(np.meshgrid(r, r, r, indexing="ij"), axis=-1)
    labels = scene.occupancy(origins[:, None, None, None, :] + local,
                             s).astype(np.float32)
    sel = _select_pairs(scene, origins, cfg, device)
    k = sel.shape[1]
    choice = rng.integers(0, k, B)
    pair_idx = sel[np.arange(B), choice].astype(np.int32)
    return origins.astype(np.float32), pair_idx, labels


# ------------------------------------------------ device-side batch sampling


def sphere_surf_dist(params, pts):
    """Unsigned distance to a sphere; params = (centre (3,), radius)."""
    center, radius = params
    return torch.abs(torch.linalg.norm(pts - center, dim=-1) - radius)


def tori_surf_dist(params, pts):
    """Unsigned distance to a union of tori; params = (centres (T, 3),
    axes (T, 3), R (T,), r (T,)): exact outside every tube, as
    ``SDFScene._sdf``."""
    centers, axes, Rs, rs = params
    q = pts[..., None, :] - centers
    h = torch.sum(q * axes, dim=-1)
    radial = torch.linalg.norm(q - h[..., None] * axes, dim=-1)
    d = torch.sqrt((radial - Rs) ** 2 + h**2) - rs
    return torch.abs(torch.amin(d, dim=-1))


def make_device_sampler(scene, cfg: Config, n_candidates: int = 8192,
                        seed: int = 0, device="cuda"):
    """Device tables for ``train_steps_scan``: (cand_pts (N, 3) float32,
    cand_pairs (N, k, 2) int32, surf_fn, surf_params), or None for a scene
    without an analytic surface (use the pool sampler).  Pairs are chosen
    once per candidate at its un-jittered cube origin."""
    dev = resolve_device(device)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float64), dtype=torch.float32,
                               device=dev)

    if isinstance(scene, SyntheticScene):
        surf_fn = sphere_surf_dist
        surf_params = (f32(scene.center), f32(scene.radius))
    elif isinstance(scene, SDFScene):
        surf_fn = tori_surf_dist
        surf_params = tuple(f32(np.stack(x)) for x in zip(*scene.tori))
    else:
        return None
    D, s = cfg.voxel.cube_size, cfg.voxel.voxel_size_mm
    pts = scene.surface_points(n_candidates, seed=seed)
    sel = _select_pairs(scene, pts - D * s / 2.0, cfg, dev)
    return (f32(pts), torch.as_tensor(sel, dtype=torch.int32, device=dev),
            surf_fn, surf_params)


def sample_device_batch(sampler, generator: torch.Generator, *, batch: int,
                        D: int, s: float):
    """One step's (origins, pair_idx, labels) drawn on the device from the
    ``make_device_sampler`` tables: a candidate, a jitter of +-D s / 4 per
    axis, labels by the analytic distance, one of its top-k pairs."""
    cand_pts, cand_pairs, surf_fn, surf_params = sampler
    dev = cand_pts.device
    idx = torch.randint(cand_pts.shape[0], (batch,), generator=generator,
                        device=dev)
    jitter = (torch.rand((batch, 3), generator=generator, device=dev) * 0.5
              - 0.25) * (D * s)
    origins = cand_pts[idx] - D * s / 2.0 + jitter
    centers = origins[:, None, None, None, :] + voxel_offsets(D, s, dev)
    labels = (surf_fn(surf_params, centers)
              <= s * float(np.sqrt(3)) / 2.0).float()
    choice = torch.randint(cand_pairs.shape[1], (batch,), generator=generator,
                           device=dev)
    return origins, cand_pairs[idx, choice], labels


def train_steps_scan(state: TrainState, images, Ps, sampler,
                     generator: torch.Generator, *, K: int, batch: int,
                     **step_kw) -> torch.Tensor:
    """K training steps with device-side sampling; returns their losses
    (K,) on the device, unsynchronised (the reference's ``lax.scan``
    chunk).  ``step_kw`` are ``train_step``'s keywords."""
    D, s = step_kw["D"], step_kw["s"]
    losses = []
    for _ in range(K):
        origins, pair_idx, labels = sample_device_batch(
            sampler, generator, batch=batch, D=D, s=s)
        losses.append(train_step(state, images, Ps, origins, pair_idx,
                                 labels, generator, **step_kw))
    return torch.stack(losses)


# --------------------------------------------------------- pooled sampling


def make_pool_sampler(scene, cfg: Config, n_pool: int = 2048, seed: int = 0,
                      device="cuda"):
    """A pool of ``n_pool`` cubes for scenes without an analytic surface,
    built on the host once: jittered origins near ground-truth points,
    occupancy labels bit-packed (``np.packbits``, little bit order: D^3/8
    bytes a cube), top-k view pairs.  Returns device tensors (origins
    (N, 3) float32, pairs (N, k, 2) int32, labels (N, D^3/8) uint8), the
    reference's values for the same seed."""
    dev = resolve_device(device)
    D, s = cfg.voxel.cube_size, cfg.voxel.voxel_size_mm
    if (D * D * D) % 8:
        raise ValueError(
            f"pool sampler packs labels bitwise: cube_size={D} needs "
            f"D^3 divisible by 8 (use an even cube size)")
    rng = np.random.default_rng(seed)
    pts = scene.surface_points(n_pool, seed=seed)
    jitter = rng.uniform(-0.25, 0.25, (n_pool, 3)) * D * s
    origins = (pts - D * s / 2.0 + jitter).astype(np.float32)
    r = (np.arange(D) + 0.5) * s
    local = np.stack(np.meshgrid(r, r, r, indexing="ij"), axis=-1)
    # chunks of ~16M centres: the whole pool at once would be tens of GB
    packed = np.empty((n_pool, D * D * D // 8), np.uint8)
    chunk = max(1, (1 << 24) // (D * D * D))
    for i in range(0, n_pool, chunk):
        occ = scene.occupancy(origins[i:i + chunk, None, None, None, :]
                              + local, s)
        packed[i:i + chunk] = np.packbits(occ.reshape(occ.shape[0], -1),
                                          axis=1, bitorder="little")
    sel = _select_pairs(scene, origins, cfg, dev)
    return (torch.as_tensor(origins, device=dev),
            torch.as_tensor(sel, dtype=torch.int32, device=dev),
            torch.as_tensor(packed, device=dev))


def _pool_multi(scenes, cfg: Config, n_pool: int, seed: int, device):
    per = max(1, n_pool // len(scenes))
    parts = [make_pool_sampler(sc, cfg, n_pool=per, seed=seed + i,
                               device=device) for i, sc in enumerate(scenes)]
    V = scenes[0].images.shape[0]
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] + i * V for i, p in enumerate(parts)]),
            torch.cat([p[2] for p in parts]))


def make_pool_sampler_multi(scenes: Sequence, cfg: Config, n_pool: int = 2048,
                            seed: int = 0, device="cuda"):
    """One pool over several scenes of equal image shape: their views
    stacked into one (S V, H, W, 3) array, each scene's pairs offset by
    its first view (pairs form within a scene).  Returns (images float32,
    Ps float32, pool) on the device."""
    dev = resolve_device(device)
    shape = scenes[0].images.shape
    for sc in scenes:
        if sc.images.shape != shape:
            raise ValueError("multi-scene pool needs equal image shapes; got "
                             f"{sc.images.shape} vs {shape}")
    images = torch.as_tensor(np.concatenate([sc.images for sc in scenes]),
                             dtype=torch.float32, device=dev)
    Ps = torch.as_tensor(np.concatenate([sc.Ps for sc in scenes]),
                         dtype=torch.float32, device=dev)
    return images, Ps, _pool_multi(scenes, cfg, n_pool, seed, dev)


def unpack_labels(packed: torch.Tensor, D: int) -> torch.Tensor:
    """(B, D^3/8) uint8, little bit order -> (B, D, D, D) float32."""
    bits = torch.arange(8, dtype=torch.uint8, device=packed.device)
    return ((packed[..., None] >> bits) & 1).reshape(-1, D, D, D).float()


def train_steps_scan_pool(state: TrainState, images, Ps, pool,
                          generator: torch.Generator, *, K: int, batch: int,
                          **step_kw) -> torch.Tensor:
    """K training steps drawing cubes and one of their pairs from a
    ``make_pool_sampler`` pool; losses (K,) on the device."""
    origins_p, pairs_p, labels_p = pool
    dev = origins_p.device
    losses = []
    for _ in range(K):
        idx = torch.randint(origins_p.shape[0], (batch,), generator=generator,
                            device=dev)
        choice = torch.randint(pairs_p.shape[1], (batch,),
                               generator=generator, device=dev)
        losses.append(train_step(
            state, images, Ps, origins_p[idx], pairs_p[idx, choice],
            unpack_labels(labels_p[idx], step_kw["D"]), generator,
            **step_kw))
    return torch.stack(losses)


@torch.no_grad()
def eval_loss_pool(state: TrainState, images, Ps, pool, *, batch: int,
                   D: int, s: float, balanced: bool,
                   center_colors: bool) -> torch.Tensor:
    """Mean loss over a held-out pool in batches (its first pair, running
    statistics, no update): the eval split's loss, a device scalar."""
    origins_p, pairs_p, labels_p = pool
    nb = origins_p.shape[0] // batch
    model = state.model.eval()
    total = torch.zeros((), device=origins_p.device)
    for i in range(nb):
        sl = slice(i * batch, (i + 1) * batch)
        x, valid = build_cvc_batch_cuda(images, Ps, pairs_p[sl, 0],
                                        origins_p[sl], D=D, s=s,
                                        center_colors=center_colors)
        logits = model(x, return_logits=True)
        total += class_balanced_bce(logits, unpack_labels(labels_p[sl], D),
                                    valid, balanced)
    return total / nb


# ----------------------------------------------------------- training loop


@dataclasses.dataclass
class TrainLog:
    steps: list
    losses: list
    eval_steps: list = dataclasses.field(default_factory=list)
    eval_losses: list = dataclasses.field(default_factory=list)


def _stream(device, seed: int, start_step: int = 0) -> torch.Generator:
    """A generator on ``device``: one stream per (seed, start offset)."""
    seq = np.random.SeedSequence((seed, start_step) if start_step else seed)
    return torch.Generator(device=device).manual_seed(
        int(seq.generate_state(1)[0]))


def train_surfacenet(
    scene,
    cfg: Config,
    n_steps: Optional[int] = None,
    state: Optional[TrainState] = None,
    checkpoint_dir: Optional[str] = None,
    log_every: int = 50,
    mesh=None,
    start_step: int = 0,
    device="cuda",
) -> Tuple[TrainState, TrainLog]:
    """The training loop on one device.

    Args:
      scene: a training scene (``SyntheticScene``, ``SDFScene`` or
        ``PointCloudScene``) or a sequence of them; several scenes share
        one pool if their images have one shape, else the host loop takes
        them in turn.
      state: a ``TrainState`` to continue (``restore_checkpoint``) or to
        fine-tune (``state_from_weights``), else a fresh one on
        ``device``.
      start_step: resume offset: the loop runs steps start_step..n_steps,
        logs and checkpoints with their global numbers, and draws a new
        stream for the offset.
      mesh: a ``parallel/mesh.py::RankMesh``: data parallel over its
        ranks, every one of which calls this with the same arguments
        (``train.batch_size`` a multiple of the ranks, the scan path
        ``train.scan_chunk > 0``, a device-samplable scene); the losses
        logged are the global batch's, on every rank.
    """
    tc = cfg.train
    group = None
    if mesh is not None:
        if tc.scan_chunk <= 0:
            raise ValueError(
                "mesh training requires the scan path (train.scan_chunk > 0)")
        if tc.batch_size % mesh.size != 0:
            raise ValueError(f"batch_size={tc.batch_size} must be a multiple "
                             f"of the {mesh.size}-device mesh")
        group = mesh.group
        if mesh.rank != 0:
            checkpoint_dir = None  # one writer
    dev = resolve_device(device)
    scenes = list(scene) if isinstance(scene, (list, tuple)) else [scene]
    rng = np.random.default_rng((tc.seed, start_step) if start_step
                                else tc.seed)
    if state is None:
        state = create_train_state(cfg, device=dev)
    state.group = group
    n_steps = n_steps if n_steps is not None else tc.n_steps

    def shared(build):
        """``build()``'s tensors: built on rank 0 and broadcast under a
        group (every rank would build the same bytes)."""
        if group is None:
            return build()
        got = None
        if dist.get_rank(group) == 0:
            got = [t.cpu().numpy() for t in build()]
        got = broadcast_object(got, src=dist.get_global_rank(group, 0),
                               group=group)
        return tuple(torch.as_tensor(a, device=dev) for a in got)

    step_kw = dict(
        D=cfg.voxel.cube_size, s=cfg.voxel.voxel_size_mm,
        balanced=tc.class_balance, center_colors=cfg.voxel.center_colors,
        aug_sigma_px=tc.aug_calib_sigma_px,
        aug_anneal_steps=tc.aug_calib_anneal_steps,
    )
    log = TrainLog(steps=[], losses=[])

    def build_pool(n, seed):
        def build():
            if len(scenes) == 1:
                return make_pool_sampler(scenes[0], cfg, n_pool=n, seed=seed,
                                         device=dev)
            return _pool_multi(scenes, cfg, n, seed, dev)
        return shared(build)

    sampler = pool = None
    if tc.scan_chunk > 0 and len(scenes) == 1:
        sampler = make_device_sampler(scenes[0], cfg, seed=tc.seed,
                                      device=dev)
        if sampler is None:
            pool = build_pool(tc.pool_size, tc.seed)
        images, Ps = scenes[0].images, scenes[0].Ps
    elif tc.scan_chunk > 0 and len({sc.images.shape for sc in scenes}) == 1:
        # one pool over the scenes' views stacked
        # (make_pool_sampler_multi's)
        images = np.concatenate([sc.images for sc in scenes])
        Ps = np.concatenate([sc.Ps for sc in scenes])
        pool = build_pool(tc.pool_size, tc.seed)
    if mesh is not None and sampler is None and pool is None:
        raise ValueError("mesh training requires a device-samplable scene")

    if sampler is not None or pool is not None:
        images = gather_copy(images, cfg, dev)
        Ps = torch.as_tensor(np.asarray(Ps), dtype=torch.float32, device=dev)

        # held-out eval split: a pool from a seed stream the training pool
        # never draws from
        eval_pool = (build_pool(8 * tc.batch_size, tc.seed + 500_000)
                     if tc.eval_every > 0 else None)
        refresh = tc.pool_refresh_steps
        next_refresh = ((start_step // refresh + 1) * refresh
                        if refresh > 0 and pool is not None else None)
        next_eval = start_step if eval_pool is not None else None
        gen = _stream(dev, tc.seed + 1, start_step)
        done = start_step
        while done < n_steps:
            K = min(tc.scan_chunk, n_steps - done)
            if sampler is not None:
                losses = train_steps_scan(state, images, Ps, sampler, gen,
                                          K=K, batch=tc.batch_size,
                                          **step_kw)
            else:
                losses = train_steps_scan_pool(state, images, Ps, pool, gen,
                                               K=K, batch=tc.batch_size,
                                               **step_kw)
            # the host rebuilds the pool while the device runs the chunk:
            # nothing above waited for it, the read below does
            if next_refresh is not None and done + K >= next_refresh:
                pool = build_pool(tc.pool_size, tc.seed + 1000 + done + K)
                next_refresh += refresh
            losses = losses.cpu().numpy()
            for i in range(K):
                step = done + i
                if step % log_every == 0 or step == n_steps - 1:
                    log.steps.append(step)
                    log.losses.append(float(losses[i]))
            done += K
            if next_eval is not None and (done >= next_eval
                                          or done == n_steps):
                log.eval_steps.append(done)
                log.eval_losses.append(float(eval_loss_pool(
                    state, images, Ps, eval_pool, batch=tc.batch_size,
                    D=step_kw["D"], s=step_kw["s"],
                    balanced=tc.class_balance,
                    center_colors=step_kw["center_colors"])))
                next_eval = done + tc.eval_every
            if checkpoint_dir and (done % tc.checkpoint_every < K
                                   or done == n_steps):
                save_checkpoint(checkpoint_dir, state, done)
        return state, log

    # host loop (scan_chunk == 0, or scenes of mixed image sizes)
    images_d = [gather_copy(sc.images, cfg, dev) for sc in scenes]
    Ps_d = [torch.as_tensor(np.asarray(sc.Ps), dtype=torch.float32,
                            device=dev) for sc in scenes]
    gen = _stream(dev, tc.seed + 2, start_step)
    for step in range(start_step, n_steps):
        si = step % len(scenes)
        origins, pair_idx, labels = sample_training_batch(
            scenes[si], cfg, rng, device=dev)
        loss = train_step(
            state, images_d[si], Ps_d[si], torch.as_tensor(origins,
                                                           device=dev),
            torch.as_tensor(pair_idx, device=dev),
            torch.as_tensor(labels, device=dev), gen, **step_kw)
        if step % log_every == 0 or step == n_steps - 1:
            log.steps.append(step)
            log.losses.append(float(loss))
        if checkpoint_dir and ((step + 1) % tc.checkpoint_every == 0
                               or step == n_steps - 1):
            save_checkpoint(checkpoint_dir, state, step + 1)
    return state, log


# ------------------------------------------------------------- checkpoints


def save_checkpoint(ckpt_dir: str, state: TrainState, step: int) -> str:
    """``ckpt_dir/step_<step>/``: ``model.npz``, the model's state dict
    in ``models/convert.py``'s ``save_npz`` format (what ``cli reconstruct
    --checkpoint`` and ``load_surfacenet`` read), and ``optim.npz``, the
    momentum buffers by parameter name and the update count.  No pickle.
    Returns the directory."""
    path = os.path.join(ckpt_dir, f"step_{step}")
    os.makedirs(path, exist_ok=True)
    save_npz(state.model.state_dict(), os.path.join(path, "model.npz"))
    names = {p: n for n, p in state.model.named_parameters()}
    bufs = {
        "momentum." + names[p]: st["momentum_buffer"].detach().cpu().numpy()
        for p, st in state.optimizer.state.items()
        if st.get("momentum_buffer") is not None
    }
    np.savez(os.path.join(path, "optim.npz"), step=np.int64(state.step),
             **bufs)
    return path


def load_pretrained(path: str, cfg: Config) -> SurfaceNet:
    """An inference model (float32, eval mode, CPU) from a checkpoint
    directory (``step_N/``) or its ``model.npz``."""
    if os.path.isdir(path):
        path = os.path.join(path, "model.npz")
    return load_surfacenet(path, cfg.model)


def restore_checkpoint(ckpt_dir: str, cfg: Config, step: Optional[int] = None,
                       device="cuda") -> Tuple[TrainState, int]:
    """The latest (or the given) ``step_N`` of ``ckpt_dir`` as a
    ``TrainState`` on ``device``: weights, BatchNorm statistics, momentum
    buffers and update count, so the schedule continues."""
    if step is None:
        step = max(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                   if d.startswith("step_"))
    path = os.path.join(ckpt_dir, f"step_{step}")
    state = state_from_weights(cfg, os.path.join(path, "model.npz"), device)
    params = dict(state.model.named_parameters())
    with np.load(os.path.join(path, "optim.npz")) as z:
        state.step = int(z["step"])
        for key in z.files:
            if key.startswith("momentum."):
                p = params[key[len("momentum."):]]
                buf = torch.empty_like(p)
                buf.copy_(torch.from_numpy(z[key]))
                state.optimizer.state[p]["momentum_buffer"] = buf
    return state, step
