"""Batched scene sweep: calibrated images -> sparse surface store.

Port of the single-device branch of ``surfacenet_tpu/pipeline/sweep.py``
that the production presets take:

  1. Host planning: optional calibration refinement, cube enumeration,
     frustum prefilter, pair selection (geometric, or a caller's selector
     such as the learned ``ops/view_pairs.py::select_pairs_learned_local``),
     deduplicated view slots, core bounds, padding to fixed-size batches.
  2. Per batch on the device (``cube_batch_step``): the warp gather once
     per (cube, distinct view) (CUDA kernel; float32, bfloat16 or int8
     images), colour centring and pair assembly, the SurfaceNet forward,
     mean or consensus fusion, the ray-pooling vote (the affine vote
     kernel, its one-hot matmul form, or the exact scatter-max raster),
     tau/gamma thresholds, core claiming, best-pair colour and compact
     top-k records.
  3. Host harvest, pipelined three batches deep: unpack records, re-fetch
     truncated cubes dense, add to the ``SparseCubeStore`` (and its resume
     ledger), count into ``Metrics``.

``run_sweep(ledger_path=)`` resumes a killed sweep: cubes the ledger holds
are not swept again, and the remaining cubes claim exactly what they
would have claimed in an uninterrupted run.  ``fusion.min_component`` is
not applied here: the export applies it (``SparseCubeStore.merge``).
``run_sweep`` sweeps on one device whatever ``cfg.mesh`` says, as the
reference's does; the sharded sweep is
``parallel/sweep_sharded.py::run_sweep_sharded``.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from surfacenet_tpu_torch.config import Config
from surfacenet_tpu_torch.device import resolve_device
from surfacenet_tpu_torch.geometry.camera import cube_visible
from surfacenet_tpu_torch.ops.cuda.affine_vote import ray_vote_affine
from surfacenet_tpu_torch.ops.cuda.warp_gather import warp_gather
from surfacenet_tpu_torch.ops.cvc import center_cvc, quantize_int8
from surfacenet_tpu_torch.ops.fusion import (
    adaptive_threshold, fuse_pairs, fuse_pairs_consensus,
)
from surfacenet_tpu_torch.ops.ray_pooling import (
    ray_max_mask_affine_matmul, ray_pool,
)
from surfacenet_tpu_torch.ops.view_pairs import (
    dedup_view_slots, select_pairs_geometric,
)
from surfacenet_tpu_torch.pipeline.sparse import CubeResult, SparseCubeStore
from surfacenet_tpu_torch.utils.observability import trace

# A predictor maps a CVC-pair batch (B, D, D, D, 6) plus the items' cube
# origins (B, 3) -> per-voxel probabilities (B, D, D, D) float32.
Predictor = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

GATHER_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                 "int8": torch.int8}


def _local_variance(v: torch.Tensor, window: int = 3) -> torch.Tensor:
    """Mean-over-channels local variance of a (B, D, D, D, C) volume
    (SAME window, averaged over the in-bounds taps)."""
    x = v.permute(0, 4, 1, 2, 3)

    def avg(y):
        return F.avg_pool3d(y, window, stride=1, padding=window // 2,
                            count_include_pad=False)

    m = avg(x)
    m2 = avg(x * x)
    return torch.clamp(m2 - m * m, min=0.0).mean(dim=1)


def photoconsistency_predictor(x: torch.Tensor, origins=None) -> torch.Tensor:
    """Model-free predictor: photo-consistency of the two CVCs, gated by
    local texture (textureless regions carry no surface evidence)."""
    x = x.float()
    c = x.shape[-1] // 2
    a, b = x[..., :c], x[..., c:]
    consistency = torch.exp(-torch.mean((a - b) ** 2, dim=-1) * 60.0)
    tex = torch.minimum(_local_variance(a), _local_variance(b))
    return consistency * (1.0 - torch.exp(-tex * 300.0))


def enumerate_cubes(bbox_min, bbox_max, cfg: Config):
    """Tile the bbox into overlapping cubes: (grid (N, 3) int, origins (N, 3) mm)."""
    s = cfg.voxel.voxel_size_mm
    D = cfg.voxel.cube_size
    stride_mm = cfg.voxel.stride * s
    bbox_min = np.asarray(bbox_min, np.float64)
    bbox_max = np.asarray(bbox_max, np.float64)
    n = np.maximum(
        np.ceil((bbox_max - bbox_min - D * s) / stride_mm).astype(int) + 1, 1
    )
    gi, gj, gk = np.meshgrid(
        np.arange(n[0]), np.arange(n[1]), np.arange(n[2]), indexing="ij"
    )
    grid = np.stack([gi, gj, gk], axis=-1).reshape(-1, 3)
    return grid, bbox_min + grid * stride_mm


def prefilter_cubes(Ps, origins, image_hw, cfg: Config, device="cuda"):
    """Keep cubes visible in >= min_views_visible views: (N,) bool numpy."""
    if not cfg.sweep.prefilter:
        return np.ones(len(origins), bool)
    dev = resolve_device(device)
    vis = cube_visible(
        torch.as_tensor(np.asarray(Ps), dtype=torch.float32, device=dev),
        torch.as_tensor(np.asarray(origins), dtype=torch.float32, device=dev),
        cfg.voxel.cube_extent_mm,
        image_hw,
    )
    return vis.sum(dim=-1).cpu().numpy() >= cfg.sweep.min_views_visible


def resolve_fusion_mode(cfg: Config):
    """``cube_batch_step``'s ``fusion_mode``: "mean", or ("consensus",
    beta, deadband)."""
    if cfg.fusion.fusion_mode == "consensus":
        return ("consensus", float(cfg.fusion.consensus_beta),
                float(cfg.fusion.consensus_deadband))
    return cfg.fusion.fusion_mode


def resolve_pool_window(cfg: Config) -> int:
    """Effective ray-max window in voxels; -1 = auto, min(2, overlap // 2)."""
    w = cfg.fusion.pool_window_vox
    if w < 0:
        w = min(2, cfg.voxel.overlap // 2)
    return w


def core_bounds_for(grid, lattice_max, D: int, overlap: int, present=None):
    """Per-cube claimed-voxel bounds (N, 3, 2) int32 for core claiming.

    Cores trim overlap//2 voxels per face so they tile the scene; a cube
    claims up to its own face wherever its lattice neighbour is absent
    (beyond the lattice, or dropped by the prefilter when ``present``
    lists the surviving grid coords).
    """
    m_lo = overlap // 2
    m_hi = overlap - m_lo
    grid = np.asarray(grid)
    if present is None:
        lo = np.where(grid == 0, 0, m_lo)
        hi = np.where(grid == np.asarray(lattice_max), D, D - m_hi)
    else:
        pres = {tuple(int(v) for v in g) for g in np.asarray(present)}
        lo = np.full(grid.shape, m_lo, int)
        hi = np.full(grid.shape, D - m_hi, int)
        for a in range(3):
            e = np.zeros(3, int)
            e[a] = 1
            for i, g in enumerate(grid):
                if tuple(g - e) not in pres:
                    lo[i, a] = 0
                if tuple(g + e) not in pres:
                    hi[i, a] = D
    return np.stack([lo, hi], axis=-1).astype(np.int32)


# truncated cubes are re-fetched dense in mini-batches of this many rows
_REFETCH_PAD = 4


def resolve_compact_k(compact_k: int, D: int) -> int:
    """Records per cube; <= 0 means auto, max(4096, 4 * D^2)."""
    k = compact_k if compact_k > 0 else max(4096, 4 * D * D)
    return min(k, D * D * D)


def unique_views(pair_idx: torch.Tensor, K: int) -> torch.Tensor:
    """Per cube, the K smallest distinct views of its pairs (Nc, Np, 2),
    ascending, -1 padded: the reference's ``jnp.unique(pv, size=K,
    fill_value=-1)`` row by row."""
    pv = pair_idx.reshape(pair_idx.shape[0], -1).long().sort(dim=1).values
    first = torch.ones_like(pv, dtype=torch.bool)
    first[:, 1:] = pv[:, 1:] != pv[:, :-1]
    big = torch.iinfo(torch.int64).max
    uniq = torch.where(first, pv, big).sort(dim=1).values[:, :K]
    uniq = torch.where(uniq == big, -1, uniq)
    return F.pad(uniq, (0, K - uniq.shape[1]), value=-1)


def pool_views_for(uniq_views: torch.Tensor, n_pool_views: int, n_pairs: int):
    """First K = min(n_pool_views, 2 * n_pairs) slots of the -1-padded
    ascending unique-view table: (pool_views (Nc, K) >= 0, view_mask)."""
    K = min(n_pool_views, n_pairs * 2)
    Ku = uniq_views.shape[1]
    raw = uniq_views[:, :K] if Ku >= K else F.pad(
        uniq_views, (0, K - Ku), value=-1
    )
    return raw.clamp(min=0), raw >= 0


def cube_batch_step(
    images: torch.Tensor,  # (V, H, W, 3 or 4) gather dtype (``gather_images``)
    Ps: torch.Tensor,  # (V, 3, 4) float32
    origins: torch.Tensor,  # (Nc, 3) float32
    pair_w: torch.Tensor,  # (Nc, Npairs) float32
    core_bounds: Optional[torch.Tensor],  # (Nc, 3, 2) int32 claim region
    uniq_views: Optional[torch.Tensor],  # (Nc, Ku) int32, -1 padded
    slot_idx: Optional[torch.Tensor],  # (Nc, Npairs, 2) int32 into Ku
    *,
    D: int,
    s: float,
    n_pairs: int,
    tau: float,
    gamma: float,
    adaptive: bool,
    center_colors: bool,
    predict: Predictor,
    n_pool_views: int = 6,
    adaptive_taus: tuple = (0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9),
    adaptive_target_density: float = 0.02,
    compact_output: bool = False,
    compact_k: int = 0,
    pool_window: int = 0,
    ray_pool_mode: str = "exact",
    fusion_mode="mean",
    pair_idx: Optional[torch.Tensor] = None,  # (Nc, Npairs, 2) int32
):
    """One device step over a fixed-size batch of cubes.

    With ``uniq_views``/``slot_idx`` (the sweeps' deduplicated gather) the
    gather runs once per (cube, distinct view) and the pairs are read
    through the slots; with ``uniq_views=None`` it runs once per (cube,
    pair, half) on ``pair_idx`` (the reference's other branch; the
    reference takes ``pair_idx`` positionally, the port as a keyword, and
    the deduplicated branch needs none).  Raw colours feed both
    the colour output and, centred, the model input.  Pooling views are the
    cube's first K = min(n_pool_views, 2 n_pairs) distinct views; padded
    slots do not vote and do not count in the gamma denominator.
    ``ray_pool_mode`` "affine" or "affine_pallas" votes with the affine
    vote kernel, "affine_matmul" sums the masks of the one-hot matmul form
    (``ops/ray_pooling.py::ray_max_mask_affine_matmul``) over the active
    views, "exact" runs the exact scatter-max raster
    (``ops/ray_pooling.py::ray_pool``).
    ``fusion_mode`` is "mean" (``fuse_pairs``) or ("consensus", beta,
    deadband) (``fuse_pairs_consensus``; "consensus" alone takes its
    defaults).  Returns
    (occupancy (Nc,D,D,D) bool, fused
    (Nc,D,D,D) f32, color (Nc,D,D,D,3) f32), or with ``compact_output``
    (records (Nc, K, 7) uint8, counts (Nc,) int32).
    """
    Nc = origins.shape[0]
    NB = Nc * n_pairs
    x_dt = (torch.bfloat16
            if getattr(predict, "in_dtype", "float32") == "bfloat16"
            else torch.float32)
    def centred(colors, valids):
        if center_colors:
            return center_cvc(colors, valids).to(x_dt)
        return torch.where(valids[..., None], colors, 0.0).to(x_dt)

    if uniq_views is not None:
        Ku = uniq_views.shape[1]
        # padded slots (-1) gather the cube's first view: harmless
        # duplicates; views are read as [cube, slot]
        uv = torch.where(uniq_views >= 0, uniq_views,
                         uniq_views[:, :1].clamp(min=0))
        colors_v, valids_v = warp_gather(
            images, Ps, uv.reshape(-1).contiguous(),
            origins.repeat_interleave(Ku, dim=0), D=D, s=s,
        )
        xs_v = centred(colors_v, valids_v)
        sa, sb = slot_idx[..., 0].long(), slot_idx[..., 1].long()
    else:
        if pair_idx is None:
            raise ValueError("cube_batch_step needs uniq_views/slot_idx or "
                             "pair_idx")
        # one item per (cube, pair, half), the halves centred apart;
        # views are read as [cube, pair] (a) and [cube, Np + pair] (b)
        Ku = 2 * n_pairs
        halves = pair_idx.reshape(Nc, n_pairs, 2).permute(0, 2, 1)
        colors_v, valids_v = warp_gather(
            images, Ps, halves.reshape(-1).contiguous().int(),
            origins.repeat_interleave(Ku, dim=0), D=D, s=s,
        )
        xs_v = centred(colors_v, valids_v)
        sa = torch.arange(n_pairs, device=origins.device).expand(Nc, -1)
        sb = sa + n_pairs
    rows = torch.arange(Nc, device=origins.device)[:, None]
    colors_u = colors_v.reshape(Nc, Ku, D, D, D, 3)
    valids_u = valids_v.reshape(Nc, Ku, D, D, D)
    xs_u = xs_v.reshape(Nc, Ku, D, D, D, 3)
    del colors_v, valids_v, xs_v

    x = torch.cat([xs_u[rows, sa], xs_u[rows, sb]], dim=-1)
    x = x.reshape(NB, D, D, D, 6)
    valid = valids_u[rows, sa] & valids_u[rows, sb]  # (Nc, Np, D, D, D)
    del xs_u

    probs = predict(x, origins.repeat_interleave(n_pairs, dim=0))
    probs = probs.float().reshape(Nc, n_pairs, D, D, D)
    fm = (fusion_mode,) if isinstance(fusion_mode, str) else fusion_mode
    if fm[0] == "consensus":
        kw = {}
        if len(fm) > 1:
            kw = dict(beta=float(fm[1]), deadband=float(fm[2]))
        fused = fuse_pairs_consensus(probs, pair_w, valid, **kw)
    else:
        fused = fuse_pairs(probs, pair_w, valid)
    del x, probs, valid

    if adaptive:
        taus = adaptive_threshold(
            fused, torch.tensor(adaptive_taus, device=fused.device),
            target_density=adaptive_target_density,
        )
    else:
        taus = torch.full((Nc,), tau, dtype=torch.float32,
                          device=fused.device)

    K = min(n_pool_views, n_pairs * 2)
    pool_views, view_mask = pool_views_for(
        uniq_views if uniq_views is not None else unique_views(pair_idx, K),
        n_pool_views, n_pairs)
    if ray_pool_mode == "exact":
        occ, _ = ray_pool(fused, origins, s, Ps[pool_views.long()], taus,
                          gamma, view_mask=view_mask,
                          window=pool_window)
    elif ray_pool_mode == "affine_matmul":
        masks = ray_max_mask_affine_matmul(
            fused.repeat_interleave(K, dim=0),
            origins.repeat_interleave(K, dim=0), s,
            Ps[pool_views.reshape(-1).long()], window=pool_window,
        ).reshape(Nc, K, D, D, D)
        votes = (masks & view_mask[:, :, None, None, None]).sum(
            dim=1, dtype=torch.int32)
        n_uniq = view_mask.sum(dim=1)
        need = torch.clamp(
            torch.ceil(gamma * n_uniq.float()).to(torch.int32), min=1
        )[:, None, None, None]
        occ = (votes >= need) & (fused > taus[:, None, None, None])
    else:
        votes = ray_vote_affine(
            fused, origins, s, Ps[pool_views.long()], view_mask,
            window=pool_window,
        )
        n_uniq = view_mask.sum(dim=1)
        need = torch.clamp(
            torch.ceil(gamma * n_uniq.float()).to(torch.int32), min=1
        )[:, None, None, None]
        occ = (votes >= need) & (fused > taus[:, None, None, None])

    if core_bounds is not None:
        ii = torch.arange(D, device=occ.device)
        b = core_bounds.long()
        m = [(ii[None] >= b[:, a, 0:1]) & (ii[None] < b[:, a, 1:2])
             for a in range(3)]  # (Nc, D) per axis
        occ = occ & (m[0][:, :, None, None] & m[1][:, None, :, None]
                     & m[2][:, None, None, :])

    # colour: validity-weighted average of the strongest pair's raw CVCs
    best = torch.argmax(pair_w, dim=-1)  # (Nc,)
    r1 = torch.arange(Nc, device=origins.device)
    sa_b = sa[r1, best]
    sb_b = sb[r1, best]
    w1 = valids_u[r1, sa_b].float()
    w2 = valids_u[r1, sb_b].float()
    color = (
        colors_u[r1, sa_b] * w1[..., None] + colors_u[r1, sb_b] * w2[..., None]
    ) / torch.clamp(w1 + w2, min=1.0)[..., None]

    if compact_output:
        K = resolve_compact_k(compact_k, D)
        idx_bits = (D * D * D - 1).bit_length()
        if idx_bits + 9 > 31:
            raise NotImplementedError(
                f"compact_output packed key needs idx_bits+9 <= 31; D={D}"
            )
        return compact_records(occ, fused, color, D=D, K=K, idx_bits=idx_bits)
    return occ, fused, color


def compact_records(occ, fused, color, *, D: int, K: int, idx_bits: int):
    """Per-cube sparse records (rec (Nc, K, 7) uint8, counts (Nc,) int32).

    The int32 key ``occ << (idx_bits+8) | prob_u8 << idx_bits | voxel``
    ranks occupied voxels first, by quantized probability; its top K carry
    occupancy, probability and voxel index.  A record is
    [idx_hi, idx_mid, idx_lo, prob, r, g, b]; prob 0 marks padding.
    """
    Nc = occ.shape[0]
    d3 = D * D * D
    flat_occ = occ.reshape(Nc, d3)
    counts = flat_occ.sum(dim=-1).to(torch.int32)
    prob_u8 = torch.round(
        torch.clamp(fused.reshape(Nc, d3), 0.0, 1.0) * 255.0
    ).to(torch.int32)
    iota = torch.arange(d3, dtype=torch.int32, device=occ.device)[None]
    key = ((flat_occ.to(torch.int32) << (idx_bits + 8))
           | (prob_u8 << idx_bits) | iota)
    vals = torch.topk(key, K, dim=-1, sorted=True).values
    sel_occ = (vals >> (idx_bits + 8)) > 0
    sel_prob = (vals >> idx_bits) & 0xFF
    top_idx = vals & ((1 << idx_bits) - 1)
    cu8 = torch.round(torch.clamp(color, 0.0, 1.0) * 255.0).to(torch.int32)
    packed = ((cu8[..., 0] << 16) | (cu8[..., 1] << 8) | cu8[..., 2])
    sel_col = torch.gather(packed.reshape(Nc, d3), 1, top_idx.long())
    rec = torch.stack(
        [
            top_idx >> 16, (top_idx >> 8) & 0xFF, top_idx & 0xFF,
            torch.where(sel_occ, sel_prob, 0),
            (sel_col >> 16) & 0xFF, (sel_col >> 8) & 0xFF, sel_col & 0xFF,
        ],
        dim=-1,
    ).to(torch.uint8)
    return rec, counts


def unpack_compact(rec: np.ndarray, counts: np.ndarray, D: int):
    """Host unpack of compact records -> dense (occ, fused, color) numpy."""
    Nc = rec.shape[0]
    d3 = D * D * D
    occ = np.zeros((Nc, d3), bool)
    fused = np.zeros((Nc, d3), np.float32)
    color = np.zeros((Nc, d3, 3), np.float32)
    idx = ((rec[..., 0].astype(np.int64) << 16)
           | (rec[..., 1].astype(np.int64) << 8) | rec[..., 2].astype(np.int64))
    prob = rec[..., 3].astype(np.float32) / 255.0
    r, c = np.nonzero(rec[..., 3] > 0)
    li = idx[r, c]
    occ[r, li] = True
    fused[r, li] = prob[r, c]
    color[r, li] = rec[r, c, 4:7].astype(np.float32) / 255.0
    return (occ.reshape(Nc, D, D, D), fused.reshape(Nc, D, D, D),
            color.reshape(Nc, D, D, D, 3))


@dataclasses.dataclass
class SweepPlan:
    """Host-side schedule of a sweep: survivors of the prefilter, their
    pairs, dedup tables and claims, padded to whole batches."""

    grid: np.ndarray  # (n, 3) lattice coords of the cubes to sweep
    origins: np.ndarray  # (n_pad, 3) float64
    pair_w: np.ndarray  # (n_pad, Np) float32
    uniq_views: np.ndarray  # (n_pad, Ku) int32
    slot_idx: np.ndarray  # (n_pad, Np, 2) int32
    core_bounds: Optional[np.ndarray]  # (n_pad, 3, 2) int32
    n: int  # cubes to sweep (rows past n are padding)
    n_total: int  # cubes enumerated before the prefilter
    n_prefilter: int  # survivors of the prefilter, done cubes included
    pool_window: int

    def batch(self, rows, device):
        """Device tensors of ``cube_batch_step``'s positional arguments.

        On the card the uploads go from pinned memory without blocking: a
        plain host-to-device copy waits for the stream, which would stall
        the dispatch pipeline on every batch.
        """
        device = torch.device(device)

        def t(a, dt):
            x = torch.from_numpy(np.ascontiguousarray(a, dtype=dt))
            if device.type == "cuda":
                return x.pin_memory().to(device, non_blocking=True)
            return x.to(device)

        return (
            t(self.origins[rows], np.float32),
            t(self.pair_w[rows], np.float32),
            None if self.core_bounds is None
            else t(self.core_bounds[rows], np.int32),
            t(self.uniq_views[rows], np.int32),
            t(self.slot_idx[rows], np.int32),
        )


def prefiltered_cubes(Ps, bbox_min, bbox_max, image_hw, cfg: Config,
                      device):
    """The bbox's cubes that survive the prefilter: (grid (n, 3), origins
    (n, 3) mm, cubes enumerated before the prefilter, lattice_max (3,))."""
    grid, origins = enumerate_cubes(bbox_min, bbox_max, cfg)
    lattice_max = grid.max(axis=0) if len(grid) else np.zeros(3, int)
    keep = prefilter_cubes(Ps, origins, image_hw, cfg, device)
    return grid[keep], origins[keep], len(origins), lattice_max


def not_done(grid, done: Optional[set]) -> np.ndarray:
    """(n,) bool: the rows of ``grid`` whose index is not in ``done``."""
    return np.array([tuple(int(v) for v in g) not in (done or ())
                     for g in grid], bool)


def plan_sweep(Ps, bbox_min, bbox_max, image_hw, cfg: Config,
               device, pair_selector: Optional[Callable] = None,
               done: Optional[set] = None) -> SweepPlan:
    """Enumerate, prefilter, drop ``done`` cubes, then ``plan_cubes``.

    ``done`` holds the grid indices of cubes already swept (a resumed
    ledger): they are dropped after the prefilter, but the core claims
    still see them as present, so their neighbours claim what they would
    have claimed in an uninterrupted run (a done cube's claims are in the
    ledger already).
    """
    grid, origins, n_total, lattice_max = prefiltered_cubes(
        Ps, bbox_min, bbox_max, image_hw, cfg, device)
    todo = not_done(grid, done)
    return plan_cubes(grid[todo], origins[todo], grid, lattice_max, n_total,
                      Ps, image_hw, cfg, device, pair_selector,
                      pad_to=cfg.sweep.cube_batch)


def plan_cubes(grid, origins, present, lattice_max, n_total: int, Ps,
               image_hw, cfg: Config, device,
               pair_selector: Optional[Callable] = None,
               pad_to: int = 1) -> SweepPlan:
    """Select pairs, dedup views, claim cores and pad to a multiple of
    ``pad_to`` rows for the cubes ``grid``/``origins``, among the
    prefilter's survivors ``present``.

    ``pair_selector`` (Ps, origins) -> (pair_idx (N, Nv, 2), pair_w (N, Nv))
    picks each cube's pairs; by default the geometric selector.
    """
    D = cfg.voxel.cube_size
    n_prefilter = len(present)
    pool_window = resolve_pool_window(cfg)
    n = len(origins)
    if n == 0:
        empty = np.zeros((0, cfg.fusion.n_view_pairs, 2), np.int32)
        return SweepPlan(grid, origins, np.zeros((0, 0), np.float32),
                         np.zeros((0, 1), np.int32), empty, None, 0, n_total,
                         n_prefilter, pool_window)
    if pair_selector is None:
        pair_selector = functools.partial(
            select_pairs_geometric, n_pairs=cfg.fusion.n_view_pairs,
            image_hw=image_hw, extent_mm=cfg.voxel.cube_extent_mm,
            dist_sigma_frac=cfg.fusion.pair_dist_sigma_frac, device=device,
        )
    pair_idx, pair_w = pair_selector(Ps, origins)
    pair_idx = np.asarray(pair_idx, np.int32)
    pair_w = np.asarray(pair_w, np.float32)
    uniq_views, slot_idx = dedup_view_slots(pair_idx)
    core_bounds = (
        core_bounds_for(grid, lattice_max, D, cfg.voxel.overlap,
                        present=present)
        if pool_window > 0 else None
    )
    n_pad = (-n) % pad_to

    def pad(a):
        return np.concatenate([a, a[:1].repeat(n_pad, 0)]) if n_pad else a

    return SweepPlan(
        grid=grid, origins=pad(origins), pair_w=pad(pair_w), uniq_views=pad(uniq_views),
        slot_idx=pad(slot_idx),
        core_bounds=None if core_bounds is None else pad(core_bounds),
        n=n, n_total=n_total, n_prefilter=n_prefilter,
        pool_window=pool_window,
    )


@dataclasses.dataclass
class SweepStats:
    n_cubes_total: int = 0
    n_cubes_after_prefilter: int = 0
    n_cubes_nonempty: int = 0
    n_batches: int = 0
    n_refetched: int = 0  # cubes re-fetched dense after compact truncation
    refine_s: float = 0.0  # wall seconds of the calibration prepass
    plan_s: float = 0.0  # enumeration, prefilter, pairs, dedup, claims
    sweep_s: float = 0.0  # batches dispatched and harvested into the store
    refine_info: Optional[dict] = dataclasses.field(default=None,
                                                     repr=False)
    # the matrices the sweep used (refined when the prepass ran)
    Ps: Optional[np.ndarray] = dataclasses.field(default=None, repr=False)


def sweep_gather_dtype(cfg: Config) -> torch.dtype:
    """Image dtype the gather samples: the config's gather dtype on the
    kernel path (``use_pallas_gather``), else float32 (the oracle's)."""
    if not cfg.sweep.use_pallas_gather:
        return torch.float32
    if cfg.sweep.gather_dtype not in GATHER_DTYPES:
        raise ValueError(
            f"gather_dtype={cfg.sweep.gather_dtype!r}: use one of "
            f"{sorted(GATHER_DTYPES)}"
        )
    return GATHER_DTYPES[cfg.sweep.gather_dtype]


def gather_images(images: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The sweep's one image copy for the gather: ``images`` (V, H, W, 3)
    (float, [0, 1]) cast to ``dtype``, or for int8 quantized to
    ``round(x * 127)``.  On a CUDA device as RGBx (V, H, W, 4) with a zero
    fourth channel, so that the gather kernel reads a pixel with one
    aligned load; on the CPU, where the plain version reads three channels,
    as (V, H, W, 3)."""
    if dtype == torch.int8:
        images = quantize_int8(images)
    images = images.to(dtype)
    if images.is_cuda:
        images = F.pad(images, (0, 1))
    return images.contiguous()


def _check_supported(cfg: Config) -> None:
    if cfg.fusion.fusion_mode not in ("mean", "consensus"):
        raise NotImplementedError(
            f"fusion_mode={cfg.fusion.fusion_mode!r}: the port runs 'mean' "
            "and 'consensus'"
        )
    if cfg.fusion.ray_pool_mode not in ("exact", "affine", "affine_pallas",
                                        "affine_matmul"):
        raise NotImplementedError(
            f"ray_pool_mode={cfg.fusion.ray_pool_mode!r}: the port runs "
            "'exact', the affine vote for 'affine' and 'affine_pallas', and "
            "'affine_matmul'"
        )


def sweep_step(cfg: Config, images_g, Ps_d, predictor, pool_window: int):
    """``cube_batch_step`` with the sweep's images, matrices and config
    bound: called with ``SweepPlan.batch``'s tensors."""
    return functools.partial(
        cube_batch_step, images_g, Ps_d,
        D=cfg.voxel.cube_size, s=cfg.voxel.voxel_size_mm,
        n_pairs=cfg.fusion.n_view_pairs, tau=cfg.fusion.tau,
        gamma=cfg.fusion.gamma, adaptive=cfg.fusion.adaptive_threshold,
        center_colors=cfg.voxel.center_colors, predict=predictor,
        n_pool_views=cfg.fusion.n_pool_views,
        adaptive_taus=tuple(cfg.fusion.adaptive_taus),
        adaptive_target_density=cfg.fusion.adaptive_target_density,
        compact_k=cfg.sweep.compact_k, pool_window=pool_window,
        ray_pool_mode=cfg.fusion.ray_pool_mode,
        fusion_mode=resolve_fusion_mode(cfg),
    )


def harvest_batch(step, plan: "SweepPlan", rows: np.ndarray, nb: int, out,
                  device, D: int):
    """Host results of one compact batch dispatched on ``plan`` rows
    ``rows``: (occ, fused, color) numpy of its first ``nb`` (real) rows,
    the cubes whose records fell short of their occupied count re-run
    dense in mini-batches; plus (cubes re-run, dense dispatches)."""
    rec = out[0].cpu().numpy()
    counts = out[1].cpu().numpy()[:nb]
    occ, fused, color = unpack_compact(rec, counts, D)
    # every occupied voxel must be among the records
    got = (rec[:nb, :, 3] > 0).sum(axis=1)
    short = np.flatnonzero(got < counts)
    n_dense = 0
    if len(short):
        sel = rows[short]
        PAD = min(len(rows), _REFETCH_PAD)
        extra = (-len(sel)) % PAD
        rr = np.concatenate([sel, sel[:1].repeat(extra)]) if extra else sel
        outs = []
        for c0 in range(0, len(rr), PAD):
            dense = step(*plan.batch(rr[c0: c0 + PAD], device),
                         compact_output=False)
            outs.append([o.cpu().numpy() for o in dense])
            n_dense += 1
        occ[short], fused[short], color[short] = [
            np.concatenate([o[i] for o in outs])[: len(sel)]
            for i in range(3)]
    return occ[:nb], fused[:nb], color[:nb], len(short), n_dense


def _flush_metrics(metrics, stats: "SweepStats", wall: float, n: int):
    metrics.gauge("sweep_wall_s", wall)
    metrics.gauge("cubes_per_s", n / wall if wall > 0 else 0.0)
    metrics.flush(extra={
        "n_cubes_total": stats.n_cubes_total,
        "n_cubes_after_prefilter": stats.n_cubes_after_prefilter,
        "n_cubes_nonempty": stats.n_cubes_nonempty,
    })


def run_sweep(
    images: np.ndarray,
    Ps: np.ndarray,
    bbox_min: np.ndarray,
    bbox_max: np.ndarray,
    cfg: Config,
    predictor: Predictor,
    pair_selector: Optional[Callable] = None,
    ledger_path: Optional[str] = None,
    metrics=None,
    *,
    device="cuda",
) -> Tuple[SparseCubeStore, SweepStats]:
    """Full single-device scene sweep -> sparse store.

    Args:
      images: (V, H, W, 3) float in [0, 1]; Ps: (V, 3, 4).
      predictor: (B, D, D, D, 6) x (B, 3) -> (B, D, D, D) on ``device``.
      pair_selector: optional (Ps, origins) -> (pair_idx (N, Nv, 2),
        pair_w (N, Nv)), called once on the cubes to sweep with the
        refined matrices when the prepass ran; default the geometric
        top-Nv selector.
      ledger_path: JSON-lines resume ledger of the store; the cubes it
        already holds are not swept again.
      metrics: optional ``utils/observability.py::Metrics``: the
        reference's counters and gauges, flushed once at the end.
    """
    dev = resolve_device(device)
    _check_supported(cfg)
    gdt = sweep_gather_dtype(cfg)
    stats = SweepStats()
    D = cfg.voxel.cube_size
    s = cfg.voxel.voxel_size_mm
    hw = tuple(np.asarray(images).shape[1:3])
    images_t = torch.as_tensor(np.asarray(images), dtype=torch.float32,
                               device=dev)

    t0 = time.perf_counter()
    if cfg.sweep.refine_calib:
        from surfacenet_tpu_torch.geometry.refine import (
            refine_calibration_auto,
        )

        Ps, stats.refine_info = refine_calibration_auto(
            images_t, Ps, bbox_min, bbox_max,
            steps_per_level=cfg.sweep.refine_calib_steps,
            n_probes=cfg.sweep.refine_calib_probes, device=dev,
        )
        if metrics is not None:
            metrics.gauge("refine_calib_max_shift_px",
                          stats.refine_info["max_shift_px"])
            metrics.gauge("refine_calib_passes", stats.refine_info["passes"])
    stats.Ps = np.asarray(Ps)
    t1 = time.perf_counter()
    stats.refine_s = t1 - t0

    pool_window = resolve_pool_window(cfg)
    store = SparseCubeStore(
        scene_origin=np.asarray(bbox_min, np.float64), voxel_size_mm=s,
        cube_size=D, stride=cfg.voxel.stride, ledger_path=ledger_path,
        # core claiming gives each voxel one owner: no cross-cube vote
        occupancy_vote=0.0 if pool_window > 0 else 0.5,
    )
    plan = plan_sweep(Ps, bbox_min, bbox_max, hw, cfg, dev, pair_selector,
                      done=store.done_set())
    stats.n_cubes_total = plan.n_total
    stats.n_cubes_after_prefilter = plan.n_prefilter
    t2 = time.perf_counter()
    stats.plan_s = t2 - t1
    if plan.n == 0:
        if metrics is not None:  # still record the (zero-cube) run
            _flush_metrics(metrics, stats, 0.0, 0)
        return store, stats

    images_g = gather_images(images_t, gdt)
    Ps_d = torch.as_tensor(np.asarray(Ps), dtype=torch.float32, device=dev)
    B = cfg.sweep.cube_batch
    n = plan.n
    step = sweep_step(cfg, images_g, Ps_d, predictor, pool_window)

    def dispatch(b0):
        """Enqueue one batch; the device runs it while the host goes on."""
        return step(*plan.batch(slice(b0, b0 + B), dev), compact_output=True)

    def harvest(b0, out):
        nb = min(B, n - b0)  # padding rows (copies of row 0) excluded
        occ, fused, color, n_short, _ = harvest_batch(
            step, plan, np.arange(b0, b0 + B), nb, out, dev, D)
        if n_short:
            stats.n_refetched += n_short
            if metrics is not None:
                metrics.count("compact_truncation_refetches", n_short)
        stats.n_batches += 1
        for i in range(nb):
            if occ[i].any():
                stats.n_cubes_nonempty += 1
            store.add(CubeResult(tuple(plan.grid[b0 + i]), occ[i], fused[i],
                                 color[i]))
        if metrics is not None:
            metrics.count("cubes_processed", nb)
            metrics.count("voxels_occupied", float(occ[:nb].sum()))
            metrics.gauge("occupancy_rate", metrics.data["voxels_occupied"]
                          / (metrics.data["cubes_processed"] * D**3))

    DEPTH = 3  # batches in flight while the host harvests an older one
    pending = collections.deque()
    t_loop = time.perf_counter()
    # profiler hook: SURFACENET_TORCH_PROFILER_DIR=<dir> captures a trace
    # of the pipelined batch loop (a no-op otherwise)
    with trace("run_sweep"):
        for b0 in range(0, len(plan.origins), B):
            pending.append((b0, dispatch(b0)))
            if len(pending) > DEPTH:
                harvest(*pending.popleft())
        while pending:
            harvest(*pending.popleft())
    t_end = time.perf_counter()
    stats.sweep_s = t_end - t2
    if metrics is not None:
        _flush_metrics(metrics, stats, t_end - t_loop, n)
    return store, stats
