"""Throughput benchmark of the port: ``cli bench``.

    python -m surfacenet_tpu_torch.cli bench [--device cuda]

Port of the root ``bench.py``.  It times the per-batch device program of
the sweep, ``pipeline/sweep.py::cube_batch_step``: the deduplicated warp
gather (CUDA kernel, bf16 RGBx images), the SurfaceNet forward, mean
fusion, the affine vote at window 2 (CUDA kernel, ``tile`` route) and the
compact records, on 32^3 cubes of 0.8 mm with 5 view pairs, 8 views of a
synthetic sphere at 600x800 and 32 cubes a batch; then the same step at
the ``mxu_aligned`` and ``fast`` widths, the forward alone at the same
item count (and, aligned, at 480 items), the 64^3 apply point (24 cubes:
paper, ``fast`` and ``fast64`` widths), and training at 32^3 (paper
width, batch 16, chunks of 50 steps sampled on the device).  Prints one
JSON line, ``RECORD_KEYS``, and returns it as a dict.

Timing is the reference's: dispatches are pipelined, the host syncs once
a window on the sum of the calls' device scalars, and the best of three
windows counts (``time_pipelined``).  ``vs_baseline`` is cubes/s over
5.0, the reference's documented estimate of its ~2017 GPU throughput
(``bench.py``'s docstring), not a measured figure.  MFU is against the
card's bf16 tensor-core peak (``utils/observability.py``).

Weights are random, drawn from a ``torch.Generator`` seeded 0 as
``init_surfacenet`` draws them; their occupancy is not that of the
reference's random net (``jax.random.PRNGKey(0)``), so the compact
harvest's share of a step differs from the reference's too.

Left out: the reference's TPU relay probe, crop and chunk windows (TPU
workarounds), ``mxu_lane_ceiling_pct`` (``FlopModel.mxu_ceiling`` is not
ported), and the reference's ``except Exception`` around each variant: a
point that fails raises.  On the CPU (``--device cpu``) every kernel runs
its plain version, which at these sizes takes hours; the tests call
``run_bench`` with small ``BenchSizes``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import time
from typing import Callable, Dict

import numpy as np
import torch

from surfacenet_tpu_torch.config import (
    Config, FusionConfig, ModelConfig, TrainConfig, VoxelConfig,
)
from surfacenet_tpu_torch.data.synthetic import make_sphere_scene
from surfacenet_tpu_torch.device import resolve_device
from surfacenet_tpu_torch.models.surfacenet import (
    init_surfacenet, make_predictor,
)
from surfacenet_tpu_torch.ops.view_pairs import (
    dedup_view_slots, select_pairs_geometric,
)
from surfacenet_tpu_torch.pipeline.sweep import cube_batch_step, gather_images
from surfacenet_tpu_torch.train.train_surface import (
    create_train_state, make_device_sampler, train_steps_scan,
)
from surfacenet_tpu_torch.utils.observability import (
    FlopModel, detect_peak_tflops,
)

# cubes/s of the reference on a ~2017 GPU, bench.py's documented estimate
BASELINE_CUBES_PER_S = 5.0
POOL_WINDOW = 2

RECORD_KEYS = (
    "metric", "value", "unit", "vs_baseline", "e2e_includes",
    "conv_gflops_per_item", "model_fwd_items_per_s", "model_fwd_mfu_pct",
    "e2e_mfu_pct", "peak_tflops", "model_fwd_mfu_pct_aligned",
    "model_fwd_mfu_pct_aligned_b160", "aligned_fwd_batch",
    "cubes_per_s_aligned", "e2e_mfu_pct_aligned", "model_fwd_mfu_pct_fast",
    "cubes_per_s_fast", "e2e_mfu_pct_fast", "cubes_per_s_64",
    "model_fwd_mfu_pct_64", "e2e_mfu_pct_64", "cubes_per_s_64_fast",
    "cubes_per_s_64_fast64", "model_fwd_mfu_pct_64_fast64",
    "e2e_mfu_pct_64_fast64", "train_steps_per_s", "device",
)


def bench_models() -> Dict[str, ModelConfig]:
    """The widths bench.py measures, by the names its keys use."""
    return {"paper": ModelConfig(), "aligned": ModelConfig.mxu_aligned(),
            "fast": ModelConfig.fast(), "fast64": ModelConfig.fast64()}


@dataclasses.dataclass(frozen=True)
class BenchSizes:
    """bench.py's sizes; the tests pass smaller ones."""

    n_views: int = 8
    hw: tuple = (600, 800)
    D: int = 32
    n_cubes: int = 32  # cubes a step at D (seed 1)
    D64: int = 64
    n_cubes64: int = 24  # cubes a step at D64 (seed 2)
    n_iters: int = 10  # calls a timing window
    n_windows: int = 3
    aligned_batch: int = 480  # items of the aligned forward's best batch
    train_K: int = 50  # training steps a chunk
    train_batch: int = 16
    train_chunks: int = 3  # timed chunks after one warm-up chunk
    n_candidates: int = 2048  # the training sampler's surface points
    models: Dict[str, ModelConfig] = dataclasses.field(
        default_factory=bench_models)


def time_pipelined(fn: Callable[[], torch.Tensor], n_iters: int = 10,
                   n_windows: int = 3) -> float:
    """Best-window seconds of ``n_iters`` pipelined calls of ``fn``.

    ``fn()`` returns a device scalar.  One warm-up call, synced; then each
    window enqueues ``n_iters`` calls and syncs the host once, on the sum
    of their scalars, as the sweep's pipelined loop does.
    """
    fn().item()
    best = math.inf
    for _ in range(n_windows):
        t0 = time.perf_counter()
        torch.stack([fn() for _ in range(n_iters)]).sum().item()
        best = min(best, time.perf_counter() - t0)
    return best


def bench_config(D: int) -> Config:
    """bench.py's configuration at cube side ``D`` (0.8 mm voxels)."""
    return Config(
        voxel=VoxelConfig(voxel_size_mm=0.8, cube_size=D, overlap=8),
        fusion=FusionConfig(n_view_pairs=5, tau=0.7, gamma=0.8,
                            ray_pool_mode="affine_pallas", n_pool_views=6),
    )


def bench_scene(sizes: BenchSizes):
    """The synthetic sphere bench.py renders (radius 30 mm)."""
    return make_sphere_scene(n_views=sizes.n_views, hw=tuple(sizes.hw),
                             radius=30.0)


def cube_inputs(scene, cfg: Config, n_cubes: int, seed: int, D: int,
                device="cuda") -> Dict[str, np.ndarray]:
    """A batch of ``n_cubes`` cubes of side ``D`` centred on the sphere's
    surface: origins, geometric pairs and the deduplicated view table."""
    s = cfg.voxel.voxel_size_mm
    pts = scene.surface_points(n_cubes, seed=seed)
    origins = (pts - D * s / 2).astype(np.float32)
    pair_idx, pair_w = select_pairs_geometric(
        scene.Ps, origins, cfg.fusion.n_view_pairs, scene.images.shape[1:3],
        extent_mm=D * s, device=device)
    uniq_views, slot_idx = dedup_view_slots(pair_idx)
    return dict(origins=origins, pair_idx=np.asarray(pair_idx, np.int32),
                pair_w=np.asarray(pair_w, np.float32),
                uniq_views=uniq_views, slot_idx=slot_idx)


def make_step(images_g, Ps, inputs, cfg: Config, D: int, predict, device):
    """``cube_batch_step`` on ``inputs`` (uploaded once), pool window 2 and
    compact records: a call returns (records, counts) on the device."""
    t = {k: torch.as_tensor(v, device=device) for k, v in inputs.items()}
    args = (t["origins"], t["pair_w"], None, t["uniq_views"], t["slot_idx"])
    f = cfg.fusion

    def step():
        return cube_batch_step(
            images_g, Ps, *args, D=D, s=cfg.voxel.voxel_size_mm,
            n_pairs=f.n_view_pairs, tau=f.tau, gamma=f.gamma, adaptive=False,
            center_colors=True, predict=predict, n_pool_views=f.n_pool_views,
            ray_pool_mode=f.ray_pool_mode, pool_window=POOL_WINDOW,
            compact_output=True)

    return step


def random_predictor(mcfg: ModelConfig, device):
    """The sweep's predictor of a SurfaceNet with random weights (seed 0)."""
    model = init_surfacenet(mcfg, torch.Generator().manual_seed(0))
    return make_predictor(model, mcfg, device)


def forward_items_per_s(predict, mcfg: ModelConfig, n_items: int, D: int,
                        sizes: BenchSizes, device) -> float:
    """Items/s of the forward alone on zeros in the sweep's input dtype."""
    x = torch.zeros((n_items, D, D, D, mcfg.in_channels),
                    dtype=getattr(torch, predict.in_dtype), device=device)
    best = time_pipelined(lambda: predict(x, None).sum(), sizes.n_iters,
                          sizes.n_windows)
    return n_items * sizes.n_iters / best


def step_cubes_per_s(step, n_cubes: int, sizes: BenchSizes) -> float:
    """Cubes/s of the step; the timed scalar is the sum of its counts."""
    best = time_pipelined(lambda: step()[1].sum(), sizes.n_iters,
                          sizes.n_windows)
    return n_cubes * sizes.n_iters / best


def train_steps_per_s(scene, cfg: Config, images_g, Ps, sizes: BenchSizes,
                      device) -> float:
    """Training steps/s of the device-sampled loop (``train_steps_scan``):
    one warm-up chunk, then the best of ``train_chunks`` chunks of
    ``train_K`` steps, each ended by a host sync on its last loss."""
    dev = torch.device(device)
    tcfg = cfg.replace(train=TrainConfig(batch_size=sizes.train_batch,
                                         seed=0))
    state = create_train_state(tcfg, torch.Generator().manual_seed(0), dev)
    sampler = make_device_sampler(scene, tcfg,
                                  n_candidates=sizes.n_candidates, device=dev)
    gen = torch.Generator(dev).manual_seed(1)
    kw = dict(K=sizes.train_K, batch=sizes.train_batch,
              D=cfg.voxel.cube_size, s=cfg.voxel.voxel_size_mm,
              balanced=True, center_colors=True)
    train_steps_scan(state, images_g, Ps, sampler, gen, **kw)[-1].item()
    best = math.inf
    for _ in range(sizes.train_chunks):
        t0 = time.perf_counter()
        train_steps_scan(state, images_g, Ps, sampler, gen, **kw)[-1].item()
        best = min(best, time.perf_counter() - t0)
    return sizes.train_K / best


def run_bench(device="cuda", sizes: BenchSizes = BenchSizes()) -> dict:
    """Every point of bench.py at ``sizes``; returns the record."""
    dev = resolve_device(device)
    models = sizes.models
    D, D64 = sizes.D, sizes.D64
    cfg = bench_config(D)
    n_pairs = cfg.fusion.n_view_pairs
    scene = bench_scene(sizes)
    images_g = gather_images(
        torch.as_tensor(scene.images, dtype=torch.float32, device=dev),
        torch.bfloat16)
    Ps = torch.as_tensor(scene.Ps, dtype=torch.float32, device=dev)
    peak = detect_peak_tflops()

    def mfu(mcfg, d, items_per_s):
        return 100.0 * FlopModel(mcfg, d).utilization(items_per_s, peak)

    rec = {}
    # 32^3: the paper-width step, then the forward at its item count
    inputs = cube_inputs(scene, cfg, sizes.n_cubes, 1, D, dev)
    n_items = sizes.n_cubes * n_pairs
    paper = random_predictor(models["paper"], dev)
    cubes_per_s = step_cubes_per_s(
        make_step(images_g, Ps, inputs, cfg, D, paper, dev), sizes.n_cubes,
        sizes)
    fwd_ips = forward_items_per_s(paper, models["paper"], n_items, D, sizes,
                                  dev)
    fm = FlopModel(models["paper"], D)
    rec.update({
        "metric": "inference_cubes_per_s_per_chip",
        "value": cubes_per_s,
        "unit": f"cubes/s ({D}^3 voxels, {n_pairs} view pairs, full model)",
        "vs_baseline": cubes_per_s / BASELINE_CUBES_PER_S,
        "e2e_includes": (
            "deduplicated warp gather (CUDA, bf16 RGBx images) + forward + "
            f"mean fusion + windowed pool (w={POOL_WINDOW}, CUDA affine "
            "vote) + compact harvest (device top-k records)"),
        "conv_gflops_per_item": (fm.conv_stack_flops() + fm.side_flops())
        / 1e9,
        "model_fwd_items_per_s": fwd_ips,
        "model_fwd_mfu_pct": mfu(models["paper"], D, fwd_ips),
        "e2e_mfu_pct": mfu(models["paper"], D, cubes_per_s * n_pairs),
        "peak_tflops": peak,
    })
    del paper

    # 32^3 at the aligned and fast widths: forward MFU, step, e2e MFU
    for name in ("aligned", "fast"):
        mcfg = models[name]
        pred = random_predictor(mcfg, dev)
        rec[f"model_fwd_mfu_pct_{name}"] = mfu(mcfg, D, forward_items_per_s(
            pred, mcfg, n_items, D, sizes, dev))
        if name == "aligned":
            rec["model_fwd_mfu_pct_aligned_b160"] = rec[
                "model_fwd_mfu_pct_aligned"]
            rec["model_fwd_mfu_pct_aligned"] = mfu(
                mcfg, D, forward_items_per_s(pred, mcfg, sizes.aligned_batch,
                                             D, sizes, dev))
            rec["aligned_fwd_batch"] = sizes.aligned_batch
        cps = step_cubes_per_s(
            make_step(images_g, Ps, inputs, cfg, D, pred, dev),
            sizes.n_cubes, sizes)
        rec[f"cubes_per_s_{name}"] = cps
        rec[f"e2e_mfu_pct_{name}"] = mfu(mcfg, D, cps * n_pairs)
        del pred
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # 64^3: the paper-width step and forward, then the fast and fast64 steps
    inputs64 = cube_inputs(scene, cfg, sizes.n_cubes64, 2, D64, dev)
    n_items64 = sizes.n_cubes64 * n_pairs
    for name in ("paper", "fast", "fast64"):
        mcfg = models[name]
        pred = random_predictor(mcfg, dev)
        cps = step_cubes_per_s(
            make_step(images_g, Ps, inputs64, cfg, D64, pred, dev),
            sizes.n_cubes64, sizes)
        key = "64" if name == "paper" else f"64_{name}"
        rec[f"cubes_per_s_{key}"] = cps
        if name != "fast":
            rec[f"model_fwd_mfu_pct_{key}"] = mfu(
                mcfg, D64, forward_items_per_s(pred, mcfg, n_items64, D64,
                                               sizes, dev))
            rec[f"e2e_mfu_pct_{key}"] = mfu(mcfg, D64, cps * n_pairs)
        del pred
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    # training at 32^3, paper width, on the same bf16 image copy
    rec["train_steps_per_s"] = train_steps_per_s(
        scene, cfg.replace(model=models["paper"]), images_g, Ps, sizes, dev)
    rec["device"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu")
    return {k: rec[k] for k in RECORD_KEYS}


def main(device="cuda") -> dict:
    """``cli bench``: run every point at bench.py's sizes and print the
    record as one JSON line."""
    rec = run_bench(device)
    print(json.dumps(rec), flush=True)
    return rec
