"""Where the time of ``cli bench``'s 32^3 points goes on the card.

    python3 scripts/torch_bench_profile.py

On ``surfacenet_tpu_torch/bench.py``'s inputs (8 sphere views of 600x800,
32 cubes of 32^3 at 0.8 mm, seed 1) and random weights (seed 0), for the
batch step at the paper and ``fast`` widths and for one training chunk
of 50 steps (paper width, batch 16, ``train_steps_scan``):

  * the host synchronisations of one call, as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them, beside an
    ``.item()`` control (``chip_smoke.py``'s ``count_syncs``);
  * the host's enqueue time (until the calls return) against the wall
    time to the host sync that ends them: a window of 10 steps as
    ``time_pipelined`` runs it, and one chunk;
  * ``torch.profiler`` over one more window or chunk: the CUDA kernels'
    summed device time against that window's wall time (the device's
    busy share under the profiler, whose host cost can lengthen the
    window), and the device time of the ten costliest operators (a
    ``Command Buffer Full`` row there is the host waiting on a full
    launch queue).

Prints the card's name and power limit and one JSON line.  Needs a card.
"""

import json
import os
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from surfacenet_tpu_torch import bench  # noqa: E402
from surfacenet_tpu_torch.config import TrainConfig  # noqa: E402
from surfacenet_tpu_torch.ops.cuda import _build  # noqa: E402
from surfacenet_tpu_torch.pipeline.sweep import gather_images  # noqa: E402
from surfacenet_tpu_torch.train.train_surface import (  # noqa: E402
    create_train_state, make_device_sampler, train_steps_scan,
)


def profiled(fn):
    """(wall ms, kernels' device ms, [(operator, device ms, calls)] of the
    ten costliest operators) of ``fn()`` under ``torch.profiler``."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
    rows = prof.key_averages()
    # CUPTI reports the host's waits on a full launch queue as a device
    # row of its own: not kernel time
    kernel_us = sum(e.self_device_time_total for e in rows
                    if e.device_type == DeviceType.CUDA
                    and e.key != "Command Buffer Full")
    ops = sorted((e for e in rows if e.device_type == DeviceType.CPU),
                 key=lambda e: -e.self_device_time_total)[:10]
    return wall * 1e3, kernel_us / 1e3, [
        (e.key, e.self_device_time_total / 1e3, e.count) for e in ops]


def window_reading(fn, n_iters=10):
    """Enqueue and wall ms of ``n_iters`` pipelined calls of ``fn`` (one
    host sync at the end), then the same window under the profiler."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xs = [fn() for _ in range(n_iters)]
    enqueue = time.perf_counter() - t0
    torch.stack(xs).sum().item()
    wall = time.perf_counter() - t0
    p_wall, kernel_ms, ops = profiled(
        lambda: torch.stack([fn() for _ in range(n_iters)]).sum().item())
    return {"enqueue_ms": enqueue * 1e3, "wall_ms": wall * 1e3,
            "profiled_wall_ms": p_wall, "kernel_ms": kernel_ms,
            "busy_share_profiled": kernel_ms / p_wall, "top_ops": ops}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_bench_profile: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    _build.build_all()
    dev = torch.device("cuda", 0)
    sizes = bench.BenchSizes()
    D = sizes.D
    cfg = bench.bench_config(D)
    scene = bench.bench_scene(sizes)
    images_g = gather_images(torch.as_tensor(scene.images, device=dev),
                             torch.bfloat16)
    Ps = torch.as_tensor(scene.Ps, dtype=torch.float32, device=dev)
    inputs = bench.cube_inputs(scene, cfg, sizes.n_cubes, 1, D, dev)
    out = {"syncs_control_item": chip_smoke.count_syncs(
        lambda: torch.ones((), device=dev).item())}
    for name in ("paper", "fast"):
        step = bench.make_step(images_g, Ps, inputs, cfg, D,
                               bench.random_predictor(sizes.models[name],
                                                      dev), dev)
        for _ in range(3):  # warm-up windows
            torch.stack([step()[1].sum() for _ in range(10)]).sum().item()
        out[f"step_{name}"] = dict(syncs=chip_smoke.count_syncs(step),
                                   **window_reading(lambda: step()[1].sum()))
        del step
        torch.cuda.empty_cache()

    tcfg = cfg.replace(train=TrainConfig(batch_size=sizes.train_batch,
                                         seed=0))
    state = create_train_state(tcfg, torch.Generator().manual_seed(0), dev)
    sampler = make_device_sampler(scene, tcfg,
                                  n_candidates=sizes.n_candidates, device=dev)
    gen = torch.Generator(dev).manual_seed(1)
    kw = dict(batch=sizes.train_batch, D=D, s=cfg.voxel.voxel_size_mm,
              balanced=True, center_colors=True)

    def chunk(K=sizes.train_K):
        return train_steps_scan(state, images_g, Ps, sampler, gen, K=K, **kw)

    chunk()[-1].item()  # warm-up chunk
    out["train"] = dict(syncs_one_step=chip_smoke.count_syncs(
        lambda: chunk(1)), **window_reading(lambda: chunk()[-1], n_iters=1))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
