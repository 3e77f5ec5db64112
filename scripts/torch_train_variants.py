"""Time the port's training step at ``dtu9_full`` by part, with variants of
its train-mode BatchNorm, and the pool sampler's host build.

    python3 scripts/torch_train_variants.py [--iters 8] [--pool-sizes 64,2048]

The step is ``chip_smoke.py`` phase 15's: fast64 widths, batch 32 of 64^3
cubes at 0.4 mm from the device sampler on ``cli train``'s synthetic
sphere (8 views of 240x320), bf16 compute on float32 master weights, the
gather kernel on a bf16 RGBx copy.  Each BatchNorm variant replaces
``models/surfacenet.py::_batchnorm`` (eval mode is untouched by all):

  * ``shipped``: the module's own (``torch.native_batch_norm``, its saved
    mean and ``1 / sqrt(var + eps)`` update the running statistics);
  * ``var_mean_f32``: ``F.batch_norm``, then a float32 ``var_mean`` of a
    float32 copy of the activation for the running statistics (the
    first design);
  * ``impl_index``: ``torch._batch_norm_impl_index``, PyTorch's own choice
    of route (cuDNN on the card), with its saved statistics;
  * ``no_running_update`` (a diagnostic, timed only): ``F.batch_norm``
    with the running statistics left as they are.

Each checked variant runs one forward from the same weights and running
statistics: the first BatchNorm layer (whose input is the same for all)
must agree with ``var_mean_f32``'s running statistics within 1e-5 of
their largest magnitude, and every running statistic must be finite.
Then forward (with the loss) and backward are timed with CUDA events,
the variants in turns.  ``torch.profiler`` lists the CUDA kernels of one
train-mode forward for ``shipped`` and ``var_mean_f32``.  Last,
``make_pool_sampler`` is timed at each ``--pool-sizes`` on the smoke
scan's scene (12 views of 600x800, 20000 ground-truth points,
``dtu9_full``): the host KD-tree labels of every cube and the pair
selection on the card.  Prints the
card's name and power limit and one JSON line per reading.  Needs a card.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from surfacenet_tpu_torch.config import baseline_config  # noqa: E402
from surfacenet_tpu_torch.data.scene import PointCloudScene  # noqa: E402
from surfacenet_tpu_torch.data.synthetic import make_sphere_scene  # noqa: E402
from surfacenet_tpu_torch.models import surfacenet as sn  # noqa: E402
from surfacenet_tpu_torch.ops.cuda.warp_gather import build_cvc_batch_cuda  # noqa: E402
from surfacenet_tpu_torch.train import train_surface as tt  # noqa: E402
from surfacenet_tpu_torch.train.losses import class_balanced_bce  # noqa: E402

SHIPPED = sn._batchnorm


def _update(bn, mean, var):
    with torch.no_grad():
        for run, batch in ((bn.running_mean, mean), (bn.running_var, var)):
            run.mul_(1.0 - bn.momentum).add_(batch, alpha=bn.momentum)


def bn_var_mean_f32(bn, x):
    if isinstance(bn, nn.Identity) or not bn.training:
        return bn(x)
    y = F.batch_norm(x, None, None, bn.weight, bn.bias, True, 0.0, bn.eps)
    with torch.no_grad():
        var, mean = torch.var_mean(x.float(), dim=(0, 2, 3, 4), correction=0)
    _update(bn, mean, var)
    return y


def bn_impl_index(bn, x):
    if isinstance(bn, nn.Identity) or not bn.training:
        return bn(x)
    y, mean, invstd, _, _ = torch._batch_norm_impl_index(
        x, bn.weight, bn.bias, None, None, True, 0.0, bn.eps,
        torch.backends.cudnn.enabled)
    with torch.no_grad():
        var = invstd.pow(-2) - bn.eps
    _update(bn, mean, var)
    return y


def bn_no_running_update(bn, x):
    if isinstance(bn, nn.Identity) or not bn.training:
        return bn(x)
    return F.batch_norm(x, None, None, bn.weight, bn.bias, True, 0.0, bn.eps)


VARIANTS = {"shipped": SHIPPED, "var_mean_f32": bn_var_mean_f32,
            "impl_index": bn_impl_index}
DIAGNOSTICS = {"no_running_update": bn_no_running_update}


def log(msg):
    print(msg, flush=True)


def running_stats(model):
    return {k: v.clone() for k, v in model.state_dict().items()
            if "running" in k}


def check_variants(state, x, labels, valid):
    """One forward a variant from the same state; returns the first layer's
    largest difference from ``var_mean_f32``'s, relative to its largest
    value, per variant."""
    start = {k: v.clone() for k, v in state.model.state_dict().items()}
    runs = {}
    for name, fn in VARIANTS.items():
        state.model.load_state_dict(start)
        sn._batchnorm = fn
        with torch.no_grad():
            class_balanced_bce(state.model.train()(x, return_logits=True),
                               labels, valid)
        runs[name] = running_stats(state.model)
    sn._batchnorm = SHIPPED
    state.model.load_state_dict(start)
    ref = runs["var_mean_f32"]
    out = {}
    for name, stats in runs.items():
        if not all(torch.isfinite(v).all() for v in stats.values()):
            raise RuntimeError(f"{name}: running statistics not finite")
        worst = 0.0
        for k in ("blocks.0.bns.0.running_mean", "blocks.0.bns.0.running_var"):
            d = (stats[k] - ref[k]).abs().max() / ref[k].abs().max()
            worst = max(worst, d.item())
        if worst > 1e-5:
            raise RuntimeError(f"{name}: first BatchNorm layer {worst:.3e} "
                               f"relative off var_mean_f32's")
        out[name] = worst
    return out


def time_variants(state, x, labels, valid, iters, rounds=2):
    """Forward (with the loss) and backward ms a variant, in turns."""
    times = {name: {"forward": [], "backward": []}
             for name in {**VARIANTS, **DIAGNOSTICS}}
    for _ in range(rounds):
        for name, fn in {**VARIANTS, **DIAGNOSTICS}.items():
            sn._batchnorm = fn
            for i in range(iters + 2):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
                ev[0].record()
                loss = class_balanced_bce(
                    state.model.train()(x, return_logits=True), labels, valid)
                ev[1].record()
                state.optimizer.zero_grad(set_to_none=True)
                loss.backward()
                ev[2].record()
                torch.cuda.synchronize()
                if i >= 2:  # two warm-up steps a turn
                    times[name]["forward"].append(ev[0].elapsed_time(ev[1]))
                    times[name]["backward"].append(ev[1].elapsed_time(ev[2]))
    sn._batchnorm = SHIPPED
    return {name: {part: float(np.mean(v)) for part, v in t.items()}
            for name, t in times.items()}


def profile_forward(state, x, labels, valid, name):
    """The CUDA kernels of one train-mode forward, by device time."""
    sn._batchnorm = {**VARIANTS, **DIAGNOSTICS}[name]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    state.model.train()(x, return_logits=True)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        class_balanced_bce(state.model.train()(x, return_logits=True),
                           labels, valid)
        torch.cuda.synchronize()
    sn._batchnorm = SHIPPED
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((us / 1e3, e.count, e.key[:90]))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    log(f"profile {name}: {len(rows)} kernels, {total:.3f} ms device time"
        + ("" if rows else " (the profiler saw no device time)"))
    for ms, n, key in rows[:14]:
        log(f"  {ms:9.3f} ms  x{n:<4d} {key}")
    return total


def time_pool(sizes):
    cfg = baseline_config("dtu9_full")
    scene = make_sphere_scene(n_views=12, hw=(600, 800), radius=30.0,
                              focal=1000.0)
    pc = PointCloudScene(images=scene.images, Ps=scene.Ps,
                         gt_points=scene.surface_points(20000))
    D = cfg.voxel.cube_size
    for n in sizes:
        t0 = time.perf_counter()
        pool = tt.make_pool_sampler(pc, cfg, n_pool=n, seed=cfg.train.seed,
                                    device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        occupied = int(tt.unpack_labels(pool[2][:64], D).sum().item())
        log("pool " + json.dumps({
            "pool_size": n, "cube_size": D, "gt_points": 20000,
            "queries": n * D ** 3, "wall_s": wall,
            "us_per_query": wall * 1e6 / (n * D ** 3), "cpus": os.cpu_count(),
            "occupied_voxels_first64": occupied}))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--pool-sizes", default="64,2048")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_train_variants: needs an NVIDIA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    dev = torch.device("cuda", 0)
    cfg = baseline_config("dtu9_full")
    D, s = cfg.voxel.cube_size, cfg.voxel.voxel_size_mm
    B = cfg.train.batch_size
    sphere = make_sphere_scene(n_views=8, hw=(240, 320))
    sampler = tt.make_device_sampler(sphere, cfg, seed=cfg.train.seed,
                                     device=dev)
    gen = torch.Generator(dev).manual_seed(5)
    origins, pairs, labels = tt.sample_device_batch(sampler, gen, batch=B,
                                                    D=D, s=s)
    images = tt.gather_copy(sphere.images, cfg, dev)
    Ps = torch.as_tensor(sphere.Ps, dtype=torch.float32, device=dev)
    x, valid = build_cvc_batch_cuda(images, Ps, pairs, origins, D=D, s=s)
    state = tt.create_train_state(cfg, device=dev)
    checks = check_variants(state, x, labels, valid)
    log("check " + json.dumps({"first_layer_rel_diff_vs_var_mean_f32":
                               checks}))
    times = time_variants(state, x, labels, valid, args.iters)
    for name, t in times.items():
        log("variant " + json.dumps({"name": name, "batch": B, "cube": D,
                                     "forward_ms": t["forward"],
                                     "backward_ms": t["backward"],
                                     "checked": name in VARIANTS}))
    for name in ("shipped", "var_mean_f32"):
        profile_forward(state, x, labels, valid, name)
    del state, x, valid
    torch.cuda.empty_cache()
    time_pool([int(n) for n in args.pool_sizes.split(",") if n])


if __name__ == "__main__":
    main()
