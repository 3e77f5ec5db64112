"""Observability: structured metrics, FLOP accounting, profiler hook.

Port of ``surfacenet_tpu/utils/observability.py``:
  * ``FlopModel``: analytic FLOP and byte counts of the per-cube inference
    program, for achieved-against-peak utilisation;
  * ``Metrics``: counters, gauges and stage timers, flushed as one JSON
    line (``run_sweep(metrics=)``, ``cli reconstruct --metrics-out``), with
    the reference's keys and record; one writer a job (the sharded sweep
    drops it on every rank but 0, and ``cli`` makes it on rank 0 only);
  * ``trace``: a ``torch.profiler`` capture of a block, written as a Chrome
    trace when ``SURFACENET_TORCH_PROFILER_DIR`` is set, a no-op otherwise.

The reference's ``FlopModel.mxu_ceiling`` (TPU MXU lane padding) has no
counterpart: Hopper's tensor cores take N in steps of 8, so it models
nothing on the card (ROADMAP.md).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Dict, Optional

import torch
from torch.profiler import ProfilerActivity, profile

from surfacenet_tpu_torch.config import ModelConfig

# dense (no sparsity) bf16 tensor-core peak, TFLOP/s, by the name
# torch.cuda.get_device_name gives: NVIDIA H100 SXM data sheet, at the
# card's full 700 W power limit
PEAK_TFLOPS = {"H100": 989.0}

PROFILER_DIR_ENV = "SURFACENET_TORCH_PROFILER_DIR"


def detect_peak_tflops(default: float = PEAK_TFLOPS["H100"]) -> float:
    """Peak bf16 TFLOP/s of CUDA device 0 from ``PEAK_TFLOPS``; ``default``
    where there is no card or its name is not in the table."""
    if torch.cuda.is_available():
        name = torch.cuda.get_device_name(0)
        for key, peak in PEAK_TFLOPS.items():
            if key in name:
                return peak
    return default


@dataclasses.dataclass
class FlopModel:
    """Analytic cost model of the per-cube inference program."""

    cfg: ModelConfig
    D: int

    def conv_stack_flops(self) -> float:
        """MACs*2 of all 3x3x3 (dilated) convs at their block resolutions."""
        total = 0.0
        res = self.D
        cin = self.cfg.in_channels
        for ch, nc, pool in zip(self.cfg.block_channels,
                                self.cfg.convs_per_block,
                                self.cfg.pool_after_block):
            for _ in range(nc):
                total += 2 * 27 * cin * ch * res**3
                cin = ch
            if pool:
                res //= 2
        return total

    def side_flops(self) -> float:
        total = 0.0
        res = self.D
        for ch, pool in zip(self.cfg.block_channels,
                            self.cfg.pool_after_block):
            total += 2 * ch * self.cfg.side_channels * res**3  # 1^3 conv
            if pool:
                res //= 2
        # final 1^3 conv over the concatenated sides
        total += (2 * len(self.cfg.block_channels) * self.cfg.side_channels
                  * self.D**3)
        return total

    def cvc_gather_bytes(self, n_views: int = 2) -> float:
        """Gather traffic: 4 corner pixels x 3 channels x D^3 x views."""
        return n_views * 4 * 3 * 4 * self.D**3

    def utilization(self, items_per_s: float, peak_tflops=None) -> float:
        peak = peak_tflops or detect_peak_tflops()
        return ((self.conv_stack_flops() + self.side_flops())
                * items_per_s / 1e12 / peak)


class Metrics:
    """Structured metrics sink: counters, gauges, stage timers."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.data: Dict[str, float] = {}

    def count(self, key: str, delta: float = 1.0) -> None:
        self.data[key] = self.data.get(key, 0.0) + delta

    def gauge(self, key: str, value: float) -> None:
        self.data[key] = float(value)

    @contextlib.contextmanager
    def timer(self, key: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.count(f"{key}_s", time.perf_counter() - t0)
            self.count(f"{key}_n", 1)

    def snapshot(self) -> Dict[str, float]:
        return dict(self.data)

    def flush(self, extra: Optional[Dict] = None) -> None:
        """Append one JSON line: a timestamp, the data and ``extra``."""
        if not self.path:
            return
        rec = {"ts": time.time(), **self.data, **(extra or {})}
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")


@contextlib.contextmanager
def trace(name: str = "surfacenet"):
    """A ``torch.profiler`` capture of the block (CPU and, with a card,
    CUDA activity), exported as ``<dir>/<name>.<pid>.<ms>.json`` (Chrome
    trace format) when ``SURFACENET_TORCH_PROFILER_DIR`` names a
    directory; a no-op otherwise."""
    out = os.environ.get(PROFILER_DIR_ENV)
    if not out:
        yield
        return
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    os.makedirs(out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        out, f"{name}.{os.getpid()}.{int(time.time() * 1e3)}.json"))


def scaling_efficiency(
    cubes_per_s: Dict[int, float], base_n: Optional[int] = None
) -> Dict[int, float]:
    """Weak-scaling efficiency: throughput(n) / (n/base * throughput(base)).

    ``cubes_per_s`` maps a rank count to cubes/s, or to the
    ``ShardedSweepStats`` of a sweep over that many ranks (its
    ``cubes_per_s``)."""
    if not cubes_per_s:
        return {}
    cubes_per_s = {n: float(getattr(v, "cubes_per_s", v))
                   for n, v in cubes_per_s.items()}
    base_n = base_n or min(cubes_per_s)
    base = cubes_per_s[base_n]
    return {n: v / (base * n / base_n) for n, v in cubes_per_s.items()}
