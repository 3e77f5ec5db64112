"""The unfused SurfaceNet forward with BatchNorm in bf16 or in float32.

    python3 scripts/torch_unfused_bn_dtype.py

``make_predictor``'s unfused forward casts only the convs' weights to
bf16 and keeps BatchNorm's parameters and running statistics in float32,
as flax's ``nn.BatchNorm(dtype=bfloat16, param_dtype=float32)`` does.
This script builds that predictor beside the whole-model bf16 cast
(``model.to(dtype=torch.bfloat16)``, BatchNorm rounded to bf16 too) for
the shipped sphere weights at ``dtu9_full`` (fast64) and ``dtu9_paper``
widths, times both on 120 items of 64^3 (a sweep batch: 24 cubes x 5
pairs; seeded inputs) with CUDA events, four times each in turns, and
reports each cast's times and the float32 cast's peak memory.

Prints the card's name and power limit and one JSON line.  Needs a card.
"""

import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from surfacenet_tpu_torch.config import baseline_config  # noqa: E402
from surfacenet_tpu_torch.models.convert import load_surfacenet  # noqa: E402
from surfacenet_tpu_torch.models.surfacenet import make_predictor  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    out = {"device": torch.cuda.get_device_name(0)}
    for preset, weights in (("dtu9_full", chip_smoke.TRAINED),
                            ("dtu9_paper", chip_smoke.TRAINED_PAPER)):
        cfg = baseline_config(preset).model
        path = weights.format(scene="sphere")
        bn_f32 = make_predictor(load_surfacenet(path, cfg), cfg, dev)
        whole = load_surfacenet(path, cfg).to(
            device=dev, dtype=torch.bfloat16).to(
            memory_format=torch.channels_last_3d).eval()

        def bn_bf16(x):
            with torch.inference_mode():
                return whole(x)

        runs = {"bn_bf16": bn_bf16, "bn_f32": bn_f32}
        x = 0.2 * torch.randn((120, 64, 64, 64, 6), device=dev,
                              generator=torch.Generator(dev).manual_seed(0))
        x = x.to(torch.bfloat16)
        ms = {k: [] for k in runs}
        for k in ("bn_bf16", "bn_f32") * 2 + ("bn_f32", "bn_bf16") * 2:
            ms[k].append(chip_smoke.cuda_ms(lambda: runs[k](x), iters=5,
                                            warmup=1))
        torch.cuda.reset_peak_memory_stats()
        runs["bn_f32"](x)
        torch.cuda.synchronize()
        out[preset] = {"ms": ms, "bn_f32_peak_gb":
                       torch.cuda.max_memory_allocated() / 1e9}
        print(preset, json.dumps(out[preset]), flush=True)
        del bn_f32, whole, runs, x
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
