"""The prepass-on rows of ``results/robustness_r05.json``, rerun on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/robustness_refine_cpu.py [--out FILE]
        [--sigmas 0,0.5,1,2]

``scripts/robustness_refine_eval.py``'s recipe with the calibration
prepass on, run by the JAX package on a CPU backend (where that script
configures itself so: ``ray_pool_mode="affine"``, no Pallas gather): the
op-point sphere ``make_sphere_scene(n_views=12, hw=(600, 800),
radius=30.0, focal=200.0)`` in memory, clean and through
``degrade_scene(clean, calib_sigma_px=sigma, seed=1)``; ``Config()`` with
32^3 cubes of 0.5 mm (overlap 8), batch 32, 4 pairs, tau 0.7, gamma 0.7, 6
pooling views, ``ModelConfig()`` (paper widths, bf16) and
``weights/golden_sphere_30k``; ``sweep.refine_calib`` on at the presets'
schedule.  The record's rows came from a TPU, whose float order the
prepass (ROADMAP C4) does not share with a CPU; this is the same recipe's
CPU reading, which ``chip_smoke.py`` phase 24 holds the card to where the
reference's own CPU run misses the TPU row.

Prints one JSON line a row and writes ``{"rows": [...]}`` to ``--out``:
each row's accuracy, completeness and their mean (unclamped, against
``surface_points(8000)``), points, the prepass's passes and largest shift,
and seconds.  Imports the JAX package only; ~4 min a row on 8 cores.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("JAX_PLATFORMS", "cpu")

from surfacenet_tpu.config import (  # noqa: E402
    Config, FusionConfig, ModelConfig, SweepConfig, VoxelConfig,
)
from surfacenet_tpu.data.synthetic import (  # noqa: E402
    degrade_scene, make_sphere_scene,
)
from surfacenet_tpu.pipeline.sweep import run_sweep  # noqa: E402
from surfacenet_tpu.train.train_surface import load_pretrained  # noqa: E402
from surfacenet_tpu.utils.metrics import accuracy_completeness  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--sigmas", default="0,0.5,1,2")
    args = ap.parse_args()
    cfg = Config(
        voxel=VoxelConfig(voxel_size_mm=0.5, cube_size=32, overlap=8),
        model=ModelConfig(),
        sweep=SweepConfig(cube_batch=32, refine_calib=True),
        fusion=FusionConfig(n_view_pairs=4, tau=0.7, gamma=0.7,
                            ray_pool_mode="affine", n_pool_views=6),
    )
    clean = make_sphere_scene(n_views=12, hw=(600, 800), radius=30.0,
                              focal=200.0)
    gt = clean.surface_points(8000)
    model, variables = load_pretrained(
        os.path.join(REPO, "weights", "golden_sphere_30k"), cfg)

    def predictor(x, origins):
        return model.apply(variables, x, train=False)

    # the prepass's info, which run_sweep does not return
    import surfacenet_tpu.geometry.refine as R

    infos, real = [], R.refine_calibration_auto

    def kept(*a, **kw):
        Ps, info = real(*a, **kw)
        infos.append(info)
        return Ps, info

    R.refine_calibration_auto = kept
    out = {"recipe": "scripts/robustness_refine_eval.py, prepass on, JAX "
                     "package on a CPU backend (affine pooling, no Pallas "
                     "gather), ModelConfig() bf16",
           "rows": []}
    for sigma in (float(x) for x in args.sigmas.split(",")):
        scene = (clean if not sigma
                 else degrade_scene(clean, calib_sigma_px=sigma, seed=1))
        t0 = time.perf_counter()
        store, _ = run_sweep(scene.images, scene.Ps, scene.bbox_min,
                             scene.bbox_max, cfg, predictor)
        pts = store.merge()[0]
        acc, comp = accuracy_completeness(pts, gt)
        info = infos[-1]
        row = {"label": "clean" if not sigma else f"calib_sigma_px={sigma}",
               "refine": True, "acc_mm": round(float(acc), 4),
               "comp_mm": round(float(comp), 4),
               "overall_mm": round(float((acc + comp) / 2), 4),
               "n_pts": int(len(pts)), "passes": int(info["passes"]),
               "max_shift_px": float(info["max_shift_px"]),
               "s": round(time.perf_counter() - t0, 1)}
        out["rows"].append(row)
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "w") as f:
                f.write(json.dumps(out, indent=2) + "\n")
    R.refine_calibration_auto = real
    return 0


if __name__ == "__main__":
    sys.exit(main())
