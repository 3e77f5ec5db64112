"""Command-line entry point of the port.

    python -m surfacenet_tpu_torch.cli reconstruct --scan DIR --out out.ply \
        [--preset dtu9_full | --config cfg.json] [--set voxel.cube_size=64] \
        [--checkpoint weights.npz] [--bbox x0,y0,z0,x1,y1,z1] [--device cuda]

``--checkpoint`` takes the ``.npz`` written by ``models/convert.py``;
without it the photoconsistency predictor runs.  ``--device`` defaults to
``cuda`` and fails when no card is present; ``--device cpu`` runs the
plain PyTorch versions of the kernels on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np


def _apply_overrides(cfg, sets):
    for item in sets or []:
        path, _, raw = item.partition("=")
        keys = path.split(".")
        try:
            val = json.loads(raw)
        except json.JSONDecodeError:
            val = raw
        if isinstance(val, list):
            val = tuple(val)  # config fields are hashable tuples
        node = cfg
        parents = []
        for k in keys[:-1]:
            parents.append((node, k))
            node = getattr(node, k)
        node = dataclasses.replace(node, **{keys[-1]: val})
        for parent, k in reversed(parents):
            node = dataclasses.replace(parent, **{k: node})
        cfg = node
    return cfg


def _load_config(args):
    from surfacenet_tpu_torch.config import Config, baseline_config

    if getattr(args, "preset", None):
        cfg = baseline_config(args.preset)
    elif getattr(args, "config", None):
        with open(args.config) as f:
            cfg = Config.from_json(f.read())
    else:
        cfg = Config()
    return _apply_overrides(cfg, getattr(args, "set", None))


def _load_predictor(checkpoint, cfg, device):
    """Model predictor from an ``.npz`` checkpoint, else photoconsistency."""
    if not checkpoint:
        from surfacenet_tpu_torch.pipeline.sweep import (
            photoconsistency_predictor,
        )

        print("no checkpoint: using photoconsistency predictor")
        return photoconsistency_predictor
    from surfacenet_tpu_torch.models.convert import load_surfacenet
    from surfacenet_tpu_torch.models.surfacenet import make_predictor

    print(f"using weights {checkpoint}")
    return make_predictor(load_surfacenet(checkpoint, cfg.model), cfg.model,
                          device)


def reconstruct_scan(scan, cfg, predictor, out: str, device="cuda"):
    """Sweep a loaded scan and write the merged point cloud to ``out``.

    ``scan`` has images (V, H, W, 3), Ps (V, 3, 4) and bbox_min/bbox_max
    (estimated from the cameras when None).  Returns (points written,
    SweepStats, {stage: wall seconds}).
    """
    from surfacenet_tpu_torch.device import resolve_device
    from surfacenet_tpu_torch.geometry.camera import (
        estimate_bbox_from_cameras,
    )
    from surfacenet_tpu_torch.pipeline.sweep import run_sweep

    dev = resolve_device(device)
    bbox_min, bbox_max = scan.bbox_min, scan.bbox_max
    if bbox_min is None:
        bbox_min, bbox_max = estimate_bbox_from_cameras(scan.Ps)
        print(
            f"no bbox given; estimated from cameras: "
            f"{np.round(bbox_min, 1)} .. {np.round(bbox_max, 1)}"
        )
    store, stats = run_sweep(
        scan.images, scan.Ps, bbox_min, bbox_max, cfg, predictor, device=dev,
    )
    t0 = time.perf_counter()
    n = store.export_ply(out)
    timings = {
        "refine_s": stats.refine_s, "plan_s": stats.plan_s,
        "sweep_s": stats.sweep_s, "merge_export_s": time.perf_counter() - t0,
    }
    print(
        f"wrote {n} points to {out}; {stats.n_cubes_nonempty}/"
        f"{stats.n_cubes_after_prefilter} cubes non-empty"
    )
    return n, stats, timings


def cmd_reconstruct(args):
    from surfacenet_tpu_torch.data.dtu import load_scan
    from surfacenet_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    cfg = _load_config(args)
    scan = load_scan(args.scan, downsample=args.downsample)
    if args.bbox:
        vals = [float(v) for v in args.bbox.split(",")]
        if len(vals) != 6:
            raise SystemExit(
                f"--bbox needs 6 comma-separated numbers "
                f"(x0,y0,z0,x1,y1,z1), got {len(vals)}"
            )
        scan.bbox_min = np.asarray(vals[:3])
        scan.bbox_max = np.asarray(vals[3:])
    predictor = _load_predictor(args.checkpoint, cfg, dev)
    reconstruct_scan(scan, cfg, predictor, args.out, dev)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="surfacenet_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    pr = sub.add_parser("reconstruct", help="sweep a scan -> .ply")
    pr.add_argument("--scan", required=True)
    pr.add_argument("--out", default="out.ply")
    pr.add_argument("--bbox",
                    help="x0,y0,z0,x1,y1,z1 (mm); default: estimate from cameras")
    pr.add_argument("--checkpoint", help=".npz weights (models/convert.py)")
    pr.add_argument("--downsample", type=int, default=1)
    pr.add_argument("--preset")
    pr.add_argument("--config")
    pr.add_argument("--set", action="append")
    pr.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    pr.set_defaults(fn=cmd_reconstruct)
    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
