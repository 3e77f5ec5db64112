"""Port parity: the sharded sweep (``parallel/sweep_sharded.py``) and the
CLI's sharded entry points, as 2 gloo ranks on the CPU.

The port's ranks run in subprocesses (tests/torch_rank_worker.py, one
launch for the scenarios, one for ``python -m surfacenet_tpu_torch.cli
reconstruct --sharded``, each killed if it outlives its timeout); the
reference's ``run_sweep_sharded`` runs on the 8-device CPU mesh with 2
blocks.  tests/test_sweep_sharded.py's config (16^3 cubes of 2 mm, 3
pairs, batches of 4, the photoconsistency predictor) on its 8-view
sphere.  Bounds: the port's sharded points and colours equal its
``run_sweep``'s (through the process group; through a ledger, colours
within 1e-4: the ledger rounds to 4 decimals); voxel agreement >= 0.99
with the reference's sharded sweep (test_run_sweep_matches_reference's
bound) and equal ``per_block_cubes``; done sets equal across the
packages' ledgers.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from surfacenet_tpu.config import Config as JConfig
from surfacenet_tpu_torch.parallel.distributed import launch_local
from surfacenet_tpu_torch.utils.metrics import voxel_set_agreement
from torch_rank_worker import load, run_suite, sweep_config

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = [
    "--set", "voxel.cube_size=16", "--set", "voxel.voxel_size_mm=2.0",
    "--set", "voxel.overlap=4", "--set", "fusion.n_view_pairs=2",
    "--set", "fusion.tau=0.25", "--set", "sweep.cube_batch=8",
    "--set", "fusion.ray_pool_mode=affine", "--device", "cpu",
]


def _sorted(points, colors=None):
    order = np.lexsort(points.T)
    return points[order], None if colors is None else colors[order]


def _port_sweep(sc, cfg):
    from surfacenet_tpu_torch.pipeline.sweep import (
        photoconsistency_predictor, run_sweep,
    )

    store, stats = run_sweep(sc.images, sc.Ps, sc.bbox_min, sc.bbox_max,
                             cfg, photoconsistency_predictor, device="cpu")
    pts, _, cols = store.merge()
    return _sorted(pts, cols)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's sharded sweep (its block ledgers written where the
    port's ranks resume from them), the port's single-process sweeps,
    a scan on disk, then the ``sweep`` suite as 2 ranks."""
    import dataclasses

    from surfacenet_tpu.parallel.mesh import make_mesh
    from surfacenet_tpu.parallel.sweep_sharded import run_sweep_sharded
    from surfacenet_tpu.pipeline.sweep import photoconsistency_predictor
    from surfacenet_tpu_torch.data.dtu import write_scan
    from surfacenet_tpu_torch.data.synthetic import make_sphere_scene

    out = tmp_path_factory.mktemp("sweep")
    sc = make_sphere_scene(n_views=8, hw=(120, 160))
    tcfg = sweep_config()
    jcfg = JConfig.from_json(tcfg.to_json())
    jstore, jstats = run_sweep_sharded(
        sc.images, sc.Ps, sc.bbox_min, sc.bbox_max, jcfg,
        photoconsistency_predictor, mesh=make_mesh(n_block=2),
        ledger_dir=str(out / "jax_ledgers"))
    scan = str(out / "scans" / "scan1")
    write_scan(scan, sc.images, sc.Ps, sc.bbox_min, sc.bbox_max)
    argv = ["reconstruct-all", "--scans", scan, "--out-dir",
            str(out / "split"), "--sharded", "--set", "mesh.block_axis=2",
            *TINY]
    with open(out / "cli_args.json", "w") as f:
        json.dump(argv, f)
    run_suite("sweep", out, timeout_s=400)
    return dict(
        out=out, scene=sc, scan=scan, jstore=jstore, jstats=jstats,
        plain=_port_sweep(sc, tcfg),
        consensus=_port_sweep(sc, tcfg.replace(fusion=dataclasses.replace(
            tcfg.fusion, fusion_mode="consensus"))),
        refetch=_port_sweep(sc, tcfg.replace(sweep=dataclasses.replace(
            tcfg.sweep, compact_k=8))),
    )


def _points(runs, name, rank=0):
    got = load(runs["out"], name, rank)
    return _sorted(got["points"], got["colors"])


def test_sharded_sweep_matches_run_sweep_and_reference(runs):
    """2 blocks over 2 ranks, the blocks' results sent to rank 0 through
    the process group: the points and colours of the port's ``run_sweep``
    exactly, and the reference's sharded sweep's blocks and points."""
    pts, cols = _points(runs, "blocks2")
    want_pts, want_cols = runs["plain"]
    np.testing.assert_array_equal(pts, want_pts)
    np.testing.assert_array_equal(cols, want_cols)
    jpts, _, _ = runs["jstore"].merge()
    assert voxel_set_agreement(pts, jpts) >= 0.99
    jstats = runs["jstats"]
    for r in (0, 1):
        st = load(runs["out"], "blocks2", r, "json")
        assert st["per_block_cubes"] == list(jstats.per_block_cubes)
        # rounds of cube_batch (4) cubes a block: the reference's mesh
        # has 4 devices a block row, so a quarter as many
        assert st["n_rounds"] == 4 * jstats.n_rounds == -(
            -max(jstats.per_block_cubes) // 4)
        assert st["n_cubes_after_prefilter"] == \
            jstats.n_cubes_after_prefilter
        assert st["n_batches"] == st["n_rounds"]  # every round had work
    # rank 1 returns its own block's store: block 1's cubes
    b1 = load(runs["out"], "blocks2", 1)["done"]
    assert len(b1) == jstats.per_block_cubes[1]


def test_sharded_sweep_one_row_of_two_ranks(runs):
    """``block_axis`` 1 over 2 ranks: one block, its row's first rank the
    one ledger writer; the points of ``run_sweep``."""
    from surfacenet_tpu_torch.pipeline.sparse import ledger_records

    pts, cols = _points(runs, "row")
    np.testing.assert_array_equal(pts, runs["plain"][0])
    assert np.abs(cols - runs["plain"][1]).max() <= 1e-4
    ledger_dir = runs["out"] / "row_ledgers"
    assert sorted(os.listdir(ledger_dir)) == ["block_0.jsonl"]
    recs = list(ledger_records(str(ledger_dir / "block_0.jsonl")))
    with open(ledger_dir / "block_0.jsonl") as f:
        assert len(f.readlines()) == len(recs)  # no torn line
    cubes = [tuple(r["grid_idx"]) for r in recs]
    st = [load(runs["out"], "row", r, "json") for r in (0, 1)]
    assert len(cubes) == len(set(cubes)) == st[0]["n_cubes_after_prefilter"]
    assert st[0]["n_batches"] + st[1]["n_batches"] >= st[0]["n_rounds"]
    assert len(load(runs["out"], "row", 1)["points"]) == 0


def test_block_ledger_resume_matches_uninterrupted(runs):
    """Each block ledger cut to half its lines plus a torn half line: the
    resumed sweep sweeps only the missing cubes and gives the
    uninterrupted run's points (colours within the ledger's rounding)."""
    full_pts, full_cols = _points(runs, "ledgered")
    np.testing.assert_array_equal(full_pts, runs["plain"][0])
    assert np.abs(full_cols - runs["plain"][1]).max() <= 1e-4
    pts, cols = _points(runs, "resumed")
    np.testing.assert_array_equal(pts, full_pts)
    assert np.abs(cols - full_cols).max() <= 1e-4
    full = load(runs["out"], "ledgered", 0, "json")
    resumed = load(runs["out"], "resumed", 0, "json")
    assert 0 < resumed["n_rounds"] < full["n_rounds"]


def test_block_ledgers_read_by_either_package(runs):
    """The reference's block ledgers resume the port's sweep (nothing left
    to sweep, equal done sets and points); the port's are read by the
    reference's store with the port's done sets."""
    from surfacenet_tpu.pipeline.sparse import SparseCubeStore

    got = load(runs["out"], "from_jax", 0)
    assert load(runs["out"], "from_jax", 0, "json")["n_rounds"] == 0
    jdone = runs["jstore"].done_set()
    assert {tuple(g) for g in got["done"].tolist()} == jdone
    jpts, _, _ = runs["jstore"].merge()
    assert voxel_set_agreement(got["points"], jpts) == 1.0
    port = load(runs["out"], "ledgered", 0)
    done = set()
    for b in (0, 1):
        st = SparseCubeStore(np.zeros(3), 2.0, 16, 12, ledger_path=str(
            runs["out"] / "ledgers" / f"block_{b}.jsonl"))
        assert not done & st.done_set()
        done |= st.done_set()
    assert done == {tuple(g) for g in port["done"].tolist()}


def test_sharded_truncation_refetch_per_cube(runs):
    """``compact_k`` 8: the ranks re-run their truncated cubes dense; the
    points of the untruncated ``run_sweep``, the colours of ``run_sweep``
    at the same ``compact_k`` (a dense re-run's colours are not quantised
    to 8 bits as the records' are)."""
    st = [load(runs["out"], "refetch", r, "json") for r in (0, 1)]
    assert st[0]["n_refetched"] > 0
    assert all(s["n_refetch_batches"] > 0 for s in st)
    pts, cols = _points(runs, "refetch")
    np.testing.assert_array_equal(pts, runs["plain"][0])
    np.testing.assert_array_equal(pts, runs["refetch"][0])
    np.testing.assert_array_equal(cols, runs["refetch"][1])


def test_sharded_consensus_fusion_matches_run_sweep(runs):
    pts, cols = _points(runs, "consensus")
    np.testing.assert_array_equal(pts, runs["consensus"][0])
    np.testing.assert_array_equal(cols, runs["consensus"][1])


def test_cli_reconstruct_all_sharded(runs, tmp_path):
    """``reconstruct-all --sharded`` over 2 ranks: rank 0 writes the split's
    ``.ply`` and report, equal to the single-process command's points;
    the other rank writes nothing."""
    from surfacenet_tpu_torch.cli import main
    from surfacenet_tpu_torch.utils.ply import read_ply

    split = runs["out"] / "split"
    r0 = load(runs["out"], "reconstruct_all", 0, "json")
    r1 = load(runs["out"], "reconstruct_all", 1, "json")
    assert r1["report"] == {} and r0["report"]["scan1"]["points"] > 50
    assert sorted(os.listdir(split / "scan1.ledgers")) == [
        "block_0.jsonl", "block_1.jsonl"]
    with open(split / "report.json") as f:
        assert json.load(f) == r0["report"]
    report, _ = main(["reconstruct-all", "--scans", runs["scan"],
                      "--out-dir", str(tmp_path), *TINY])
    assert report["scan1"]["points"] == r0["report"]["scan1"]["points"]
    got = read_ply(str(split / "scan1.ply"))[0]
    want = read_ply(str(tmp_path / "scan1.ply"))[0]
    assert voxel_set_agreement(got, want) == 1.0


def test_cli_reconstruct_sharded_two_ranks(runs, tmp_path):
    """``python -m surfacenet_tpu_torch.cli reconstruct --sharded`` as 2
    ranks with torchrun's environment: block ledgers, rank 0's ``.ply`` and
    metrics line (the reference's keys), the single-process points."""
    from surfacenet_tpu_torch.cli import main
    from surfacenet_tpu_torch.utils.ply import read_ply

    out, metrics = tmp_path / "s.ply", tmp_path / "m.jsonl"
    outs = launch_local(
        [sys.executable, "-m", "surfacenet_tpu_torch.cli", "reconstruct",
         "--scan", runs["scan"], "--out", str(out), "--sharded",
         "--set", "mesh.block_axis=2", "--ledger", str(tmp_path / "l"),
         "--metrics-out", str(metrics), *TINY], 2, 180, cwd=REPO)
    assert "backend gloo" in outs[0] and "sharded sweep:" in outs[0]
    assert "export is on rank 0" in outs[1]
    assert sorted(os.listdir(tmp_path / "l")) == ["block_0.jsonl",
                                                  "block_1.jsonl"]
    with open(metrics) as f:
        lines = f.readlines()
    assert len(lines) == 1  # one writer
    rec = json.loads(lines[0])
    for key in ("cubes_processed", "sweep_wall_s", "cubes_per_s", "n_rounds",
                "n_cubes_total", "n_cubes_after_prefilter",
                "per_block_cubes"):
        assert key in rec
    assert rec["cubes_processed"] == rec["n_cubes_after_prefilter"]
    n, _, _ = main(["reconstruct", "--scan", runs["scan"], "--out",
                    str(tmp_path / "one.ply"), *TINY])
    got = read_ply(str(out))[0]
    assert len(got) == n > 50
    assert voxel_set_agreement(got, read_ply(str(tmp_path / "one.ply"))[0]) \
        == 1.0
