"""Sharded scene sweep over the (block, cube) rank grid.

Port of ``surfacenet_tpu/parallel/sweep_sharded.py``, one process a rank
(``parallel/distributed.py``):

  * ``block`` axis: the prefilter's surviving cubes are cut into
    contiguous slabs along the lattice's longest axis
    (``partition_cubes``); block ``b`` is swept by the ranks of mesh row
    ``b`` into one ``SparseCubeStore`` on the scene's frame, with its own
    ledger ``<ledger_dir>/block_<b>.jsonl`` in the reference's record
    format (either package resumes from the other's);
  * ``cube`` axis: data parallel over a block's cubes.

Every rank plans the same schedule: the refinement prepass runs on rank 0
and its matrices are broadcast (the reference runs it on every process
and relies on bitwise-equal results, which atomics in the backward on the
card do not give), then enumeration, prefilter and partition, and the
block ledgers' done sets, read by every rank after a barrier.  Round r
takes ``cube_batch * n_cube`` cubes from each block, ``cube_batch`` for
each rank of its row in row order, as the reference's round shards them;
a rank whose slice is empty sits the round out.  A rank selects pairs for
its own cubes only and runs ``cube_batch_step`` on them, its rounds
pipelined ``DEPTH`` deep as ``run_sweep``'s batches; cubes whose compact
records fell short are re-run dense by that rank alone.  A row's first
rank is its block's one store and ledger writer: the row's other ranks
send it what they harvested each round.

After the last round (a barrier), rank 0 merges every block: its own, the
others' rehydrated from their ledgers when there is a ``ledger_dir``, else
sent through the process group (so ``reconstruct --sharded`` needs no
``--ledger``).  Other ranks return their own block's store, or an empty
one.  Metrics are written by rank 0 alone, with the job's counts.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from surfacenet_tpu_torch.config import Config
from surfacenet_tpu_torch.device import resolve_device
from surfacenet_tpu_torch.parallel.distributed import (
    all_reduce_, barrier, broadcast_object,
)
from surfacenet_tpu_torch.parallel.mesh import RankMesh, make_mesh
from surfacenet_tpu_torch.pipeline.sparse import (
    CubeResult, SparseCubeStore, ledger_done_set,
)
from surfacenet_tpu_torch.pipeline.sweep import (
    Predictor, SweepStats, _check_supported, gather_images, harvest_batch,
    not_done, plan_cubes, prefiltered_cubes, resolve_compact_k,
    resolve_pool_window, sweep_gather_dtype, sweep_step,
)
from surfacenet_tpu_torch.utils.observability import trace

DEPTH = 3  # rounds in flight while the host harvests an older one


def partition_cubes(grid: np.ndarray, n_block: int) -> List[np.ndarray]:
    """Split cube grid indices into n_block contiguous slabs.

    Slabs are cut along the axis with the largest extent so blocks are as
    chunky as possible (minimizes boundary surface / halo volume).
    Returns a list of index arrays into ``grid``.
    """
    if len(grid) == 0:
        return [np.zeros((0,), int) for _ in range(n_block)]
    extents = grid.max(axis=0) - grid.min(axis=0) + 1
    axis = int(np.argmax(extents))
    order = np.argsort(grid[:, axis], kind="stable")
    return [np.array_split(order, n_block)[b] for b in range(n_block)]


@dataclasses.dataclass
class ShardedSweepStats(SweepStats):
    """``SweepStats`` of the job (cube counts summed over the ranks), with
    ``n_batches`` and ``n_refetch_batches`` this rank's own dispatches
    (batch steps, and dense re-runs of truncated cubes)."""

    n_rounds: int = 0
    wall_s: float = 0.0  # the rounds, every rank's included
    cubes_per_s: float = 0.0
    per_block_cubes: Optional[List[int]] = None
    # with measure_device_time: this rank's dispatch-to-done seconds
    device_s: float = 0.0
    n_refetch_batches: int = 0


def _sparse(res: CubeResult):
    """A cube's occupied voxels: (grid index, flat indices, probs, colours)."""
    idx = np.flatnonzero(res.occupancy)
    color = (None if res.color is None
             else res.color.reshape(-1, 3)[idx].astype(np.float32))
    return (tuple(int(v) for v in res.grid_idx), idx.astype(np.int32),
            res.prob.reshape(-1)[idx].astype(np.float32), color)


def _dense(rec, D: int) -> CubeResult:
    g, idx, prob, color = rec
    occ = np.zeros(D**3, bool)
    occ[idx] = True
    p = np.zeros(D**3, np.float32)
    p[idx] = prob
    c = None
    if color is not None:
        c = np.zeros((D**3, 3), np.float32)
        c[idx] = color
        c = c.reshape(D, D, D, 3)
    return CubeResult(g, occ.reshape(D, D, D), p.reshape(D, D, D), c)


def run_sweep_sharded(
    images: np.ndarray,
    Ps: np.ndarray,
    bbox_min: np.ndarray,
    bbox_max: np.ndarray,
    cfg: Config,
    predictor: Predictor,
    mesh: Optional[RankMesh] = None,
    pair_selector: Optional[Callable] = None,
    ledger_dir: Optional[str] = None,
    metrics=None,
    measure_device_time: bool = False,
    *,
    device="cuda",
) -> Tuple[SparseCubeStore, ShardedSweepStats]:
    """Sharded sweep over ``mesh`` (default ``make_mesh(cfg.mesh.
    block_axis)``); every rank of the grid calls it with the same inputs.

    Returns (store, stats): on rank 0 the store of every block merged, on
    the others their own block's store (a row's first rank) or an empty
    one.  ``measure_device_time`` runs the rounds one at a time, waits for
    each, and sums the waits in ``stats.device_s`` (slower than the
    pipelined sweep: a measurement mode).
    """
    dev = resolve_device(device)
    _check_supported(cfg)
    gdt = sweep_gather_dtype(cfg)
    if mesh is None:
        mesh = make_mesh(cfg.mesh.block_axis, tuple(cfg.mesh.axis_names))
    n_block, n_cube = mesh.shape
    rank, world = mesh.rank, mesh.size
    if metrics is not None and rank != 0:
        metrics = None  # one metrics writer a job
    stats = ShardedSweepStats()
    D, s = cfg.voxel.cube_size, cfg.voxel.voxel_size_mm
    B = cfg.sweep.cube_batch
    hw = tuple(np.asarray(images).shape[1:3])
    images_t = torch.as_tensor(np.asarray(images), dtype=torch.float32,
                               device=dev)

    t0 = time.perf_counter()
    if cfg.sweep.refine_calib:
        refined = None
        if rank == 0:
            from surfacenet_tpu_torch.geometry.refine import (
                refine_calibration_auto,
            )

            refined = refine_calibration_auto(
                images_t, Ps, bbox_min, bbox_max,
                steps_per_level=cfg.sweep.refine_calib_steps,
                n_probes=cfg.sweep.refine_calib_probes, device=dev,
            )
        if world > 1:
            refined = broadcast_object(refined, src=0)
        Ps, stats.refine_info = refined
        if metrics is not None:
            metrics.gauge("refine_calib_max_shift_px",
                          stats.refine_info["max_shift_px"])
            metrics.gauge("refine_calib_passes", stats.refine_info["passes"])
    stats.Ps = np.asarray(Ps)
    t1 = time.perf_counter()
    stats.refine_s = t1 - t0

    grid, origins, stats.n_cubes_total, lattice_max = prefiltered_cubes(
        Ps, bbox_min, bbox_max, hw, cfg, dev)
    stats.n_cubes_after_prefilter = len(grid)
    blocks = partition_cubes(grid, n_block)
    stats.per_block_cubes = [len(b) for b in blocks]
    ledgers = [os.path.join(ledger_dir, f"block_{b}.jsonl") if ledger_dir
               else None for b in range(n_block)]
    # the schedule follows from the done sets, so every rank must read
    # the same ones: none may still be appending from a previous run
    barrier()
    todo = [idxs[not_done(grid[idxs], ledger_done_set(path))]
            for idxs, path in zip(blocks, ledgers)]

    per_block_round = B * n_cube
    n_rounds = max((-(-len(t) // per_block_round) for t in todo), default=0)
    b_me, c_me = mesh.block, mesh.cube
    lo = np.arange(n_rounds) * per_block_round + c_me * B
    my_rounds = [todo[b_me][a: a + B] for a in lo]
    my_items = (np.concatenate(my_rounds) if my_rounds
                else np.zeros((0,), int))
    plan = plan_cubes(grid[my_items], origins[my_items], grid, lattice_max,
                      stats.n_cubes_total, Ps, hw, cfg, dev, pair_selector)
    t2 = time.perf_counter()
    stats.plan_s = t2 - t1

    pool_window = resolve_pool_window(cfg)

    def new_store(ledger_path=None):
        return SparseCubeStore(
            scene_origin=np.asarray(bbox_min, np.float64), voxel_size_mm=s,
            cube_size=D, stride=cfg.voxel.stride, ledger_path=ledger_path,
            occupancy_vote=0.0 if pool_window > 0 else 0.5,
        )

    store = new_store(ledgers[b_me]) if c_me == 0 else None
    leader = int(mesh.devices[b_me, 0])
    step = sweep_step(cfg, gather_images(images_t, gdt),
                      torch.as_tensor(np.asarray(Ps), dtype=torch.float32,
                                      device=dev),
                      predictor, pool_window)
    counts = [0, 0]  # this rank's cubes swept, non-empty

    def dispatch(rows):
        padded = np.concatenate([rows, rows[:1].repeat(B - len(rows))])
        stats.n_batches += 1
        return padded, step(*plan.batch(padded, dev), compact_output=True)

    def harvest(rows, sent):
        results = []
        if sent is not None:
            occ, fused, color, n_short, n_dense = harvest_batch(
                step, plan, sent[0], len(rows), sent[1], dev, D)
            if n_short:
                print(f"sharded sweep: block {b_me}: {n_short} cube(s) "
                      f"short of their occupied count (compact_k="
                      f"{resolve_compact_k(cfg.sweep.compact_k, D)}); "
                      f"re-fetching them dense", flush=True)
            stats.n_refetched += n_short
            stats.n_refetch_batches += n_dense
            for i, r in enumerate(rows):
                results.append(CubeResult(tuple(int(v) for v in plan.grid[r]),
                                          occ[i], fused[i], color[i]))
                counts[1] += bool(occ[i].any())
            counts[0] += len(rows)
        if n_cube > 1:  # the row's first rank writes the row's results
            got = [None] * n_cube if c_me == 0 else None
            dist.gather_object([_sparse(x) for x in results], got,
                               dst=leader, group=mesh.row_group)
            if c_me == 0:
                results = [_dense(x, D) for part in got for x in part]
        if store is not None:
            for res in results:
                store.add(res)

    pending = collections.deque()
    offs = np.cumsum([0] + [len(r) for r in my_rounds])
    barrier()  # the rounds' wall clock starts on every rank together
    t_loop = time.perf_counter()
    with trace("run_sweep_sharded"):
        for r in range(n_rounds):
            rows = np.arange(offs[r], offs[r + 1])
            td = time.perf_counter()
            sent = dispatch(rows) if len(rows) else None
            if measure_device_time:
                if sent is not None and dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                stats.device_s += time.perf_counter() - td
            pending.append((rows, sent))
            if len(pending) > (0 if measure_device_time else DEPTH):
                harvest(*pending.popleft())
        while pending:
            harvest(*pending.popleft())
    barrier()
    stats.wall_s = time.perf_counter() - t_loop
    tot = torch.tensor([counts[0], counts[1], stats.n_refetched],
                       dtype=torch.int64, device=dev)
    if world > 1:
        all_reduce_(tot)
    n_processed, stats.n_cubes_nonempty, stats.n_refetched = tot.tolist()
    stats.n_rounds = n_rounds
    stats.cubes_per_s = n_processed / stats.wall_s if stats.wall_s else 0.0
    stats.sweep_s = time.perf_counter() - t2
    if metrics is not None:
        if stats.n_refetched:
            metrics.count("compact_truncation_refetches", stats.n_refetched)
        metrics.count("cubes_processed", n_processed)
        metrics.gauge("sweep_wall_s", stats.wall_s)
        metrics.gauge("cubes_per_s", stats.cubes_per_s)
        metrics.gauge("n_rounds", n_rounds)
        metrics.flush(extra={
            "n_cubes_total": stats.n_cubes_total,
            "n_cubes_after_prefilter": stats.n_cubes_after_prefilter,
            "per_block_cubes": list(stats.per_block_cubes),
        })

    # merge: the block stores share the scene frame, so their cubes
    # concatenate into one store (overlap voxels get votes from the cubes
    # of both blocks)
    sources = {b_me: store} if store is not None else {}
    if world > 1 and ledger_dir is None:
        sent = None
        if store is not None:
            sent = (b_me, [_sparse(x) for x in store._cubes.values()],
                    store.done_set())
        got = [None] * world if rank == 0 else None
        dist.gather_object(sent, got, dst=0)
        if rank == 0:
            for part in got:
                if part is not None and part[0] not in sources:
                    st = new_store()
                    for rec in part[1]:
                        st._cubes[rec[0]] = _dense(rec, D)
                    st._done |= part[2]
                    sources[part[0]] = st
    elif rank == 0:
        for b in range(n_block):
            if b not in sources:
                sources[b] = new_store(ledgers[b])  # rehydrated
    merged = new_store()
    for b in sorted(sources):
        for res in sources[b]._cubes.values():
            merged.add(res)
        merged._done |= sources[b].done_set()
    return merged, stats
