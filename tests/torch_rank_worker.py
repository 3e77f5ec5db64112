"""One rank of the port's multi-process CPU tests.

    python tests/torch_rank_worker.py SUITE WORKDIR

started by ``surfacenet_tpu_torch.parallel.distributed.launch_local`` with
the torchrun environment (tests/test_torch_parallel.py,
tests/test_torch_sweep_sharded.py, tests/test_torch_train_parallel.py).
Joins the gloo process group, runs the suite's scenarios on the CPU and
writes each scenario's results to ``WORKDIR/<scenario>.rank<r>.npz``
(arrays) or ``.json``; the test then holds them against the reference
and the port's single-process runs.  Imports the port only, never JAX.
"""

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch.distributed as dist  # noqa: E402

from surfacenet_tpu_torch.config import (  # noqa: E402
    Config, FusionConfig, ModelConfig, SweepConfig, TrainConfig, VoxelConfig,
)
from surfacenet_tpu_torch.data.synthetic import make_sphere_scene  # noqa: E402
from surfacenet_tpu_torch.parallel.distributed import (  # noqa: E402
    barrier, init_distributed,
)
from surfacenet_tpu_torch.parallel.mesh import make_mesh  # noqa: E402

torch.set_num_threads(1)  # two ranks beside the suite's other workers

D, S = 16, 2.0


def sweep_config(**sweep):
    """tests/test_sweep_sharded.py's config: 16^3 cubes of 2 mm, 3 pairs,
    batches of 4."""
    return Config(
        voxel=VoxelConfig(voxel_size_mm=S, cube_size=D, overlap=4),
        fusion=FusionConfig(n_view_pairs=3, tau=0.25, gamma=0.6),
        sweep=SweepConfig(cube_batch=4, **sweep),
    )


def train_config(**train):
    kw = dict(batch_size=8, lr=1e-2, n_steps=6, seed=0, scan_chunk=3)
    kw.update(train)
    return Config(voxel=VoxelConfig(voxel_size_mm=S, cube_size=D, overlap=4),
                  model=ModelConfig.tiny(), train=TrainConfig(**kw))


def cut_ledgers(src, dst):
    """Copy each block ledger of ``src`` to ``dst`` cut to its first half
    of lines plus half of the next (a run killed mid-append)."""
    os.makedirs(dst, exist_ok=True)
    for name in sorted(os.listdir(src)):
        with open(os.path.join(src, name)) as f:
            lines = f.readlines()
        keep = len(lines) // 2
        with open(os.path.join(dst, name), "w") as f:
            f.writelines(lines[:keep])
            f.write(lines[keep][: len(lines[keep]) // 2])


class Suite:
    def __init__(self, out, rank):
        self.out, self.rank = out, rank

    def save(self, name, **arrays):
        np.savez(os.path.join(self.out, f"{name}.rank{self.rank}.npz"),
                 **arrays)

    def save_json(self, name, obj):
        with open(os.path.join(self.out, f"{name}.rank{self.rank}.json"),
                  "w") as f:
            json.dump(obj, f)

    def save_store(self, name, store, stats):
        pts, probs, cols = store.merge()
        self.save(name, points=pts, probs=probs, colors=cols,
                  done=np.array(sorted(store.done_set())).reshape(-1, 3))
        self.save_json(name, {
            k: getattr(stats, k) for k in (
                "n_cubes_total", "n_cubes_after_prefilter",
                "n_cubes_nonempty", "n_batches", "n_refetched", "n_rounds",
                "per_block_cubes", "n_refetch_batches")})


def suite_parallel(s: Suite):
    from surfacenet_tpu_torch.models.surfacenet import (
        BN_EPS, BN_MOMENTUM, _batchnorm,
    )
    from surfacenet_tpu_torch.parallel.halo import halo_exchange

    m1, m2 = make_mesh(), make_mesh(2)
    try:
        make_mesh(3)
        err = None
    except ValueError as e:
        err = str(e)
    s.save_json("mesh", {
        "m1_shape": list(m1.shape), "m1_row_group": m1.row_group is not None,
        "m1_cube": m1.cube, "m2_shape": list(m2.shape), "m2_block": m2.block,
        "m2_row_group": m2.row_group is not None, "error": err,
        "backend": dist.get_backend()})
    for halo in (1, 2):
        vol = torch.arange(16 * 4 * 4, dtype=torch.float32).reshape(16, 4, 4)
        local = vol[m2.block * 8:(m2.block + 1) * 8]
        s.save(f"halo{halo}", out=halo_exchange(m2, local, halo).numpy())

    gen = torch.Generator().manual_seed(0)
    x = (torch.randn(4, 6, 5, 5, 5, generator=gen) * 2.0 + 0.5)
    dy = torch.randn(4, 6, 5, 5, 5, generator=gen)
    bn = torch.nn.BatchNorm3d(6, eps=BN_EPS, momentum=BN_MOMENTUM)
    with torch.no_grad():
        bn.weight.copy_(torch.rand(6, generator=gen) + 0.5)
        bn.bias.copy_(torch.randn(6, generator=gen))
    rows = slice(2 * s.rank, 2 * s.rank + 2)
    xl = x[rows].contiguous(memory_format=torch.channels_last_3d)
    xl.requires_grad_(True)
    y = _batchnorm(bn.train(), xl, dist.group.WORLD)
    (y * dy[rows]).sum().backward()
    s.save("syncbn", y=y.detach().numpy(), dx=xl.grad.numpy(),
           running_mean=bn.running_mean.numpy(),
           running_var=bn.running_var.numpy(),
           dweight=bn.weight.grad.numpy(), dbias=bn.bias.grad.numpy())


def suite_sweep(s: Suite):
    import dataclasses

    from surfacenet_tpu_torch import cli
    from surfacenet_tpu_torch.parallel.sweep_sharded import run_sweep_sharded
    from surfacenet_tpu_torch.pipeline.sweep import photoconsistency_predictor

    sc = make_sphere_scene(n_views=8, hw=(120, 160))

    def sweep(cfg, mesh, ledger_dir=None):
        return run_sweep_sharded(sc.images, sc.Ps, sc.bbox_min, sc.bbox_max,
                                 cfg, photoconsistency_predictor, mesh=mesh,
                                 ledger_dir=ledger_dir, device="cpu")

    cfg = sweep_config()
    m2, m1 = make_mesh(2), make_mesh(1)
    s.save_store("blocks2", *sweep(cfg, m2))
    s.save_store("row", *sweep(cfg, m1, os.path.join(s.out, "row_ledgers")))
    full = os.path.join(s.out, "ledgers")
    s.save_store("ledgered", *sweep(cfg, m2, full))
    if s.rank == 0:
        cut_ledgers(full, os.path.join(s.out, "ledgers_cut"))
    barrier()
    s.save_store("resumed",
                 *sweep(cfg, m2, os.path.join(s.out, "ledgers_cut")))
    s.save_store("from_jax",
                 *sweep(cfg, m2, os.path.join(s.out, "jax_ledgers")))
    s.save_store("refetch", *sweep(dataclasses.replace(
        cfg, sweep=dataclasses.replace(cfg.sweep, compact_k=8)), m2))
    s.save_store("consensus", *sweep(dataclasses.replace(
        cfg, fusion=dataclasses.replace(cfg.fusion,
                                        fusion_mode="consensus")), m2))
    with open(os.path.join(s.out, "cli_args.json")) as f:
        argv = json.load(f)
    report, runs = cli.main(argv)
    s.save_json("reconstruct_all", {
        "report": report,
        "n_batches": {k: v[0].n_batches for k, v in runs.items()}})


def suite_train(s: Suite):
    from surfacenet_tpu_torch.data.scene import PointCloudScene
    from surfacenet_tpu_torch.models.convert import load_npz
    from surfacenet_tpu_torch.train import train_surface as tt

    sc = make_sphere_scene(n_views=4, hw=(90, 120))
    mesh = make_mesh()

    def state_arrays(state):
        return {k: v.detach().numpy() for k, v in
                state.model.state_dict().items()}

    state, log = tt.train_surfacenet(sc, train_config(), mesh=mesh,
                                     log_every=1, device="cpu")
    s.save("mesh", losses=np.array(log.losses), **state_arrays(state))
    pc = PointCloudScene(sc.images, sc.Ps, sc.surface_points(3000))
    state, log = tt.train_surfacenet(
        pc, train_config(n_steps=3, pool_size=32, pool_refresh_steps=2),
        mesh=mesh, log_every=1, device="cpu")
    s.save("pool", losses=np.array(log.losses), **state_arrays(state))

    with np.load(os.path.join(s.out, "step_batch.npz")) as z:
        batch = {k: z[k] for k in z.files}
    cfg = train_config(batch_size=8, weight_decay=1e-2)
    state = tt.create_train_state(cfg, device="cpu")
    state.model.load_state_dict(load_npz(os.path.join(s.out,
                                                      "step_init.npz")))
    state.group = mesh.group
    loss = tt.train_step(
        state, torch.as_tensor(sc.images, dtype=torch.float32),
        torch.as_tensor(sc.Ps, dtype=torch.float32),
        torch.as_tensor(batch["origins"]), torch.as_tensor(batch["pairs"]),
        torch.as_tensor(batch["labels"]), None, D=D, s=S, balanced=True,
        center_colors=True)
    s.save("step", loss=loss.numpy(), **state_arrays(state))

    errors = {}
    small = make_sphere_scene(n_views=4, hw=(60, 80))
    for name, scene, cfg in (
        ("multiple", small, train_config(batch_size=3, scan_chunk=2)),
        ("scan_path", small, train_config(scan_chunk=0)),
        ("samplable", [small, sc], train_config()),
    ):
        try:
            tt.train_surfacenet(scene, cfg, n_steps=2, mesh=mesh,
                                device="cpu")
            errors[name] = None
        except ValueError as e:
            errors[name] = str(e)
    s.save_json("validate", errors)


SUITES = {"parallel": suite_parallel, "sweep": suite_sweep,
          "train": suite_train}


def run_suite(suite: str, workdir: str, timeout_s: float = 300):
    """Run ``suite`` as 2 gloo ranks in subprocesses: their outputs; raises
    when a rank fails or the time runs out (the ranks are then killed)."""
    from surfacenet_tpu_torch.parallel.distributed import launch_local

    return launch_local([sys.executable, os.path.abspath(__file__), suite,
                         str(workdir)], 2, timeout_s)


def load(workdir, name, rank, ext="npz"):
    """A scenario's results on ``rank``: its .npz as a dict, or its .json."""
    path = os.path.join(str(workdir), f"{name}.rank{rank}.{ext}")
    if ext == "json":
        with open(path) as f:
            return json.load(f)
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def main():
    suite, out = sys.argv[1], sys.argv[2]
    if not init_distributed(device="cpu"):
        raise SystemExit("no process group requested (run with the "
                         "torchrun environment)")
    try:
        SUITES[suite](Suite(out, dist.get_rank()))
        barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
