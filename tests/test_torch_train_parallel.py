"""Port parity: data-parallel training over 2 gloo ranks on the CPU.

The port's ranks run in subprocesses (tests/torch_rank_worker.py, one
launch for the scenarios, one for ``python -m surfacenet_tpu_torch.cli
train --sharded``, each killed if it outlives its timeout).  The tiny
model, 16^3 cubes of 2 mm, batch 8 (4 a rank), float32.  Bounds:

  * ``train_surfacenet(mesh=...)`` against one process on the same scene
    and config (analytic scan path, 6 steps in chunks of 3; pool path, 3
    steps with a refresh): losses within 1e-3 and parameters within 1e-4,
    the reference's bounds for its mesh driver
    (tests/test_parallel.py::test_train_surfacenet_mesh_driver), and
    BatchNorm running statistics within 1e-5;
  * one data-parallel ``train_step`` on the reference's batch and initial
    weights against the reference's step sharded over its 8-device mesh:
    parameters and running statistics within 1e-5, the loss within 2e-4
    relative (tests/test_torch_train.py's bounds for the one-device step);
  * the reference's validation messages;
  * ``cli train --sharded`` against ``cli train``: the checkpoints'
    parameters within 1e-4.
"""

import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surfacenet_tpu.config import Config as JConfig
from surfacenet_tpu_torch.models.convert import (
    load_npz, params_from_jax, save_npz,
)
from surfacenet_tpu_torch.parallel.distributed import launch_local
from surfacenet_tpu_torch.train import train_surface as tt
from torch_rank_worker import D, S, load, run_suite, train_config

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _state(state):
    return {k: v.detach().numpy() for k, v in
            state.model.state_dict().items()}


def _close(got, want, params_tol, stats_tol=1e-5):
    for k, v in want.items():
        tol = stats_tol if "running" in k else params_tol
        assert np.abs(got[k] - v).max() <= tol, k


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's sharded step's inputs written for the ranks, then the
    ``train`` suite as 2 ranks; with the reference's step's result."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from surfacenet_tpu.data.synthetic import make_sphere_scene
    from surfacenet_tpu.parallel.mesh import make_mesh
    from surfacenet_tpu.train.train_surface import (
        create_train_state, sample_training_batch, train_step,
    )

    out = tmp_path_factory.mktemp("train")
    sc = make_sphere_scene(n_views=4, hw=(90, 120))
    jcfg = JConfig.from_json(train_config(weight_decay=1e-2).to_json())
    origins, pairs, labels = sample_training_batch(
        sc, jcfg, np.random.default_rng(0))
    np.savez(out / "step_batch.npz", origins=origins, pairs=pairs,
             labels=labels)
    _, st = create_train_state(jcfg, jax.random.PRNGKey(0))

    def state_dict(s):
        return params_from_jax(jax.tree_util.tree_map(
            np.asarray, {"params": s.params, "batch_stats": s.batch_stats}))

    save_npz(state_dict(st), str(out / "step_init.npz"))
    mesh = make_mesh()
    shard = NamedSharding(mesh, P(mesh.axis_names))
    rep = NamedSharding(mesh, P())
    st, loss = train_step(
        jax.device_put(st, rep),
        jax.device_put(jnp.asarray(sc.images, jnp.float32), rep),
        jax.device_put(jnp.asarray(sc.Ps, jnp.float32), rep),
        *(jax.device_put(jnp.asarray(a), shard)
          for a in (origins, pairs, labels)),
        D=D, s=S, balanced=True, center_colors=True)
    run_suite("train", out, timeout_s=300)
    return dict(out=out, step=(float(loss), {
        k: v.numpy() for k, v in state_dict(st).items()}))


@pytest.mark.parametrize("path", ["mesh", "pool"])
def test_train_surfacenet_mesh_matches_one_process(runs, path):
    from surfacenet_tpu_torch.data.scene import PointCloudScene
    from surfacenet_tpu_torch.data.synthetic import make_sphere_scene

    sc = make_sphere_scene(n_views=4, hw=(90, 120))
    if path == "mesh":
        cfg = train_config()
    else:
        sc = PointCloudScene(sc.images, sc.Ps, sc.surface_points(3000))
        cfg = train_config(n_steps=3, pool_size=32, pool_refresh_steps=2)
    state, log = tt.train_surfacenet(sc, cfg, log_every=1, device="cpu")
    want = _state(state)
    for r in (0, 1):
        got = load(runs["out"], path, r)
        assert len(got["losses"]) == len(log.losses) == cfg.train.n_steps
        assert np.abs(got["losses"] - np.array(log.losses)).max() <= 1e-3
        _close(got, want, 1e-4)


def test_data_parallel_train_step_matches_reference(runs):
    """Every rank passes the reference's global batch of 8; each runs its
    4 rows, BatchNorm and the loss over all 8."""
    loss, want = runs["step"]
    for r in (0, 1):
        got = load(runs["out"], "step", r)
        assert abs(float(got["loss"]) - loss) <= 2e-4 * abs(loss)
        _close(got, want, 1e-5)


def test_mesh_training_validations(runs):
    """The reference's checks and messages, on a mesh of 2 ranks."""
    from surfacenet_tpu.config import ModelConfig, TrainConfig, VoxelConfig
    from surfacenet_tpu.data.synthetic import make_sphere_scene
    from surfacenet_tpu.parallel.mesh import make_mesh
    from surfacenet_tpu.train.train_surface import train_surfacenet

    got = load(runs["out"], "validate", 0, "json")
    assert got == load(runs["out"], "validate", 1, "json")
    assert got == {
        "multiple": "batch_size=3 must be a multiple of the 2-device mesh",
        "scan_path": "mesh training requires the scan path "
                     "(train.scan_chunk > 0)",
        "samplable": "mesh training requires a device-samplable scene",
    }
    scene = make_sphere_scene(n_views=4, hw=(60, 80))
    cfg = JConfig(voxel=VoxelConfig(voxel_size_mm=2.0, cube_size=16,
                                    overlap=4),
                  model=ModelConfig.tiny(),
                  train=TrainConfig(batch_size=3, scan_chunk=2))
    with pytest.raises(ValueError) as want:
        train_surfacenet(scene, cfg, n_steps=2, mesh=make_mesh())
    assert str(want.value) == got["multiple"].replace("2-device", "8-device")


def test_cli_train_sharded_matches_cli_train(tmp_path):
    """``python -m surfacenet_tpu_torch.cli train --sharded`` as 2 ranks
    (torchrun's environment): rank 0's checkpoint against one process's."""
    from surfacenet_tpu_torch.cli import main

    tiny = ["--synthetic", "sphere", "--steps", "6", "--device", "cpu",
            "--set", "voxel.cube_size=16", "--set", "voxel.voxel_size_mm=2.0",
            "--set", "voxel.overlap=4",
            "--set", "model.block_channels=[8,12,16,16]",
            "--set", "model.convs_per_block=[1,1,1,1]",
            "--set", "model.side_channels=4", "--set", 'model.dtype="float32"',
            "--set", "train.batch_size=4", "--set", "train.scan_chunk=3"]
    ck2, ck1 = tmp_path / "dp", tmp_path / "one"
    outs = launch_local([sys.executable, "-m", "surfacenet_tpu_torch.cli",
                         "train", "--sharded", "--checkpoint-dir", str(ck2),
                         *tiny], 2, 180, cwd=REPO)
    assert "backend gloo" in outs[0]
    assert all("trained steps 0..6" in o for o in outs)
    assert os.listdir(ck2) == ["step_6"]
    _, log = main(["train", "--checkpoint-dir", str(ck1), *tiny])
    got = load_npz(str(ck2 / "step_6" / "model.npz"))
    want = load_npz(str(ck1 / "step_6" / "model.npz"))
    _close({k: v.numpy() for k, v in got.items()},
           {k: v.numpy() for k, v in want.items()}, 1e-4)
    last = float(re.search(r"-> ([-0-9.]+)", outs[0]).group(1))
    assert abs(last - log.losses[-1]) <= 1e-3
