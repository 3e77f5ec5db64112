"""Port parity: SurfaceNet training (``surfacenet_tpu_torch/train/``).

The same numpy inputs through the reference's functions and the port's,
on the CPU (the reference on its XLA CPU backend, no Pallas), with the
tiny model, 16^3 cubes of 2 mm and batch 4.  Bounds:

  * ``class_balanced_bce``: rtol 1e-6 against the reference's formula in
    float64, 5e-6 against the reference (its float32 sums are off the
    float64 value by up to 2.1e-6 relative here, the port's by 1e-8);
  * ``build_cvc_batch``: validity equal, |x diff| <= 1e-4, the gather's
    float32 bound against the XLA oracle (tests/test_torch_cvc.py): the
    uncentred views themselves differ by up to ~2.2e-5 here;
  * host sampler and pool labels: bitwise; pairs equal;
  * three ``train_step``s on the reference's batches (weight decay 1e-2,
    so that leaving it out moves a BatchNorm scale by 1e-4 at step 1),
    float32: parameters and BatchNorm running statistics within 1e-5
    after every step (~6e-7 measured), losses within 2e-4 relative.  The
    loss is held wider than the parameters because the reference's
    float32 reductions over the 16384 voxels of a batch are ~100x less
    exact than PyTorch's: on these inputs its batch variance is off
    float64 by up to 1.2e-5 relative and its mean by 2.6e-6 standard
    deviations, the port's by ~1e-7, and eight BatchNorm layers carry
    that into the loss (8.9e-5 relative at step 1);
  * bf16: losses within 1e-2 relative, parameters within 1e-3, except the
    head's bias, whose reference gradient is a sum of 16384 bf16 terms
    that XLA's CPU backend accumulates in bf16 (5x off its float32
    value after three steps): the port's, summed in float32, is held
    against the reference's float32 run within 1e-4.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surfacenet_tpu.config import Config as JConfig
from surfacenet_tpu.config import ModelConfig as JModel
from surfacenet_tpu.config import TrainConfig as JTrain
from surfacenet_tpu.config import VoxelConfig as JVoxel
from surfacenet_tpu_torch.cli import main as cli_main
from surfacenet_tpu_torch.config import Config, ModelConfig, TrainConfig
from surfacenet_tpu_torch.config import VoxelConfig
from surfacenet_tpu_torch.data.scene import PointCloudScene
from surfacenet_tpu_torch.data.synthetic import (
    make_sphere_scene, make_tori_scene,
)
from surfacenet_tpu_torch.models.convert import load_npz, params_from_jax
from surfacenet_tpu_torch.ops.cuda.warp_gather import build_cvc_batch_cuda
from surfacenet_tpu_torch.ops.cvc import build_cvc_batch
from surfacenet_tpu_torch.train import train_surface as tt
from surfacenet_tpu_torch.train.losses import class_balanced_bce

torch.set_num_threads(2)

D, S = 16, 2.0
TINY = [
    "--set", "voxel.cube_size=16", "--set", "voxel.voxel_size_mm=2.0",
    "--set", "voxel.overlap=4", "--set", "model.block_channels=[8,12,16,16]",
    "--set", "model.convs_per_block=[1,1,1,1]",
    "--set", "model.side_channels=4", "--set", 'model.dtype="float32"',
    "--set", "train.batch_size=4", "--set", "train.scan_chunk=3",
]


# the step-parity tests' weight decay: at lr 1e-2 a trainer without it
# is 1e-4 off in every BatchNorm scale (1.0) after one step, ten times
# their 1e-5 bound (the default 1e-4 would be 1e-6, inside it)
WD_PARITY = 1e-2


def _cfgs(dtype="float32", **train):
    """The same tiny config in both packages."""
    kw = dict(batch_size=4, lr=1e-2, n_steps=30, seed=0, scan_chunk=0)
    kw.update(train)
    return (
        JConfig(voxel=JVoxel(voxel_size_mm=S, cube_size=D, overlap=4),
                model=dataclasses.replace(JModel.tiny(), dtype=dtype),
                train=JTrain(**kw)),
        Config(voxel=VoxelConfig(voxel_size_mm=S, cube_size=D, overlap=4),
               model=dataclasses.replace(ModelConfig.tiny(), dtype=dtype),
               train=TrainConfig(**kw)),
    )


@pytest.fixture(scope="module")
def scenes():
    """The 4-view test sphere of both packages (bit-identical)."""
    from surfacenet_tpu.data.synthetic import make_sphere_scene as j_sphere

    return (j_sphere(n_views=4, hw=(90, 120)),
            make_sphere_scene(n_views=4, hw=(90, 120)))


@pytest.fixture(scope="module")
def batches(scenes):
    """Three host batches from the reference's sampler, seed 0."""
    from surfacenet_tpu.train.train_surface import sample_training_batch

    jc, _ = _cfgs()
    rng = np.random.default_rng(0)
    return [sample_training_batch(scenes[0], jc, rng) for _ in range(3)]


def _state_dict(jstate):
    return params_from_jax(jax.tree_util.tree_map(
        np.asarray, {"params": jstate.params,
                     "batch_stats": jstate.batch_stats}))


@pytest.fixture(scope="module")
def reference_run(scenes, batches):
    """The reference's initial weights and three ``train_step``s per
    dtype: (initial state dict, [(loss, state dict after the step)])."""
    from surfacenet_tpu.train.train_surface import (
        create_train_state, train_step,
    )

    runs = {}

    def get(dtype):
        if dtype not in runs:
            jc, _ = _cfgs(dtype, weight_decay=WD_PARITY)
            _, st = create_train_state(jc, jax.random.PRNGKey(0))
            init = _state_dict(st)
            steps = []
            sc = scenes[0]
            for o, p, lab in batches:
                st, loss = train_step(
                    st, jnp.asarray(sc.images, jnp.float32),
                    jnp.asarray(sc.Ps, jnp.float32), jnp.asarray(o),
                    jnp.asarray(p), jnp.asarray(lab), None, D=D, s=S,
                    balanced=True, center_colors=True)
                steps.append((float(loss), _state_dict(st)))
            runs[dtype] = (init, steps)
        return runs[dtype]

    return get


def _pc_scene(scene, n=4000):
    return PointCloudScene(images=scene.images, Ps=scene.Ps,
                           gt_points=scene.surface_points(n, seed=3))


@pytest.mark.parametrize("balanced", [True, False])
@pytest.mark.parametrize("with_valid", [True, False])
def test_class_balanced_bce_matches_reference(balanced, with_valid):
    from surfacenet_tpu.train.losses import class_balanced_bce as j_bce

    rng = np.random.default_rng(1)
    logits = rng.normal(0, 3, (2, 6, 6, 6)).astype(np.float32)
    labels = (rng.uniform(size=logits.shape) < 0.05).astype(np.float32)
    valid = rng.uniform(size=logits.shape) < 0.8 if with_valid else None
    ref = float(j_bce(jnp.asarray(logits), jnp.asarray(labels),
                      None if valid is None else jnp.asarray(valid),
                      balanced))
    got = class_balanced_bce(
        torch.tensor(logits), torch.tensor(labels),
        None if valid is None else torch.tensor(valid), balanced)
    assert got.dtype == torch.float32
    # the reference's formula in float64
    x, v = logits.astype(np.float64), np.ones(logits.shape)
    if valid is not None:
        v = valid.astype(np.float64)
    per_vox = np.maximum(x, 0) - x * labels + np.log1p(np.exp(-np.abs(x)))
    n = max(v.sum(), 1.0)
    n_pos = (labels * v).sum()
    w = (np.where(labels > 0.5, (n - n_pos) / n, n_pos / n) * v
         if balanced else v)
    exact = (per_vox * w).sum() / w.sum()
    np.testing.assert_allclose(got.item(), exact, rtol=1e-6)
    np.testing.assert_allclose(got.item(), ref, rtol=5e-6)


@pytest.mark.parametrize("center", [True, False])
def test_build_cvc_batch_matches_reference(scenes, batches, center):
    from surfacenet_tpu.ops.cvc import build_cvc_batch as j_batch

    sc = scenes[1]
    o, p, _ = batches[0]
    xj, vj = j_batch(jnp.asarray(sc.images), jnp.asarray(sc.Ps, jnp.float32),
                     jnp.asarray(p), jnp.asarray(o), D, S, center)
    images, Ps = torch.tensor(sc.images), torch.tensor(sc.Ps,
                                                       dtype=torch.float32)
    xt, vt = build_cvc_batch(images, Ps, torch.tensor(p), torch.tensor(o),
                             D, S, center)
    assert xt.shape == (4, D, D, D, 6) and xt.dtype == torch.float32
    assert np.array_equal(vt.numpy(), np.asarray(vj))
    assert 0.2 < vt.float().mean().item() < 1.0
    assert np.abs(xt.numpy() - np.asarray(xj)).max() <= 1e-4
    # the kernel route's wrapper runs the same plain version on the CPU
    xc, vc = build_cvc_batch_cuda(images, Ps, torch.tensor(p),
                                  torch.tensor(o), D=D, s=S,
                                  center_colors=center)
    assert torch.equal(xc, xt) and torch.equal(vc, vt)


@pytest.mark.parametrize("flag", [False, True])
def test_gather_copy_is_float32_on_the_cpu(scenes, flag):
    """On the CPU the gather samples float32 images whatever
    ``sweep.use_pallas_gather`` says, as the reference's CPU backend does
    (on the card the flag picks bf16 RGBx, else float32 RGBx)."""
    _, tc = _cfgs()
    cfg = tc.replace(sweep=dataclasses.replace(tc.sweep,
                                               use_pallas_gather=flag))
    images = scenes[1].images
    for given in (images, torch.tensor(images)):
        got = tt.gather_copy(given, cfg, "cpu")
        assert got.dtype == torch.float32 and got.shape == images.shape
        assert np.array_equal(got.numpy(), images.astype(np.float32))


def test_sample_training_batch_matches_reference(scenes, batches):
    _, tc = _cfgs()
    origins, pair_idx, labels = tt.sample_training_batch(
        scenes[1], tc, np.random.default_rng(0), device="cpu")
    o, p, lab = batches[0]
    assert origins.dtype == np.float32 and pair_idx.dtype == np.int32
    assert np.array_equal(origins, o) and np.array_equal(labels, lab)
    assert np.array_equal(pair_idx, p)
    assert (labels.reshape(4, -1).sum(axis=1) > 0).all()


def test_pool_sampler_matches_reference(scenes):
    from surfacenet_tpu.data.scene import PointCloudScene as JPC
    from surfacenet_tpu.train.train_surface import make_pool_sampler

    jc, tc = _cfgs()
    js = scenes[0]
    ref = make_pool_sampler(
        JPC(images=js.images, Ps=js.Ps,
            gt_points=js.surface_points(4000, seed=3)), jc, n_pool=16)
    got = tt.make_pool_sampler(_pc_scene(scenes[1]), tc, n_pool=16,
                               device="cpu")
    assert got[2].dtype == torch.uint8 and got[2].shape == (16, D**3 // 8)
    for a, b in zip(got, ref):
        assert np.array_equal(a.numpy(), np.asarray(b))
    # unpacked on the device as the reference unpacks them
    unpacked = tt.unpack_labels(got[2], D).numpy()
    assert np.array_equal(unpacked, np.unpackbits(
        np.asarray(ref[2]), axis=1, bitorder="little").reshape(16, D, D, D))


def test_multi_scene_pool_matches_reference_and_trains(scenes):
    """Two scenes of one image shape: one pool over their stacked views,
    each scene's pairs offset by its first view; training draws from it."""
    from surfacenet_tpu.data.synthetic import make_sphere_scene as j_sphere
    from surfacenet_tpu.train.train_surface import make_pool_sampler_multi

    jc, tc = _cfgs(scan_chunk=5)
    kw = dict(n_views=4, hw=(90, 120), radius=22.0, seed=5)
    j_images, j_Ps, ref = make_pool_sampler_multi(
        [scenes[0], j_sphere(**kw)], jc, n_pool=32)
    two = [scenes[1], make_sphere_scene(**kw)]
    images, Ps, got = tt.make_pool_sampler_multi(two, tc, n_pool=32,
                                                 device="cpu")
    assert np.array_equal(images.numpy(), np.asarray(j_images))
    assert np.array_equal(Ps.numpy(), np.asarray(j_Ps))
    for a, b in zip(got, ref):
        assert np.array_equal(a.numpy(), np.asarray(b))
    pairs = got[1].numpy()
    assert (pairs[:16] < 4).all() and (pairs[16:] >= 4).all()
    state, log = tt.train_surfacenet(two, tc, n_steps=10, log_every=1,
                                     device="cpu")
    assert state.step == 10 and np.isfinite(log.losses).all()


def test_perturb_calibration_matches_reference(scenes):
    from surfacenet_tpu.train.train_surface import perturb_calibration

    Ps = jnp.asarray(scenes[0].Ps, jnp.float32)
    key = jax.random.PRNGKey(3)
    ref = np.asarray(perturb_calibration(Ps, key, 2.0))
    duv = 2.0 * np.asarray(jax.random.normal(key, (Ps.shape[0], 2)))
    got = tt.perturb_calibration(torch.tensor(np.asarray(Ps)),
                                 torch.tensor(duv))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6)
    assert not np.allclose(ref, np.asarray(Ps))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_matches_reference(scenes, batches, reference_run,
                                      dtype):
    """Three steps from the reference's weights on its batches: a wrong
    BatchNorm momentum or weight decay shows at step 1, a wrong momentum
    trace at steps 2-3."""
    init, steps = reference_run(dtype)
    _, tc = _cfgs(dtype, weight_decay=WD_PARITY)
    state = tt.create_train_state(tc, device="cpu")
    state.model.load_state_dict(init)
    sc = scenes[1]
    images = torch.tensor(sc.images)
    Ps = torch.tensor(sc.Ps, dtype=torch.float32)
    if dtype == "bfloat16":
        f32_steps = reference_run("float32")[1]
    for i, ((o, p, lab), (ref_loss, ref_sd)) in enumerate(zip(batches,
                                                               steps)):
        loss = tt.train_step(state, images, Ps, torch.tensor(o),
                             torch.tensor(p), torch.tensor(lab), D=D, s=S,
                             balanced=True, center_colors=True).item()
        assert state.step == i + 1
        got = state.model.state_dict()
        diffs = {k: (got[k].float() - ref_sd[k]).abs().max().item()
                 for k in ref_sd if "num_batches" not in k}
        if dtype == "float32":
            assert abs(loss - ref_loss) <= 2e-4 * abs(ref_loss), (i, loss)
            worst = max(diffs, key=diffs.get)
            assert diffs[worst] <= 1e-5, (i, worst, diffs[worst])
        else:
            assert abs(loss - ref_loss) <= 1e-2 * abs(ref_loss), (i, loss)
            diffs.pop("head.bias")
            worst = max(diffs, key=diffs.get)
            assert diffs[worst] <= 1e-3, (i, worst, diffs[worst])
            f32_head = f32_steps[i][1]["head.bias"]
            assert (got["head.bias"] - f32_head).abs().max().item() <= 1e-4
        # the running statistics moved, by flax's rule
        assert not torch.equal(got["blocks.0.bns.0.running_var"],
                               init["blocks.0.bns.0.running_var"])


@pytest.mark.parametrize("t", [0, 50, 100, 130])
def test_cosine_learning_rate_matches_optax(t):
    import optax

    tc = TrainConfig(lr=1e-2, n_steps=100, lr_decay="cosine")
    ref = float(optax.cosine_decay_schedule(1e-2, decay_steps=100,
                                            alpha=0.05)(t))
    np.testing.assert_allclose(tt.learning_rate(tc, t), ref, rtol=1e-6)
    assert tt.learning_rate(dataclasses.replace(tc, lr_decay="none"),
                            t) == 1e-2
    with pytest.raises(ValueError):
        tt.learning_rate(dataclasses.replace(tc, lr_decay="linear"), t)


@pytest.mark.parametrize("scene_name", ["sphere", "tori"])
def test_device_sampler_labels_follow_host_rule(scenes, scene_name):
    _, tc = _cfgs()
    sc = (scenes[1] if scene_name == "sphere"
          else make_tori_scene(n_views=6, hw=(60, 80)))
    cand_pts, cand_pairs, surf_fn, surf_params = tt.make_device_sampler(
        sc, tc, n_candidates=64, device="cpu")
    assert cand_pts.shape == (64, 3) and cand_pairs.shape[::2] == (64, 2)
    assert cand_pairs.dtype == torch.int32
    assert surf_fn(surf_params, cand_pts).max().item() < 1e-3
    origins = cand_pts[:8].numpy() - D * S / 2.0
    centers = origins[:, None, None, None, :] + tt.voxel_offsets(D, S).numpy()
    host = sc.occupancy(centers, S)
    dev = (surf_fn(surf_params, torch.tensor(centers, dtype=torch.float32))
           <= S * np.sqrt(3) / 2).numpy()
    assert (host == dev).mean() > 0.999  # float32 boundary ties only
    # a drawn batch: labels by the same rule, pairs from the table
    gen = torch.Generator().manual_seed(0)
    o, p, lab = tt.sample_device_batch(
        (cand_pts, cand_pairs, surf_fn, surf_params), gen, batch=4, D=D, s=S)
    assert o.shape == (4, 3) and p.shape == (4, 2) and lab.shape == (4, D,
                                                                      D, D)
    host = sc.occupancy(o.numpy().astype(np.float64)[:, None, None, None]
                        + tt.voxel_offsets(D, S).numpy(), S)
    assert (host == (lab.numpy() > 0.5)).mean() > 0.999
    assert (p[:, 0] != p[:, 1]).all()


@pytest.mark.parametrize("path", ["scan", "pool", "host"])
def test_training_reduces_loss(scenes, path):
    """Each of ``train_surfacenet``'s three loops learns: the analytic scan path,
    the pool path (a point-cloud scene) and the host loop."""
    _, tc = _cfgs(scan_chunk=0 if path == "host" else 10)
    sc = _pc_scene(scenes[1]) if path == "pool" else scenes[1]
    state, log = tt.train_surfacenet(sc, tc, n_steps=30, log_every=1,
                                     device="cpu")
    assert state.step == 30 and len(log.losses) == 30
    assert np.isfinite(log.losses).all()
    assert np.mean(log.losses[-5:]) < np.mean(log.losses[:5])


def test_eval_step_and_held_out_pool(scenes, batches):
    _, tc = _cfgs(scan_chunk=4, pool_size=32, pool_refresh_steps=8,
                  eval_every=6)
    state, log = tt.train_surfacenet(_pc_scene(scenes[1]), tc, n_steps=12,
                                     log_every=1, device="cpu")
    assert log.eval_steps == [4, 12] and len(log.eval_losses) == 2
    assert np.isfinite(log.eval_losses).all()
    o, p, lab = batches[2]
    sc = scenes[1]
    loss, iou = tt.eval_step(
        state, torch.tensor(sc.images), torch.tensor(sc.Ps,
                                                     dtype=torch.float32),
        torch.tensor(o), torch.tensor(p), torch.tensor(lab), D=D, s=S,
        center_colors=True)
    assert np.isfinite(loss.item()) and 0.0 <= iou.item() <= 1.0
    assert not state.model.training


def test_checkpoint_roundtrip(tmp_path, scenes):
    _, tc = _cfgs(scan_chunk=3, lr_decay="cosine")
    state, _ = tt.train_surfacenet(scenes[1], tc, n_steps=3, device="cpu")
    path = tt.save_checkpoint(str(tmp_path), state, 3)
    assert sorted(os.listdir(path)) == ["model.npz", "optim.npz"]
    restored, step = tt.restore_checkpoint(str(tmp_path), tc, device="cpu")
    assert step == 3 and restored.step == 3
    a, b = state.model.state_dict(), restored.model.state_dict()
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    bufs = [restored.optimizer.state[p]["momentum_buffer"]
            for p in restored.model.parameters()]
    assert all(torch.equal(x, state.optimizer.state[p]["momentum_buffer"])
               for x, p in zip(bufs, state.model.parameters()))
    # the inference loaders read the same file
    sd = load_npz(os.path.join(path, "model.npz"))
    assert all(torch.equal(sd[k], a[k]) for k in a)
    model = tt.load_pretrained(path, tc)
    assert not model.training and all(
        torch.equal(v, a[k]) for k, v in model.state_dict().items())


def test_cli_train_resume_continues_step_and_lr(tmp_path):
    """Six steps, then ``--resume`` to nine: the step count, the schedule
    and the checkpoint numbers continue, and the momentum buffers carry
    over."""
    ck = str(tmp_path / "ck")
    cosine = ["--set", 'train.lr_decay="cosine"', "--set",
              "train.n_steps=12"]
    args = ["train", "--synthetic", "sphere", "--device", "cpu",
            "--checkpoint-dir", ck, "--log-every", "1"] + TINY + cosine
    first, _ = cli_main(args + ["--steps", "6"])
    assert first.step == 6
    assert os.path.isfile(os.path.join(ck, "step_6", "model.npz"))
    state, log = cli_main(args + ["--steps", "9", "--resume"])
    assert state.step == 9 and log.steps == [6, 7, 8]
    assert os.path.isfile(os.path.join(ck, "step_9", "model.npz"))
    tcfg = state.train_cfg
    assert tcfg.lr_decay == "cosine"
    assert state.optimizer.param_groups[0]["lr"] == tt.learning_rate(tcfg,
                                                                     8)
    assert tt.learning_rate(tcfg, 8) < tt.learning_rate(tcfg, 0)
    assert cli_main(args + ["--steps", "9", "--resume"]) is None  # done


def test_cli_train_checkpoint_loads_into_reconstruct(tmp_path, scenes):
    """``cli train --scan --gt`` (the pool path) writes step_N/model.npz,
    which ``cli reconstruct --checkpoint`` reads unchanged."""
    from surfacenet_tpu_torch.data.dtu import write_scan
    from surfacenet_tpu_torch.utils.ply import read_ply, write_ply

    sc = scenes[1]
    scan, gt = str(tmp_path / "scan"), str(tmp_path / "gt.ply")
    write_scan(scan, sc.images, sc.Ps)
    write_ply(gt, sc.surface_points(3000))
    ck = str(tmp_path / "ck")
    state, log = cli_main(["train", "--scan", scan, "--gt", gt, "--steps",
                           "6", "--device", "cpu", "--checkpoint-dir", ck,
                           "--set", "train.pool_size=64"] + TINY)
    assert state.step == 6 and np.isfinite(log.losses).all()
    out = str(tmp_path / "out.ply")
    n, _, _ = cli_main([
        "reconstruct", "--scan", scan, "--out", out, "--device", "cpu",
        "--checkpoint", os.path.join(ck, "step_6", "model.npz"),
        "--set", "fusion.n_view_pairs=2", "--set", "fusion.tau=0.25",
        "--set", "sweep.cube_batch=8"] + TINY)
    pts, _ = read_ply(out)
    assert len(pts) == n


@pytest.mark.parametrize("flag", ["--sharded", "--allow-unsharded"])
def test_cli_train_refuses_mesh_flags(flag, scenes, tmp_path):
    """The flags this test once refused (data-parallel training was not
    ported) now train: without a process group ``--sharded`` trains on a
    mesh of one rank and ``--allow-unsharded`` alone changes nothing, so
    both give plain ``cli train``'s run; ``train_surfacenet`` on a
    one-rank mesh is the single-process run (2 ranks:
    tests/test_torch_train_parallel.py)."""
    from surfacenet_tpu_torch.parallel.mesh import make_mesh

    runs = [cli_main(["train", *extra, "--steps", "2", "--device", "cpu",
                      "--checkpoint-dir", str(tmp_path / str(i))] + TINY)
            for i, extra in enumerate(([flag], []))]
    (s1, l1), (s2, l2) = runs
    assert l1.losses == l2.losses and s1.step == s2.step == 2
    for k, v in s1.model.state_dict().items():
        assert torch.equal(v, s2.model.state_dict()[k]), k
    _, tc = _cfgs(scan_chunk=1)
    a, la = tt.train_surfacenet(scenes[1], tc, n_steps=1, mesh=make_mesh(),
                                device="cpu")
    b, lb = tt.train_surfacenet(scenes[1], tc, n_steps=1, device="cpu")
    assert la.losses == lb.losses
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k


def test_cli_train_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_main(["train", "--steps", "1", "--checkpoint-dir",
                  str(tmp_path)] + TINY)
