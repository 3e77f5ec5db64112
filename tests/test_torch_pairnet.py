"""Port parity: the pair net, its converted weights, triplet sampling,
training and the ``train-pairnet`` / ``reconstruct --pairnet`` CLI.

The shipped ``weights/pairnet_10000`` and ``weights/pairnet_1500`` (the
reference's Orbax checkpoints) restore on the JAX side;
``weights_torch/pairnet_{10000,1500}.npz`` are their conversions.
Bounds: embeddings within 1e-5; triplet batches bitwise; three training
steps' parameter updates within 1e-4 of the reference's (relative, per
tensor, in norm) and losses within 1e-5.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.training import train_state

import surfacenet_tpu.train.train_pair as J
import surfacenet_tpu_torch.train.train_pair as T
from surfacenet_tpu.config import Config
from surfacenet_tpu_torch.config import Config as TConfig
from surfacenet_tpu_torch.models.convert import (
    load_npz, pairnet_params_from_jax,
)
from surfacenet_tpu_torch.models.pairnet import (
    PairNet, embedding_similarity, init_pairnet, triplet_loss,
    view_similarity_matrix,
)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED = os.path.join(ROOT, "weights_torch", "pairnet_10000.npz")


@pytest.fixture(scope="module")
def shipped():
    """(flax model, numpy variables, port PairNet) of ``pairnet_10000``."""
    model, variables = J.restore_pairnet(
        os.path.join(ROOT, "weights", "pairnet_10000"), Config())
    variables = jax.tree_util.tree_map(np.asarray, variables)
    return model, variables, T.restore_pairnet(SHIPPED,
                                               TConfig().pairnet)


@pytest.mark.parametrize("step", [10000, 1500],
                         ids=["pairnet_10000", "pairnet_1500"])
def test_shipped_npz_is_a_fresh_conversion(step):
    """Each shipped ``weights_torch/pairnet_<step>.npz`` is its Orbax
    ``weights/pairnet_<step>`` converted afresh, bitwise."""
    _, variables = J.restore_pairnet(
        os.path.join(ROOT, "weights", f"pairnet_{step}"), Config())
    variables = jax.tree_util.tree_map(np.asarray, variables)
    path = os.path.join(ROOT, "weights_torch", f"pairnet_{step}.npz")
    fresh = pairnet_params_from_jax(variables)
    stored = load_npz(path)
    assert sorted(fresh) == sorted(stored)
    for k in fresh:
        assert fresh[k].dtype == stored[k].dtype == torch.float32
        assert torch.equal(fresh[k], stored[k]), k
    assert sum(v.numel() for v in stored.values()) == 224384
    net = T.restore_pairnet(path, TConfig().pairnet)
    assert isinstance(net, PairNet) and not net.training


def test_shipped_embeddings_match_reference(shipped):
    model, variables, net = shipped
    x = np.random.default_rng(0).uniform(size=(48, 32, 32, 3))
    x = x.astype(np.float32)
    ej = np.asarray(model.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        et = net(torch.tensor(x)).numpy()
    assert np.abs(et - ej).max() <= 1e-5
    np.testing.assert_allclose(np.linalg.norm(et, axis=-1), 1.0, atol=1e-6)


def test_losses_and_similarities_match_reference():
    from surfacenet_tpu.models import pairnet as JP

    rng = np.random.default_rng(1)
    e = rng.normal(size=(3, 16, 8)).astype(np.float32)
    e /= np.linalg.norm(e, axis=-1, keepdims=True)
    np.testing.assert_allclose(
        triplet_loss(*torch.tensor(e), margin=0.5).item(),
        float(JP.triplet_loss(*jnp.asarray(e), margin=0.5)), rtol=1e-6)
    np.testing.assert_allclose(
        embedding_similarity(torch.tensor(e[0]), torch.tensor(e[1])).numpy(),
        np.asarray(JP.embedding_similarity(jnp.asarray(e[0]),
                                           jnp.asarray(e[1]))), atol=1e-7)


@pytest.mark.parametrize("with_valid", [False, True])
def test_view_similarity_matrix_matches_reference(shipped, with_valid):
    from surfacenet_tpu.models.pairnet import (
        view_similarity_matrix as j_sim,
    )

    model, variables, net = shipped
    rng = np.random.default_rng(2)
    patches = rng.uniform(size=(4, 5, 32, 32, 3)).astype(np.float32)
    valid = rng.uniform(size=(4, 5)) > 0.4 if with_valid else None
    valid = None if valid is None else valid & (np.arange(4) != 3)[:, None]
    ref = np.asarray(j_sim(model, variables, jnp.asarray(patches),
                           None if valid is None else jnp.asarray(valid)))
    got = view_similarity_matrix(
        net, torch.tensor(patches),
        None if valid is None else torch.tensor(valid), chunk=7).numpy()
    assert np.abs(got - ref).max() <= 1e-5
    if with_valid:  # view 3 has no valid probe: neutral 1 everywhere
        np.testing.assert_array_equal(got[3], 1.0)


def test_extract_patches_matches_reference():
    rng = np.random.default_rng(3)
    images = rng.uniform(size=(3, 40, 50, 3)).astype(np.float32)
    n = 64
    # centres on and off the image, and exact .5 ties (numpy's half-even)
    uv = np.stack([rng.uniform(-20, 70, n), rng.uniform(-20, 60, n)], -1)
    uv[:8] = np.floor(uv[:8]) + 0.5
    uv = uv.astype(np.float32)
    views = rng.integers(0, 3, n)
    for size in (8, 9, 32):
        ref = J.extract_patches(images, views, uv, size)
        got = T.extract_patches(torch.tensor(images), views,
                                torch.tensor(uv), size).numpy()
        np.testing.assert_array_equal(got, ref)


@pytest.fixture(scope="module")
def occluded():
    from surfacenet_tpu.data.synthetic import make_occluded_scene

    return make_occluded_scene(n_views=12, hw=(120, 160))


@pytest.mark.parametrize("scene_name,hard", [("sphere", 0.0),
                                             ("occluded", 0.3)])
def test_sample_triplets_bitwise(sphere_scene, occluded, scene_name, hard):
    scene = sphere_scene if scene_name == "sphere" else occluded
    cfg, tcfg = Config(), TConfig()
    for seed in range(3):
        ref = J.sample_triplets(scene, cfg, np.random.default_rng(seed),
                                batch=12, hard_negative_frac=hard)
        got = T.sample_triplets(scene, tcfg, np.random.default_rng(seed),
                                batch=12, hard_negative_frac=hard)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="at least 2"):
        T.sample_triplets(scene, tcfg, np.random.default_rng(0), batch=1)


def test_three_train_steps_match_reference(shipped, sphere_scene):
    """From the converted weights on the same triplets, three Adam steps:
    each parameter's update (after - before) within 1e-4 of the
    reference's, relative in norm; losses within 1e-5."""
    model, variables, _ = shipped
    cfg = Config()
    anc, pos, neg = J.sample_triplets(sphere_scene, cfg,
                                      np.random.default_rng(4), batch=16)
    state = train_state.TrainState.create(
        apply_fn=model.apply, params=variables["params"],
        tx=optax.adam(1e-3))
    j_losses = []
    for _ in range(3):
        state, loss = J.pair_train_step(state, anc, pos, neg, margin=0.5)
        j_losses.append(float(loss))
    j_after = pairnet_params_from_jax(
        {"params": jax.tree_util.tree_map(np.asarray, state.params)})

    net = T.restore_pairnet(SHIPPED, TConfig().pairnet).train()
    before = {k: v.clone() for k, v in net.state_dict().items()}
    opt = T.make_optimizer(net, 1e-3)
    t_losses = [
        T.pair_train_step(net, opt, torch.tensor(anc), torch.tensor(pos),
                          torch.tensor(neg), margin=0.5).item()
        for _ in range(3)
    ]
    np.testing.assert_allclose(t_losses, j_losses, atol=1e-5)
    assert j_losses[-1] != j_losses[0]
    for k, p in net.state_dict().items():
        du_t = (p - before[k]).numpy()
        du_j = (j_after[k] - before[k]).numpy()
        rel = np.linalg.norm(du_t - du_j) / np.linalg.norm(du_j)
        assert rel <= 1e-4, (k, rel)


def test_train_pairnet_and_checkpoints(tmp_path, sphere_scene):
    tcfg = TConfig()
    tcfg = tcfg.replace(
        pairnet=dataclasses.replace(tcfg.pairnet, channels=(8,),
                                    embed_dim=8, patch_size=16),
        train=dataclasses.replace(tcfg.train, batch_size=8))
    model, losses = T.train_pairnet([sphere_scene, sphere_scene], tcfg,
                                    n_steps=4, lr=3e-3, device="cpu")
    assert len(losses) == 4 and np.isfinite(losses).all()
    T.save_pairnet(str(tmp_path), model, step=2)
    T.save_pairnet(str(tmp_path), model, step=10)
    back = T.restore_pairnet(str(tmp_path), tcfg.pairnet)
    for k, v in model.state_dict().items():
        assert torch.equal(back.state_dict()[k], v)
    assert os.path.isfile(tmp_path / "pairnet_10.npz")
    T.restore_pairnet(str(tmp_path), tcfg.pairnet, step=2)
    with pytest.raises(RuntimeError):  # widths that do not fit the file
        T.restore_pairnet(str(tmp_path / "pairnet_2.npz"), TConfig().pairnet)
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        T.restore_pairnet(str(tmp_path / "empty"), tcfg.pairnet)
    # init: flax's distribution, zero biases, reproducible from the seed
    a = init_pairnet(tcfg.pairnet, torch.Generator().manual_seed(0))
    b = init_pairnet(tcfg.pairnet, torch.Generator().manual_seed(0))
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y)
        if k.endswith("bias"):
            assert not x.any()


def test_cli_train_pairnet_then_reconstruct(tmp_path):
    from surfacenet_tpu_torch import cli
    from surfacenet_tpu_torch.data.dtu import write_scan
    from surfacenet_tpu_torch.data.synthetic import make_occluded_scene

    ck = str(tmp_path / "ck")
    model, losses = cli.main(["train-pairnet", "--steps", "3", "--device",
                              "cpu", "--checkpoint-dir", ck,
                              "--set", "train.batch_size=8"])
    assert os.path.isfile(os.path.join(ck, "pairnet_3.npz"))
    assert len(losses) == 3 and np.isfinite(losses).all()

    sc = make_occluded_scene(n_views=6, hw=(96, 128))
    scan = str(tmp_path / "scan")
    write_scan(scan, sc.images, sc.Ps, sc.bbox_min, sc.bbox_max)
    base = ["reconstruct", "--scan", scan, "--device", "cpu",
            "--set", "voxel.cube_size=16", "--set", "voxel.voxel_size_mm=2.0",
            "--set", "voxel.overlap=4", "--set", "fusion.n_view_pairs=2",
            "--set", "fusion.tau=0.25", "--set", "sweep.cube_batch=8"]
    for extra in (["--pairnet", os.path.join(ck, "pairnet_3.npz")],
                  ["--pairnet", ck, "--set",
                   'fusion.fusion_mode="consensus"']):
        out = str(tmp_path / "o.ply")
        n, stats, _ = cli.main(base + ["--out", out] + extra)
        assert n > 50 and os.path.isfile(out)
    with pytest.raises(FileNotFoundError):
        cli.main(base + ["--out", out, "--pairnet",
                         str(tmp_path / "missing.npz")])
    # the sharded sweep on one device: the reference's exit unless
    # --allow-unsharded (tests/test_torch_cli.py drives both)
    with pytest.raises(SystemExit, match="--allow-unsharded"):
        cli.main(base + ["--out", out, "--pairnet", SHIPPED,
                         "--set", "mesh.block_axis=2"])


def test_pairnet_entry_points_refuse_missing_cuda(sphere_scene, monkeypatch):
    """Without a card, the new entry points raise unless the CPU is asked
    for; nothing falls back to the CPU."""
    from surfacenet_tpu_torch import cli
    from surfacenet_tpu_torch.ops.view_pairs import (
        select_pairs_learned_local,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TConfig()
    net = T.restore_pairnet(SHIPPED, cfg.pairnet)
    hw = sphere_scene.images.shape[1:3]
    calls = [
        lambda: cli.main(["train-pairnet", "--steps", "1"]),
        lambda: T.train_pairnet(sphere_scene, cfg, n_steps=1),
        lambda: cli.make_pair_selector(SHIPPED, cfg, sphere_scene.images),
        lambda: select_pairs_learned_local(
            sphere_scene.Ps, np.zeros((1, 3)), 2, hw, 32.0,
            sphere_scene.images, net, 32),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
