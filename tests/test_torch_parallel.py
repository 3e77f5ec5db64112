"""Port parity: the rank grid, the halo exchange, synchronised BatchNorm,
the affine_matmul mask, the non-deduplicated batch step, debug and viz.

The reference runs on the 8-device CPU mesh of tests/conftest.py; the
port's multi-rank parts run as 2 gloo ranks on the CPU in subprocesses
(tests/torch_rank_worker.py, one launch for the module, killed if it
outlives its timeout).  Bounds: partition, mesh shapes and messages, the
halo and the masks exact; synchronised BatchNorm within 1e-5 of full-batch
BatchNorm in one process (outputs, input gradients, running statistics,
and the ranks' weight gradients summed); the non-deduplicated step
against the reference's as tests/test_torch_sweep.py holds the
deduplicated one (occupancy >= 0.995, fused and colour within 1e-4), and
equal to the port's deduplicated step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import surfacenet_tpu.pipeline.sweep as J
import surfacenet_tpu_torch.pipeline.sweep as T
from surfacenet_tpu_torch.parallel.mesh import make_mesh
from surfacenet_tpu_torch.parallel.sweep_sharded import partition_cubes
from torch_rank_worker import load, run_suite

torch.set_num_threads(2)

D, S = 16, 2.0


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The ``parallel`` suite run once as 2 gloo ranks: its directory."""
    out = tmp_path_factory.mktemp("parallel")
    run_suite("parallel", out, timeout_s=180)
    return out


def test_partition_cubes_matches_reference():
    from surfacenet_tpu.parallel.sweep_sharded import partition_cubes as jp

    rng = np.random.default_rng(0)
    full = np.stack(np.meshgrid(np.arange(4), np.arange(2), np.arange(6),
                                indexing="ij"), axis=-1).reshape(-1, 3)
    for grid in (full, full[rng.uniform(size=len(full)) > 0.4],
                 np.zeros((0, 3), int)):
        for n_block in (1, 2, 3, 4):
            got, want = partition_cubes(grid, n_block), jp(grid, n_block)
            assert len(got) == len(want) == n_block
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)


def test_make_mesh_one_rank_and_errors():
    from surfacenet_tpu.parallel.mesh import make_mesh as jmesh

    m = make_mesh()
    assert m.shape == (1, 1) and m.axis_names == ("block", "cube")
    assert m.rank == m.block == m.cube == 0 and m.group is None
    with pytest.raises(ValueError) as got:
        make_mesh(2)
    with pytest.raises(ValueError) as want:
        jmesh(n_block=3)
    assert str(got.value) == "n_block=2 does not divide 1 devices"
    assert str(want.value) == "n_block=3 does not divide 8 devices"


def test_make_mesh_two_ranks(ranks):
    """(1, 2) and (2, 1) grids over 2 ranks, a row group only where a row
    has two ranks, the reference's message for 3 blocks, and gloo for CPU
    ranks."""
    for r in (0, 1):
        got = load(ranks, "mesh", r, "json")
        assert got["m1_shape"] == [1, 2] and got["m1_row_group"]
        assert got["m1_cube"] == r
        assert got["m2_shape"] == [2, 1] and not got["m2_row_group"]
        assert got["m2_block"] == r
        assert got["error"] == "n_block=3 does not divide 2 devices"
        assert got["backend"] == "gloo"


@pytest.mark.parametrize("halo", [1, 2])
def test_halo_exchange_matches_reference(ranks, halo):
    """Each rank's haloed block equals the reference's block shard of
    ``halo_exchange`` over a 2-block mesh: the neighbour's slab, zeros at
    the scene's edges."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from surfacenet_tpu.parallel.halo import halo_exchange
    from surfacenet_tpu.parallel.mesh import make_mesh as jmesh

    m = jmesh(n_block=2)
    vol = jnp.arange(16 * 4 * 4, dtype=jnp.float32).reshape(16, 4, 4)
    vol = jax.device_put(vol, NamedSharding(m, P("block")))
    want = np.asarray(halo_exchange(m, vol, halo=halo))
    n = 8 + 2 * halo
    for b in (0, 1):
        got = load(ranks, f"halo{halo}", b)["out"]
        np.testing.assert_array_equal(got, want[b * n:(b + 1) * n])


def test_sync_batchnorm_matches_full_batch(ranks):
    """2 ranks x 2 items through the synchronised BatchNorm against the
    4 items through ``_batchnorm`` in one process."""
    from surfacenet_tpu_torch.models.surfacenet import (
        BN_EPS, BN_MOMENTUM, _batchnorm,
    )

    gen = torch.Generator().manual_seed(0)
    x = (torch.randn(4, 6, 5, 5, 5, generator=gen) * 2.0 + 0.5)
    dy = torch.randn(4, 6, 5, 5, 5, generator=gen)
    bn = torch.nn.BatchNorm3d(6, eps=BN_EPS, momentum=BN_MOMENTUM)
    with torch.no_grad():
        bn.weight.copy_(torch.rand(6, generator=gen) + 0.5)
        bn.bias.copy_(torch.randn(6, generator=gen))
    x = x.contiguous(memory_format=torch.channels_last_3d).requires_grad_()
    y = _batchnorm(bn.train(), x)
    (y * dy).sum().backward()
    got = [load(ranks, "syncbn", r) for r in (0, 1)]
    for key, want in (("y", y.detach()), ("dx", x.grad)):
        diff = np.abs(np.concatenate([g[key] for g in got]) - want.numpy())
        assert diff.max() <= 1e-5, key
    for key in ("running_mean", "running_var"):
        want = getattr(bn, key).numpy()
        for g in got:
            assert np.abs(g[key] - want).max() <= 1e-5, key
    for key, want in (("dweight", bn.weight.grad), ("dbias", bn.bias.grad)):
        assert np.abs(got[0][key] + got[1][key]
                      - want.numpy()).max() <= 1e-5, key


def _mask_items():
    """Items of the 4-view test sphere's views and the same views with
    their world axes permuted (every dominant ray axis occurs), and
    probabilities quantised to eighths (many exact ties)."""
    from surfacenet_tpu.data.synthetic import make_sphere_scene

    Ps = np.asarray(make_sphere_scene(n_views=4, hw=(96, 128)).Ps, np.float64)
    views = [Ps]
    for perm in ((1, 2, 0), (2, 0, 1)):
        Pp = Ps.copy()
        Pp[:, :, :3] = Ps[:, :, list(perm)]
        views.append(Pp)
    Ps = np.concatenate(views).astype(np.float32)
    rng = np.random.default_rng(1)
    N = len(Ps)
    probs = (np.round(rng.uniform(0, 1, (N, D, D, D)) * 8) / 8).astype(
        np.float32)
    origins = rng.uniform(-20, 4, (N, 3)).astype(np.float32)
    return probs, origins, Ps


@pytest.mark.parametrize("window", [0, 1, 2])
def test_ray_max_mask_affine_matmul_matches_reference(window):
    from surfacenet_tpu.ops.ray_pooling import (
        ray_max_mask_affine_matmul as jmask,
    )
    from surfacenet_tpu_torch.ops.ray_pooling import (
        item_params, ray_max_mask_affine_matmul, ray_max_mask_affine_plain,
    )

    probs, origins, Ps = _mask_items()
    want = np.asarray(jmask(jnp.asarray(probs), jnp.asarray(origins), S,
                            jnp.asarray(Ps), window=window))
    pt, ot, Pt = (torch.tensor(a) for a in (probs, origins, Ps))
    got = ray_max_mask_affine_matmul(pt, ot, S, Pt, window=window).numpy()
    axis, slopes = item_params(ot, S, Pt, D)
    assert set(axis.tolist()) == {0, 1, 2}
    np.testing.assert_array_equal(got, want)
    # the same function as the kernels' plain version
    np.testing.assert_array_equal(
        got, ray_max_mask_affine_plain(pt, axis, slopes, window).numpy())


@pytest.fixture(scope="module")
def scene():
    from surfacenet_tpu.data.synthetic import make_sphere_scene

    return make_sphere_scene(n_views=4, hw=(96, 128))


def _j_pred(x, origins):
    return jax.nn.sigmoid(4.0 * jnp.sum(x.astype(jnp.float32), axis=-1))


def _t_pred(x, origins):
    return torch.sigmoid(4.0 * x.float().sum(dim=-1))


def test_non_dedup_cube_batch_step_matches_reference(scene):
    """``uniq_views=None``: one gather item per (cube, pair, half), pooling
    views from the pairs; with the matmul pool mode on both sides.  A
    closed-form predictor of the CVC pair (the step's own parity test
    covers the photoconsistency and tiny-net predictors)."""
    from surfacenet_tpu.ops.view_pairs import (
        dedup_view_slots, select_pairs_geometric,
    )

    origins = np.array([[-16.0, -16.0, -16.0], [0.0, 0.0, -16.0],
                        [-16.0, 0.0, 0.0], [0.0, 0.0, 0.0]], np.float32)
    hw = scene.images.shape[1:3]
    pair_idx, pair_w = select_pairs_geometric(scene.Ps, origins, 3, hw,
                                              extent_mm=D * S)
    pair_idx = np.asarray(pair_idx, np.int32)
    pair_w = np.asarray(pair_w, np.float32)
    grid = np.array([[0, 0, 0], [1, 1, 0], [0, 1, 1], [1, 1, 1]])
    core = J.core_bounds_for(grid, np.array([1, 1, 1]), D, 8, present=grid)
    kw = dict(D=D, s=S, n_pairs=3, tau=0.3, gamma=0.6, adaptive=False,
              center_colors=True, n_pool_views=4, pool_window=2)
    ref = J.cube_batch_step(
        jnp.asarray(scene.images), jnp.asarray(scene.Ps, jnp.float32),
        jnp.asarray(origins), jnp.asarray(pair_idx), jnp.asarray(pair_w),
        jnp.asarray(core), None, None, predict=_j_pred,
        ray_pool_mode="affine_matmul", **kw)
    images = torch.tensor(scene.images)
    Ps = torch.tensor(scene.Ps, dtype=torch.float32)
    args = (torch.tensor(origins), torch.tensor(pair_w), torch.tensor(core))
    got = T.cube_batch_step(images, Ps, *args, None, None,
                            pair_idx=torch.tensor(pair_idx),
                            predict=_t_pred,
                            ray_pool_mode="affine_matmul", **kw)
    occ_j, fused_j, color_j = (np.asarray(a) for a in ref)
    occ_t, fused_t, color_t = (a.numpy() for a in got)
    assert occ_t.any()
    assert (occ_t == occ_j).mean() >= 0.995
    assert np.abs(fused_t - fused_j).max() <= 1e-4
    assert np.abs(color_t - color_j).max() <= 1e-4
    # the deduplicated path on the same pairs gives the same volumes
    uniq, slots = dedup_view_slots(pair_idx)
    dd = T.cube_batch_step(images, Ps, *args, torch.tensor(uniq),
                           torch.tensor(slots),
                           predict=_t_pred,
                           ray_pool_mode="affine_matmul", **kw)
    for a, b in zip(got, dd):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    # the matmul pool mode and the vote's plain version agree
    vote = T.cube_batch_step(images, Ps, *args, torch.tensor(uniq),
                             torch.tensor(slots),
                             predict=_t_pred,
                             ray_pool_mode="affine", **kw)
    np.testing.assert_array_equal(vote[0].numpy(), occ_t)


def test_unique_views_matches_jnp_unique():
    rng = np.random.default_rng(2)
    pairs = rng.integers(0, 5, (50, 3, 2)).astype(np.int32)
    for K in (2, 4, 6):
        want = np.stack([np.asarray(jnp.unique(jnp.asarray(p.reshape(-1)),
                                               size=K, fill_value=-1))
                         for p in pairs])
        got = T.unique_views(torch.tensor(pairs), K).numpy()
        np.testing.assert_array_equal(got, want)


def test_assert_all_finite_and_checked_fn_match_reference():
    from surfacenet_tpu.utils.debug import assert_all_finite as jfinite
    from surfacenet_tpu_torch.utils.debug import (
        assert_all_finite, checked_fn,
    )

    tree = {"params": {"w": np.ones((2, 3), np.float32),
                       "b": [np.zeros(3, np.float32),
                             np.array([1.0, np.nan, np.inf], np.float32)]}}
    with pytest.raises(FloatingPointError) as want:
        jfinite(tree, "grads")
    torch_tree = {"params": {"w": torch.ones(2, 3),
                             "b": [torch.zeros(3),
                                   torch.tensor([1.0, np.nan, np.inf])]}}
    for t in (tree, torch_tree):
        with pytest.raises(FloatingPointError) as got:
            assert_all_finite(t, "grads")
        assert str(got.value) == str(want.value)
    assert_all_finite({"a": torch.ones(2), "n": torch.arange(3)}, "ok")

    def step(x):
        return {"loss": x.sum(), "y": torch.log(x)}

    checked = checked_fn(step)
    assert float(checked(torch.ones(3))["loss"]) == 3.0
    with pytest.raises(FloatingPointError, match=r"step output\['y'\]"):
        checked(torch.tensor([1.0, -1.0]))


def test_splat_and_turntable_match_reference(tmp_path):
    from surfacenet_tpu.utils.viz import splat_orthographic as jsplat
    from surfacenet_tpu_torch.data.png import read_png
    from surfacenet_tpu_torch.utils.viz import (
        save_turntable, splat_orthographic,
    )

    rng = np.random.default_rng(3)
    pts = rng.normal(0, 20, (500, 3))
    cols = rng.uniform(0, 1, (500, 3)).astype(np.float32)
    for colors in (None, cols):
        for axis in (0, 1, 2):
            got = splat_orthographic(pts, colors, axis=axis, size=64)
            want = jsplat(pts, colors, axis=axis, size=64)
            assert got.dtype == np.uint8
            np.testing.assert_array_equal(got, want)
    assert not splat_orthographic(pts[:0], size=8).any()
    names = save_turntable(str(tmp_path / "t"), pts, cols, size=64)
    assert [n[-6:] for n in names] == ["xy.png", "xz.png", "yz.png"]
    for name, axis in zip(names, (2, 1, 0)):
        np.testing.assert_array_equal(
            read_png(name), splat_orthographic(pts, cols, axis=axis, size=64))


def test_scaling_efficiency_reads_sharded_stats():
    from surfacenet_tpu.utils.observability import (
        scaling_efficiency as jscale,
    )
    from surfacenet_tpu_torch.parallel.sweep_sharded import ShardedSweepStats
    from surfacenet_tpu_torch.utils.observability import scaling_efficiency

    rates = {1: 10.0, 2: 18.0, 4: 30.0}
    stats = {n: dataclasses.replace(ShardedSweepStats(), cubes_per_s=v)
             for n, v in rates.items()}
    assert scaling_efficiency(stats) == scaling_efficiency(rates) \
        == jscale(rates)
