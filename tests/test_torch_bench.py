"""Port parity: ``cli bench`` (``surfacenet_tpu_torch/bench.py``).

The bench's inputs against the JAX functions the root ``bench.py`` calls,
at its own settings: equal (the pair weights within 1e-5 relative).
The bench's step (``make_step``) against the reference's ``cube_batch_step`` on the same inputs with the same tiny
float32 weights: equal counts, records within the tolerance stated in the
test.  ``time_pipelined`` syncs the host once a window.  A tiny run of
every point gives the record's keys, in order, with finite values, and
the calls that ``chip_smoke.py`` derives its launch counts from.  Without
a card ``cli bench`` raises ``resolve_device``'s error.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import surfacenet_tpu.pipeline.sweep as J
from surfacenet_tpu.config import Config, ModelConfig
from surfacenet_tpu_torch import bench, cli
from surfacenet_tpu_torch.config import Config as TConfig
from surfacenet_tpu_torch.pipeline.sweep import gather_images
from surfacenet_tpu_torch.train import train_surface

torch.set_num_threads(2)

SIZES = bench.BenchSizes()


@pytest.fixture(scope="module")
def scenes():
    """bench.py's sphere, rendered once by each package."""
    from surfacenet_tpu.data.synthetic import make_sphere_scene

    return (bench.bench_scene(SIZES),
            make_sphere_scene(n_views=8, hw=(600, 800), radius=30.0))


@pytest.mark.parametrize("D,seed,n_cubes", [(32, 1, 32), (64, 2, 24)],
                         ids=["32cubed", "64cubed"])
def test_inputs_equal_bench_py(scenes, D, seed, n_cubes):
    """Origins, pairs and the dedup table equal bench.py's; the pair
    weights agree within 1e-5 relative, the bound of
    ``test_torch_pairs_fusion.py::test_select_pairs_geometric_exact``:
    XLA's float32 arccos and exp and torch's differ in the last ulps
    (measured 2.2e-6 relative at most)."""
    from surfacenet_tpu.ops.view_pairs import (
        dedup_view_slots, select_pairs_geometric,
    )

    t_scene, j_scene = scenes
    np.testing.assert_array_equal(t_scene.images, j_scene.images)
    np.testing.assert_array_equal(t_scene.Ps, j_scene.Ps)
    assert (SIZES.D, SIZES.n_cubes, SIZES.D64, SIZES.n_cubes64) == (
        32, 32, 64, 24)
    cfg = bench.bench_config(SIZES.D)
    got = bench.cube_inputs(t_scene, cfg, n_cubes, seed, D, "cpu")

    s = 0.8
    pts = j_scene.surface_points(n_cubes, seed=seed)
    origins = (pts - D * s / 2).astype(np.float32)
    pair_idx, pair_w = select_pairs_geometric(
        j_scene.Ps, origins, 5, j_scene.images.shape[1:3], extent_mm=D * s)
    uniq, slots = dedup_view_slots(pair_idx)
    want = dict(origins=origins, pair_idx=np.asarray(pair_idx),
                pair_w=np.asarray(pair_w), uniq_views=uniq, slot_idx=slots)
    assert set(got) == set(want)
    for k, v in want.items():
        if k == "pair_w":
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-7)
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_bench_config_matches_bench_py():
    f = bench.bench_config(32)
    assert (f.voxel.voxel_size_mm, f.voxel.cube_size, f.voxel.overlap) == (
        0.8, 32, 8)
    assert (f.fusion.n_view_pairs, f.fusion.tau, f.fusion.gamma,
            f.fusion.n_pool_views, f.fusion.ray_pool_mode) == (
        5, 0.7, 0.8, 6, "affine_pallas")
    assert bench.POOL_WINDOW == 2


def _tiny_weights():
    from surfacenet_tpu.models.surfacenet import SurfaceNet as JNet
    from surfacenet_tpu_torch.models.convert import params_from_jax
    from surfacenet_tpu_torch.models.surfacenet import (
        SurfaceNet, make_predictor,
    )

    jcfg = ModelConfig.tiny()
    jnet = JNet(jcfg)
    variables = jax.jit(lambda k, x: jnet.init(k, x, train=False))(
        jax.random.PRNGKey(3), jnp.zeros((1, 8, 8, 8, 6)))
    variables = jax.tree_util.tree_map(np.asarray, variables)

    def j_pred(x, origins):
        return jnet.apply(variables, x, train=False)

    tcfg = TConfig.from_json(Config(model=jcfg).to_json()).model
    net = SurfaceNet(tcfg)
    net.load_state_dict(params_from_jax(variables))
    return j_pred, make_predictor(net, tcfg, "cpu")


def test_bench_step_matches_reference(scenes):
    """The bench's step (pool window 2, compact records) at D 16 on 2
    cubes, float32 images, tiny float32 weights carried over by
    ``models/convert.py``, against the reference's ``cube_batch_step`` on
    its CPU route (bench.py's off the TPU: the XLA gather and the
    ``affine`` vote).  Counts equal.  Records: fused agrees within 1e-4
    (float32 sums in another order, ``test_torch_sweep.py``), so a
    record's probability or colour byte may round one step apart, and the
    keys of equal probability byte keep their order; every record's
    voxel, and its occupancy, are equal in >= 99.9% of the records, and
    every byte is within one step (measured: all voxels and occupancies
    equal, 99.78% of the records byte for byte, 809 occupied voxels)."""
    t_scene, j_scene = scenes
    D = 16
    cfg = bench.bench_config(D)
    # tau 0.45: the tiny random net's probabilities lie in 0.37-0.49
    cfg = cfg.replace(fusion=dataclasses.replace(cfg.fusion, tau=0.45))
    inputs = bench.cube_inputs(t_scene, cfg, 2, 1, D, "cpu")
    j_pred, t_pred = _tiny_weights()
    step = bench.make_step(
        gather_images(torch.tensor(t_scene.images), torch.float32),
        torch.tensor(t_scene.Ps, dtype=torch.float32), inputs, cfg, D,
        t_pred, "cpu")
    rec_t, counts_t = (a.numpy() for a in step())
    ref_step = jax.jit(functools.partial(
        J.cube_batch_step, D=D, s=0.8, n_pairs=5, tau=0.45, gamma=0.8,
        adaptive=False, center_colors=True, predict=j_pred, use_pallas=False,
        n_pool_views=6, ray_pool_mode="affine", pool_window=2,
        compact_output=True))
    rec_j, counts_j = (np.asarray(a) for a in ref_step(
        jnp.asarray(j_scene.images), jnp.asarray(j_scene.Ps, jnp.float32),
        *(jnp.asarray(inputs[k]) for k in ("origins", "pair_idx", "pair_w")),
        None, jnp.asarray(inputs["uniq_views"]),
        jnp.asarray(inputs["slot_idx"])))
    assert rec_t.shape == rec_j.shape == (2, D**3, 7)
    np.testing.assert_array_equal(counts_t, counts_j)
    assert counts_t.min() > 0
    diff = np.abs(rec_t.astype(int) - rec_j.astype(int))
    same_voxel = (diff[..., :3] == 0).all(-1)
    assert same_voxel.mean() >= 0.999
    occ_t, occ_j = rec_t[..., 3] > 0, rec_j[..., 3] > 0
    assert (occ_t == occ_j).mean() >= 0.999
    assert diff[same_voxel][:, 3:].max() <= 1


def test_time_pipelined_syncs_once_a_window(monkeypatch):
    events = []
    real_item = torch.Tensor.item

    def item(self):
        events.append("sync")
        return real_item(self)

    def fn():
        events.append("call")
        return torch.tensor(1.0)

    monkeypatch.setattr(torch.Tensor, "item", item)
    best = bench.time_pipelined(fn, n_iters=4, n_windows=3)
    assert events == ["call", "sync"] + (["call"] * 4 + ["sync"]) * 3
    assert 0.0 < best < math.inf


def test_tiny_record_keys_and_calls(monkeypatch):
    """Every point at tiny sizes on the CPU: exactly the record's keys,
    finite values; six step points of 1 + windows x iterations calls each
    and (1 + chunks) x K training steps, the calls from which
    ``chip_smoke.py`` derives the kernels' launches."""
    calls = {"step": 0, "train": 0}
    real_step, real_train = bench.cube_batch_step, train_surface.train_step

    def step(*a, **kw):
        calls["step"] += 1
        return real_step(*a, **kw)

    def train(*a, **kw):
        calls["train"] += 1
        return real_train(*a, **kw)

    monkeypatch.setattr(bench, "cube_batch_step", step)
    monkeypatch.setattr(train_surface, "train_step", train)
    tiny = ModelConfig.tiny()
    sizes = bench.BenchSizes(
        hw=(96, 128), D=16, n_cubes=2, D64=16, n_cubes64=2, n_iters=2,
        n_windows=1, aligned_batch=3, train_K=2, train_batch=2,
        train_chunks=1, n_candidates=16,
        models=dict.fromkeys(("paper", "aligned", "fast", "fast64"), tiny))
    rec = bench.run_bench("cpu", sizes)
    assert tuple(rec) == (
        "metric", "value", "unit", "vs_baseline", "e2e_includes",
        "conv_gflops_per_item", "model_fwd_items_per_s", "model_fwd_mfu_pct",
        "e2e_mfu_pct", "peak_tflops", "model_fwd_mfu_pct_aligned",
        "model_fwd_mfu_pct_aligned_b160", "aligned_fwd_batch",
        "cubes_per_s_aligned", "e2e_mfu_pct_aligned",
        "model_fwd_mfu_pct_fast", "cubes_per_s_fast", "e2e_mfu_pct_fast",
        "cubes_per_s_64", "model_fwd_mfu_pct_64", "e2e_mfu_pct_64",
        "cubes_per_s_64_fast", "cubes_per_s_64_fast64",
        "model_fwd_mfu_pct_64_fast64", "e2e_mfu_pct_64_fast64",
        "train_steps_per_s", "device",
    ) == bench.RECORD_KEYS
    assert rec["metric"] == "inference_cubes_per_s_per_chip"
    assert rec["device"] == "cpu" and rec["aligned_fwd_batch"] == 3
    numbers = {k: v for k, v in rec.items() if not isinstance(v, str)}
    assert len(numbers) == len(rec) - 4
    assert all(math.isfinite(v) and v > 0 for v in numbers.values())
    assert rec["vs_baseline"] == rec["value"] / 5.0
    assert calls == {"step": 6 * (1 + 1 * 2), "train": (1 + 1) * 2}


def test_cli_bench_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["bench"])
