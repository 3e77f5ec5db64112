"""Port parity: the occlusion-robust reconstruct path.

The occluded and degraded golden scenes (bitwise), the learned pair
selection with the shipped pair net (``weights/pairnet_10000`` on the JAX
side, its conversion ``weights_torch/pairnet_10000.npz`` here), consensus
fusion, the consensus batch step, and the learned-pair sweep end to end.
Scenes are small, as the reference's own tests: 12 views of 120x160, cubes
of 16 voxels of 2 mm.  Bounds are stated in each test.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import surfacenet_tpu.ops.fusion as JF
import surfacenet_tpu.ops.view_pairs as JV
import surfacenet_tpu.pipeline.sweep as JS
import surfacenet_tpu_torch.ops.fusion as TF
import surfacenet_tpu_torch.ops.view_pairs as TV
import surfacenet_tpu_torch.pipeline.sweep as TS
from surfacenet_tpu.config import (
    Config, FusionConfig, SweepConfig, VoxelConfig,
)
from surfacenet_tpu.data import synthetic as jsyn
from surfacenet_tpu_torch.config import Config as TConfig
from surfacenet_tpu_torch.data import synthetic as tsyn
from surfacenet_tpu_torch.train.train_pair import restore_pairnet
from surfacenet_tpu_torch.utils.metrics import voxel_set_agreement

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, S, HW = 16, 2.0, (120, 160)
EXTENT = D * S


@pytest.fixture(scope="module")
def scene():
    return jsyn.make_occluded_scene(n_views=12, hw=HW)


@pytest.fixture(scope="module")
def nets():
    """(flax model, variables, port PairNet) of ``pairnet_10000``."""
    from surfacenet_tpu.train.train_pair import restore_pairnet as j_restore

    model, variables = j_restore(
        os.path.join(ROOT, "weights", "pairnet_10000"), Config())
    variables = jax.tree_util.tree_map(np.asarray, variables)
    net = restore_pairnet(
        os.path.join(ROOT, "weights_torch", "pairnet_10000.npz"),
        TConfig().pairnet)
    return model, variables, net


@pytest.fixture(scope="module")
def origins(scene):
    """The prefilter's surviving cube origins of the small sweep."""
    cfg = _configs()[0]
    _, o = JS.enumerate_cubes(scene.bbox_min, scene.bbox_max, cfg)
    return o[JS.prefilter_cubes(scene.Ps, o, HW, cfg)]


def _configs(**fusion_kw):
    cfg = Config(
        voxel=VoxelConfig(voxel_size_mm=S, cube_size=D, overlap=4),
        fusion=FusionConfig(n_view_pairs=3, tau=0.25, gamma=0.6,
                            **fusion_kw),
        sweep=SweepConfig(cube_batch=8),
    )
    return cfg, TConfig.from_json(cfg.to_json())


def test_occluded_scene_bitwise(scene):
    got = tsyn.make_occluded_scene(n_views=12, hw=HW)
    assert isinstance(got, tsyn.OccludedScene)
    np.testing.assert_array_equal(got.images, scene.images)
    np.testing.assert_array_equal(got.Ps, scene.Ps)
    pts = scene.surface_points(400, seed=5)
    occ = got.point_occlusion_matrix(pts)
    np.testing.assert_array_equal(occ, scene.point_occlusion_matrix(pts))
    assert occ.any() and not occ.all()
    np.testing.assert_array_equal(got.occluded_views(),
                                  scene.occluded_views())
    np.testing.assert_array_equal(got.surface_points(50, seed=1),
                                  scene.surface_points(50, seed=1))


@pytest.mark.parametrize("kw", [
    dict(noise_std=0.02), dict(exposure_jitter=0.2), dict(wb_jitter=0.1),
    dict(n_clutter=3), dict(calib_sigma_px=1.5),
], ids=["noise", "exposure", "white_balance", "clutter", "calibration"])
def test_degrade_scene_bitwise(scene, kw):
    ref = jsyn.degrade_scene(scene, seed=1, **kw)
    got = tsyn.degrade_scene(tsyn.make_occluded_scene(n_views=12, hw=HW),
                             seed=1, **kw)
    np.testing.assert_array_equal(got.images, ref.images)
    np.testing.assert_array_equal(got.Ps, ref.Ps)
    assert type(got) is tsyn.OccludedScene and got.radius == ref.radius


def test_cube_view_consensus_matches_reference(scene, nets, origins):
    """Consensus within 1e-5, validity equal, and every crop at the same
    pixel: the rounded crop centres equal the reference's projection."""
    from surfacenet_tpu.geometry.camera import project as j_project

    model, variables, net = nets
    centers = origins + EXTENT / 2.0
    c_j, v_j = JV.cube_view_consensus(scene.images, scene.Ps, centers,
                                      model, variables, 32)
    c_t, v_t = TV.cube_view_consensus(scene.images, scene.Ps, centers, net,
                                      32, device="cpu", chunk=100)
    assert c_t.shape == (len(origins), 12) and c_t.dtype == np.float32
    np.testing.assert_array_equal(v_t, v_j)
    assert np.abs(c_t - c_j).max() <= 1e-5
    uv_t, _ = TV.crop_centers(scene.Ps, centers, HW, 32, device="cpu")
    for v in range(12):
        uv, w = j_project(jnp.asarray(scene.Ps[v], jnp.float32),
                          jnp.asarray(centers, jnp.float32))
        uv = np.where(np.asarray(w)[:, None] > 0, np.asarray(uv), -1e6)
        np.testing.assert_array_equal(torch.round(uv_t[v]).numpy(),
                                      np.round(uv))
    # the chunk size does not change the result
    c_1, _ = TV.cube_view_consensus(scene.images, scene.Ps, centers, net,
                                    32, device="cpu", chunk=4096)
    np.testing.assert_array_equal(c_1, c_t)


def test_consensus_gates_match_reference():
    """Seeded consensus rows, among them even counts of valid views (numpy
    averages the two middle values, ``torch.nanmedian`` would not), an
    all-invalid cube and confident outliers: within 1e-6."""
    rng = np.random.default_rng(7)
    cons = rng.uniform(0.6, 0.95, (40, 12)).astype(np.float32)
    cons[::3, 2] = 0.1  # outliers
    valid = rng.uniform(size=(40, 12)) > 0.25
    valid[0] = False
    valid[1] = [True, True, True, True] + [False] * 8  # even count, 4
    cons[1, :4] = [0.9, 0.8, 0.7, 0.2]
    assert (valid.sum(1) % 2 == 0).sum() > 5
    got = TV.consensus_gates(cons, valid)
    ref = JV.consensus_gates(cons, valid)
    assert got.dtype == np.float32
    assert np.abs(got - ref).max() <= 1e-6
    np.testing.assert_array_equal(got[0], 1.0)
    assert (got < 1).any() and (got[~valid] == 1).all()


def test_select_pairs_learned_local_matches_reference(scene, nets, origins):
    """Identical pairs; weights within the geometric selector's own parity
    bound (rtol 1e-5, atol 1e-7; the angle weight alone differs by float32
    ulps).  The learned choice differs from the geometric one somewhere."""
    model, variables, net = nets
    i_j, w_j = JV.select_pairs_learned_local(
        scene.Ps, origins, 3, HW, EXTENT, scene.images, model, variables, 32)
    i_t, w_t = TV.select_pairs_learned_local(
        scene.Ps, origins, 3, HW, EXTENT, scene.images, net, 32,
        device="cpu")
    np.testing.assert_array_equal(i_t, i_j)
    np.testing.assert_allclose(w_t, w_j, rtol=1e-5, atol=1e-7)
    g_i, _ = TV.select_pairs_geometric(scene.Ps, origins, 3, HW,
                                       extent_mm=EXTENT, device="cpu")
    assert (g_i != i_t).any()


def test_select_pairs_learned_matches_reference(scene, nets, origins):
    model, variables, net = nets
    sim_j = JV.view_similarity_from_scene(
        scene.images, scene.Ps, scene.bbox_min, scene.bbox_max, model,
        variables, 32, n_points=16)
    sim_t = TV.view_similarity_from_scene(
        scene.images, scene.Ps, scene.bbox_min, scene.bbox_max, net, 32,
        n_points=16, device="cpu")
    assert np.abs(sim_t - sim_j).max() <= 1e-5
    i_j, w_j = JV.select_pairs_learned(scene.Ps, origins, 3, HW, EXTENT,
                                       sim_j)
    i_t, w_t = TV.select_pairs_learned(scene.Ps, origins, 3, HW, EXTENT,
                                       sim_t, device="cpu")
    np.testing.assert_array_equal(i_t, i_j)
    np.testing.assert_allclose(w_t, w_j, rtol=1e-5, atol=1e-7)


def test_scored_selector_without_similarity_is_geometric(scene, origins):
    """``pair_sim=None`` is the geometric selector, bitwise; a similarity
    of ones changes nothing; a (P,) similarity equals its (N, P)
    broadcast; the selector ranks after multiplying (a zeroed pair
    leaves every cube's selection)."""
    kw = dict(n_pairs=3, image_hw=HW, extent_mm=EXTENT, device="cpu")
    g = TV.select_pairs_geometric(scene.Ps, origins, **kw)
    P = len(TV.candidate_pairs(12))
    for sim in (None, np.ones(P, np.float32),
                np.ones((len(origins), P), np.float32)):
        got = TV.select_pairs_scored(scene.Ps, origins, pair_sim=sim, **kw)
        np.testing.assert_array_equal(got[0], g[0])
        np.testing.assert_array_equal(got[1], g[1])
    sim = np.random.default_rng(3).uniform(0, 1.3, P).astype(np.float32)
    a = TV.select_pairs_scored(scene.Ps, origins, pair_sim=sim, **kw)
    b = TV.select_pairs_scored(scene.Ps, origins, pair_sim=np.broadcast_to(
        sim, (len(origins), P)), **kw)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    top = int(np.argmax(np.bincount(
        [np.flatnonzero((TV.candidate_pairs(12) == p).all(1))[0]
         for p in g[0][:, 0]])))
    sim = np.ones(P, np.float32)
    sim[top] = 0.0
    i, _ = TV.select_pairs_scored(scene.Ps, origins, pair_sim=sim, **kw)
    assert not (i == TV.candidate_pairs(12)[top]).all(-1).any()


def test_fuse_pairs_consensus_matches_reference():
    """Seeded probabilities and masks over 5 cubes, one empty (all zero),
    one with no valid voxel, one with a dissenting pair: within 1e-6."""
    rng = np.random.default_rng(11)
    Nc, Np, d = 5, 4, 8
    probs = rng.uniform(size=(Nc, Np, d, d, d)).astype(np.float32)
    base = rng.uniform(size=(Nc, 1, d, d, d)).astype(np.float32)
    probs = np.clip(base + 0.1 * (probs - 0.5), 0, 1).astype(np.float32)
    probs[2, 1] = rng.uniform(size=(d, d, d))  # dissents
    probs[0] = 0.0
    w = rng.uniform(0.1, 1.0, (Nc, Np)).astype(np.float32)
    valid = rng.uniform(size=(Nc, Np, d, d, d)) > 0.2
    valid[3] = False
    for beta, band in ((8.0, 0.1), (8.0, 0.3), (20.0, 0.05)):
        for v in (valid, None):
            ref = jax.vmap(functools.partial(
                JF.fuse_pairs_consensus, beta=beta, deadband=band))(
                jnp.asarray(probs), jnp.asarray(w),
                None if v is None else jnp.asarray(v))
            got = TF.fuse_pairs_consensus(
                torch.tensor(probs), torch.tensor(w),
                None if v is None else torch.tensor(v), beta=beta,
                deadband=band)
            assert np.abs(got.numpy() - np.asarray(ref)).max() <= 1e-6
    plain = TF.fuse_pairs(torch.tensor(probs[0]), torch.tensor(w[0]))
    np.testing.assert_array_equal(
        TF.fuse_pairs_consensus(torch.tensor(probs[0]),
                                torch.tensor(w[0])).numpy(), plain.numpy())


def test_cube_batch_step_consensus_matches_reference(scene, origins):
    """The batch step with ``fusion_mode=("consensus", 8.0, 0.3)`` against
    the reference's step (float32 gather, affine pooling): fused and colour
    within 1e-4, occupancy agreement >= 0.995, as the mean-fusion step's
    parity test; and the consensus differs from mean fusion somewhere."""
    # three cubes where a pair dissents beyond the deadband, one where none
    o = origins[[55, 26, 18, 0]].astype(np.float32)
    pair_idx, pair_w = JV.select_pairs_geometric(scene.Ps, o, 3, HW,
                                                 extent_mm=EXTENT)
    uniq, slots = JV.dedup_view_slots(np.asarray(pair_idx))
    kw = dict(D=D, s=S, n_pairs=3, tau=0.25, gamma=0.6, adaptive=False,
              center_colors=True, n_pool_views=6, pool_window=0,
              ray_pool_mode="affine")
    mode = ("consensus", 8.0, 0.3)
    ref = JS.cube_batch_step(
        jnp.asarray(scene.images), jnp.asarray(scene.Ps, jnp.float32),
        jnp.asarray(o), jnp.asarray(pair_idx), jnp.asarray(pair_w),
        None, jnp.asarray(uniq), jnp.asarray(slots),
        predict=JS.photoconsistency_predictor, fusion_mode=mode, **kw)
    args = (torch.tensor(scene.images),
            torch.tensor(scene.Ps, dtype=torch.float32), torch.tensor(o),
            torch.tensor(np.asarray(pair_w)), None, torch.tensor(uniq),
            torch.tensor(slots))
    got = TS.cube_batch_step(*args, predict=TS.photoconsistency_predictor,
                             fusion_mode=mode, **kw)
    mean = TS.cube_batch_step(*args, predict=TS.photoconsistency_predictor,
                              **kw)
    occ_j, fused_j, color_j = (np.asarray(a) for a in ref)
    occ_t, fused_t, color_t = (a.numpy() for a in got)
    assert np.abs(fused_t - fused_j).max() <= 1e-4
    assert np.abs(color_t - color_j).max() <= 1e-4
    assert (occ_t == occ_j).mean() >= 0.995 and occ_t.any()
    moved = np.abs(fused_t - mean[1].numpy()).max(axis=(1, 2, 3))
    assert (moved[:3] > 1e-2).all() and moved[3] == 0.0
    _, tcfg = _configs(fusion_mode="consensus", consensus_beta=8.0,
                       consensus_deadband=0.3)
    assert TS.resolve_fusion_mode(tcfg) == JS.resolve_fusion_mode(
        _configs(fusion_mode="consensus", consensus_beta=8.0,
                 consensus_deadband=0.3)[0]) == mode


@pytest.mark.parametrize("selector,fusion_kw", [
    pytest.param("learned_local", {}, id="learned_local"),
    pytest.param("geometric", {}, id="geometric"),
    pytest.param("geometric", dict(fusion_mode="consensus",
                                   consensus_deadband=0.1),
                 id="consensus_db0.1"),
    pytest.param("geometric", dict(fusion_mode="consensus",
                                   consensus_deadband=0.3),
                 id="consensus_db0.3"),
    pytest.param("geometric", dict(pair_dist_sigma_frac=0.15),
                 id="proximity"),
])
def test_run_sweep_learned_pairs_matches_reference(scene, nets, selector,
                                                   fusion_kw):
    """The slice end to end: the occluded scene, the photoconsistency
    predictor, exact pooling and the learned-local selector with the
    shipped pair net in both packages (and the geometric selector beside
    it; with consensus fusion at deadbands 0.1 and 0.3, beta 8, and with
    the proximity term ``pair_dist_sigma_frac=0.15``, as
    ``results/occlusion_r04.json``'s rows): the same cubes, and merged
    voxel sets that agree on >= 0.999 of their union."""
    model, variables, net = nets
    jcfg, tcfg = _configs(**fusion_kw)
    j_sel = t_sel = None
    if selector == "learned_local":
        kw = dict(n_pairs=3, image_hw=HW, extent_mm=EXTENT,
                  images=scene.images, patch_size=32)
        j_sel = functools.partial(JV.select_pairs_learned_local,
                                  model=model, variables=variables, **kw)
        t_sel = functools.partial(TV.select_pairs_learned_local, model=net,
                                  device="cpu", **kw)
    js, jstats = JS.run_sweep(scene.images, scene.Ps, scene.bbox_min,
                              scene.bbox_max, jcfg,
                              JS.photoconsistency_predictor,
                              pair_selector=j_sel)
    ts, tstats = TS.run_sweep(scene.images, scene.Ps, scene.bbox_min,
                              scene.bbox_max, tcfg,
                              TS.photoconsistency_predictor, t_sel,
                              device="cpu")
    pj, _, _ = js.merge()
    pt, _, _ = ts.merge()
    assert len(pt) > 500
    assert tstats.n_cubes_after_prefilter == jstats.n_cubes_after_prefilter
    assert voxel_set_agreement(pt, pj) >= 0.999


def test_consensus_fusion_sweep_runs(scene):
    """``fusion_mode="consensus"`` no longer raises in the port's sweep;
    an unknown mode still does."""
    _, tcfg = _configs(fusion_mode="consensus")
    store, stats = TS.run_sweep(scene.images, scene.Ps, scene.bbox_min,
                                scene.bbox_max, tcfg,
                                TS.photoconsistency_predictor, device="cpu")
    assert stats.n_cubes_nonempty > 0 and len(store.merge()[0]) > 500
    bad = tcfg.replace(fusion=dataclasses.replace(tcfg.fusion,
                                                  fusion_mode="median"))
    with pytest.raises(NotImplementedError):
        TS.run_sweep(scene.images, scene.Ps, scene.bbox_min, scene.bbox_max,
                     bad, TS.photoconsistency_predictor, device="cpu")
