"""Port parity: one cube batch step and the whole sweep.

``cube_batch_step`` against the reference's kernel path (Pallas gather and
Pallas affine vote in interpret mode, windows covering the images):
occupancy agreement >= 0.995; with the float32 gather, fused probability
within 1e-4; with the int8 gather, the bounds stated in the test.
``run_sweep`` end to end against the reference's CPU sweep: voxel-set
agreement >= 0.99 of the exported points.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import surfacenet_tpu.pipeline.sweep as J
import surfacenet_tpu_torch.pipeline.sweep as T
from surfacenet_tpu.config import (
    Config, FusionConfig, ModelConfig, SweepConfig, VoxelConfig,
)
from surfacenet_tpu_torch.config import Config as TConfig
from surfacenet_tpu_torch.utils.metrics import voxel_set_agreement

torch.set_num_threads(2)

D, S = 16, 2.0


@pytest.fixture(scope="module")
def scene():
    from surfacenet_tpu.data.synthetic import make_sphere_scene

    return make_sphere_scene(n_views=4, hw=(96, 128))


@pytest.fixture(scope="module")
def batch(scene):
    from surfacenet_tpu.ops.view_pairs import (
        dedup_view_slots, select_pairs_geometric,
    )

    origins = np.array([[-16.0, -16.0, -16.0], [0.0, 0.0, -16.0],
                        [-16.0, 0.0, 0.0], [0.0, 0.0, 0.0]], np.float32)
    hw = scene.images.shape[1:3]
    pair_idx, pair_w = select_pairs_geometric(scene.Ps, origins, 2, hw,
                                              extent_mm=D * S)
    uniq, slots = dedup_view_slots(pair_idx)
    grid = np.array([[0, 0, 0], [1, 1, 0], [0, 1, 1], [1, 1, 1]])
    core = J.core_bounds_for(grid, np.array([1, 1, 1]), D, 8, present=grid)
    return dict(origins=origins, pair_idx=np.asarray(pair_idx, np.int32),
                pair_w=np.asarray(pair_w, np.float32), core_bounds=core,
                uniq_views=uniq, slot_idx=slots)


def _port_args(batch):
    """The port's batch arguments: the reference's without ``pair_idx``."""
    return {k: torch.tensor(v) for k, v in batch.items() if k != "pair_idx"}


def _tiny_predictors():
    """The same tiny float32 SurfaceNet weights on both sides."""
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


@pytest.mark.parametrize("predictor,adaptive,gather", [
    ("photoconsistency", False, "float32"), ("tiny_net", False, "float32"),
    ("photoconsistency", True, "float32"),
    ("photoconsistency", False, "int8"),
], ids=["photoconsistency-False", "tiny_net-False", "photoconsistency-True",
        "photoconsistency-False-int8"])
def test_cube_batch_step_matches_pallas_path(scene, batch, predictor,
                                             adaptive, gather):
    """float32 gather: fused and colour within 1e-4.  int8 gather (both
    sides sample the same int8 image with 7-bit vertical weights): the
    reference projects with a Newton-refined reciprocal, the port divides,
    so u and v may differ by an ulp; that moves a colour by <= 1e-5
    (measured 5.1e-6), and where it moves round(127 dv) by one step, by up
    to 1/127 (< 8e-3) on a few voxels.  Those few voxels move the
    photoconsistency probability by up to ~1e-2 (measured 1.36e-3 max, on
    0.018% of voxels); elsewhere fused agrees within 1e-4."""
    if predictor == "photoconsistency":
        j_pred, t_pred = J.photoconsistency_predictor, \
            T.photoconsistency_predictor
    else:
        j_pred, t_pred = _tiny_predictors()
    H, W = scene.images.shape[1:3]
    kw = dict(D=D, s=S, n_pairs=2, tau=0.3, gamma=0.6, adaptive=adaptive,
              center_colors=True, n_pool_views=3, pool_window=2)
    ref = J.cube_batch_step(
        jnp.asarray(scene.images), jnp.asarray(scene.Ps, jnp.float32),
        **{k: jnp.asarray(v) for k, v in batch.items()}, predict=j_pred,
        use_pallas=True,
        ray_pool_mode="affine_pallas", pallas_interpret=True,
        crop_hw=(H, W), gather_dtype=gather, **kw,
    )
    got = T.cube_batch_step(
        T.gather_images(torch.tensor(scene.images), T.GATHER_DTYPES[gather]),
        torch.tensor(scene.Ps, dtype=torch.float32),
        **_port_args(batch), predict=t_pred, ray_pool_mode="affine", **kw,
    )
    occ_j, fused_j, color_j = (np.asarray(a) for a in ref)
    occ_t, fused_t, color_t = (a.numpy() for a in got)
    assert occ_t.shape == (4, D, D, D) and color_t.shape == (4, D, D, D, 3)
    assert (occ_t == occ_j).mean() >= 0.995
    assert occ_t.any()
    d_fused = np.abs(fused_t - fused_j)
    d_color = np.abs(color_t - color_j)
    if gather == "float32":
        assert d_fused.max() <= 1e-4
        assert d_color.max() <= 1e-4
    else:
        assert (d_fused <= 1e-4).mean() >= 0.999 and d_fused.max() <= 1e-2
        assert (d_color <= 1e-5).mean() >= 0.999 and d_color.max() <= 8e-3


def test_cube_batch_step_fused_inference_matches_reference(scene, batch):
    """The fused-inference SurfaceNet in the batch step: the reference's
    ``fused_infer_apply`` (Pallas conv in interpret mode) against the
    port's fused predictor on the CPU (the conv kernel's plain version),
    the same tiny weights with non-identity BatchNorm statistics."""
    from surfacenet_tpu.models.surfacenet import SurfaceNet as JNet
    from surfacenet_tpu.models.surfacenet import fused_infer_apply
    from surfacenet_tpu_torch.models.convert import params_from_jax
    from surfacenet_tpu_torch.models.surfacenet import (
        SurfaceNet, make_predictor,
    )

    jcfg = dataclasses.replace(ModelConfig.tiny(), fused_inference=True)
    jnet = JNet(jcfg)
    variables = jax.jit(lambda k, x: jnet.init(k, x, train=False))(
        jax.random.PRNGKey(3), jnp.zeros((1, 8, 8, 8, 6)))
    rng = np.random.default_rng(4)
    variables = {
        "params": jax.tree_util.tree_map(np.asarray, variables["params"]),
        "batch_stats": jax.tree_util.tree_map(
            lambda v: rng.uniform(0.5, 1.5, v.shape).astype(np.float32),
            variables["batch_stats"]),
    }

    def j_pred(x, origins):
        return fused_infer_apply(jcfg, variables, x, interpret=True)

    tcfg = TConfig.from_json(Config(model=jcfg).to_json()).model
    assert tcfg.fused_inference
    net = SurfaceNet(tcfg)
    net.load_state_dict(params_from_jax(variables))
    t_pred = make_predictor(net, tcfg, "cpu")
    H, W = scene.images.shape[1:3]
    kw = dict(D=D, s=S, n_pairs=2, tau=0.3, gamma=0.6, adaptive=False,
              center_colors=True, n_pool_views=3, pool_window=2)
    ref = J.cube_batch_step(
        jnp.asarray(scene.images), jnp.asarray(scene.Ps, jnp.float32),
        **{k: jnp.asarray(v) for k, v in batch.items()}, predict=j_pred,
        use_pallas=True, ray_pool_mode="affine_pallas",
        pallas_interpret=True, crop_hw=(H, W), gather_dtype="float32", **kw,
    )
    got = T.cube_batch_step(
        torch.tensor(scene.images), torch.tensor(scene.Ps,
                                                 dtype=torch.float32),
        **_port_args(batch), predict=t_pred, ray_pool_mode="affine", **kw,
    )
    occ_j, fused_j, color_j = (np.asarray(a) for a in ref)
    occ_t, fused_t, color_t = (a.numpy() for a in got)
    # the unfused case's tolerances hold: the bf16 conv needs no widening
    # here (the plain conv rounds to the Pallas conv's bf16 values)
    assert np.abs(fused_t - fused_j).max() <= 1e-4
    assert (occ_t == occ_j).mean() >= 0.995
    assert occ_t.any()
    assert np.abs(color_t - color_j).max() <= 1e-4


def test_compact_records_round_trip_like_reference(scene, batch):
    kw = dict(D=D, s=S, n_pairs=2, tau=0.3, gamma=0.6, adaptive=False,
              center_colors=True, n_pool_views=3, pool_window=2,
              compact_k=300, ray_pool_mode="affine")
    images = torch.tensor(scene.images)
    Ps = torch.tensor(scene.Ps, dtype=torch.float32)
    args = _port_args(batch)
    occ, fused, color = T.cube_batch_step(
        images, Ps, **args, predict=T.photoconsistency_predictor, **kw)
    rec, counts = T.cube_batch_step(
        images, Ps, **args, predict=T.photoconsistency_predictor,
        compact_output=True, **kw)
    assert rec.dtype == torch.uint8 and rec.shape == (4, 300, 7)
    np.testing.assert_array_equal(counts.numpy(),
                                  occ.reshape(4, -1).sum(1).numpy())
    # the reference's record builder on the same dense volumes
    idx_bits = (D ** 3 - 1).bit_length()
    rec_j, counts_j = J._compact_records(
        jnp.asarray(occ.numpy()), jnp.asarray(fused.numpy()),
        jnp.asarray(color.numpy()), D=D, K=300, idx_bits=idx_bits)
    np.testing.assert_array_equal(rec.numpy(), np.asarray(rec_j))
    o, f, c = T.unpack_compact(rec.numpy(), counts.numpy(), D)
    full = counts.numpy() <= 300
    np.testing.assert_array_equal(o[full], occ.numpy()[full])
    assert np.abs(f[full][o[full]] - fused.numpy()[full][o[full]]).max() \
        <= 0.5 / 255 + 1e-6


def test_cube_batch_step_pooling_default_matches_reference():
    """A caller that leaves out ``ray_pool_mode`` pools the same way in
    both packages."""
    import inspect

    def default(fn):
        return inspect.signature(fn).parameters["ray_pool_mode"].default

    assert default(T.cube_batch_step) == default(J.cube_batch_step)


def _configs(**sweep_kw):
    cfg = Config(
        voxel=VoxelConfig(cube_size=D, voxel_size_mm=S, overlap=4),
        fusion=FusionConfig(n_view_pairs=2, tau=0.25, ray_pool_mode="affine"),
        sweep=SweepConfig(cube_batch=8, **sweep_kw),
    )
    return cfg, TConfig.from_json(cfg.to_json())


def test_run_sweep_matches_reference(scene):
    jcfg, tcfg = _configs(compact_k=20)  # small: exercises the re-fetch
    js, jstats = J.run_sweep(scene.images, scene.Ps, scene.bbox_min,
                             scene.bbox_max, jcfg,
                             J.photoconsistency_predictor)
    ts, tstats = T.run_sweep(scene.images, scene.Ps, scene.bbox_min,
                             scene.bbox_max, tcfg,
                             T.photoconsistency_predictor, device="cpu")
    pj, _, cj = js.merge()
    pt, _, ct = ts.merge()
    assert len(pt) > 200
    assert tstats.n_cubes_after_prefilter == jstats.n_cubes_after_prefilter
    assert tstats.n_cubes_nonempty == jstats.n_cubes_nonempty
    assert tstats.n_refetched > 0
    assert voxel_set_agreement(pt, pj) >= 0.99


def test_run_sweep_with_refinement_and_kernel_path_config(scene):
    """The preset's switches (kernel-path gather in bf16, affine_pallas,
    refinement on) run on the CPU through the plain versions."""
    _, tcfg = _configs(use_pallas_gather=True, refine_calib=True,
                       refine_calib_steps=2, refine_calib_probes=128)
    tcfg = tcfg.replace(fusion=dataclasses.replace(
        tcfg.fusion, ray_pool_mode="affine_pallas"))
    assert T.sweep_gather_dtype(tcfg) == torch.bfloat16
    store, stats = T.run_sweep(scene.images, scene.Ps, scene.bbox_min,
                               scene.bbox_max, tcfg,
                               T.photoconsistency_predictor, device="cpu")
    assert stats.refine_info["passes"] >= 1
    assert stats.Ps.dtype == np.float32  # refined, as the reference's
    pts, probs, colors = store.merge()
    assert len(pts) > 200 and np.isfinite(pts).all()
    assert ((0 <= colors) & (colors <= 1)).all()


def test_sweep_rejects_unported_branches(scene):
    """``fusion_mode="median"`` is not ported and raises.  The two other
    cases this test once refused now run: ``ray_pool_mode="affine_matmul"``
    gives the points of the affine vote (``affine_pallas``), and
    ``mesh.block_axis=2`` sweeps on one device, as the reference's
    ``run_sweep`` does, with block_axis 1's points."""
    _, tcfg = _configs()

    def points(cfg):
        store, _ = T.run_sweep(scene.images, scene.Ps, scene.bbox_min,
                               scene.bbox_max, cfg,
                               T.photoconsistency_predictor, device="cpu")
        pts = store.merge()[0]
        return pts[np.lexsort(pts.T)]

    with pytest.raises(NotImplementedError):
        points(tcfg.replace(fusion=dataclasses.replace(
            tcfg.fusion, fusion_mode="median")))
    vote = points(tcfg.replace(fusion=dataclasses.replace(
        tcfg.fusion, ray_pool_mode="affine_pallas")))
    matmul = points(tcfg.replace(fusion=dataclasses.replace(
        tcfg.fusion, ray_pool_mode="affine_matmul")))
    assert len(vote) > 100
    np.testing.assert_array_equal(matmul, vote)
    np.testing.assert_array_equal(
        points(tcfg.replace(mesh=dataclasses.replace(tcfg.mesh,
                                                      block_axis=2))),
        points(tcfg))


def test_host_planning_matches_reference():
    jcfg, tcfg = _configs()
    lo, hi = np.array([-40.0, -35.0, -30.0]), np.array([40.0, 30.0, 45.0])
    g_t, o_t = T.enumerate_cubes(lo, hi, tcfg)
    g_j, o_j = J.enumerate_cubes(lo, hi, jcfg)
    np.testing.assert_array_equal(g_t, g_j)
    np.testing.assert_array_equal(o_t, o_j)
    present = g_t[np.random.default_rng(0).uniform(size=len(g_t)) > 0.3]
    for pres in (None, present):
        np.testing.assert_array_equal(
            T.core_bounds_for(g_t, g_t.max(0), D, 4, present=pres),
            J.core_bounds_for(g_t, g_t.max(0), D, 4, present=pres),
        )
    for w, ov in ((-1, 8), (-1, 1), (1, 8)):
        c = jcfg.replace(
            voxel=dataclasses.replace(jcfg.voxel, overlap=ov),
            fusion=dataclasses.replace(jcfg.fusion, pool_window_vox=w))
        assert T.resolve_pool_window(TConfig.from_json(c.to_json())) == \
            J.resolve_pool_window(c)
    for k in (0, 100):
        assert T.resolve_compact_k(k, 64) == J._resolve_compact_k(k, 64)


@pytest.mark.parametrize("vote", [0.0, 0.5, 0.7])
def test_sparse_store_merge_matches_reference(vote):
    """Overlapping cubes, some processed but empty: the occupancy vote over
    containing cubes, and the probability/colour averages."""
    from surfacenet_tpu.pipeline.sparse import CubeResult as JResult
    from surfacenet_tpu.pipeline.sparse import SparseCubeStore as JStore
    from surfacenet_tpu_torch.pipeline.sparse import (
        CubeResult, SparseCubeStore,
    )

    rng = np.random.default_rng(5)
    Dc, stride = 8, 6
    kw = dict(scene_origin=np.array([-3.0, 1.0, 2.0]), voxel_size_mm=0.5,
              cube_size=Dc, stride=stride, occupancy_vote=vote)
    js, ts = JStore(**kw), SparseCubeStore(**kw)
    for g in [(0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 1), (2, 0, 1)]:
        occ = rng.uniform(size=(Dc,) * 3) > (0.6 if g != (2, 0, 1) else 1.1)
        prob = rng.uniform(size=(Dc,) * 3).astype(np.float32)
        col = rng.uniform(size=(Dc,) * 3 + (3,)).astype(np.float32)
        js.add(JResult(g, occ, prob, col))
        ts.add(CubeResult(g, occ, prob, col))
    pj, qj, cj = js.merge()
    pt, qt, ct = ts.merge()
    oj, ot = np.lexsort(pj.T), np.lexsort(pt.T)
    np.testing.assert_array_equal(pt[ot], pj[oj])
    np.testing.assert_allclose(qt[ot], qj[oj], atol=1e-6)
    np.testing.assert_allclose(ct[ot], cj[oj], atol=1e-6)
    assert len(pt) > 0
