"""Port parity: the calibration-robust path with the records' trained net.

``results/robustness_r04.json``, ``robustness_r05.json`` and
``adaptive_r03.json`` sweep the op-point sphere (12 views of 600x800,
radius 30, focal 200) and its ``degrade_scene(clean, seed=1, ...)``
copies with the trained paper-width SurfaceNet
``weights/golden_sphere_30k`` at 32^3 cubes of 0.5 mm (overlap 8), 4
pairs, gamma 0.7, 6 pooling views: the prepass off and on, fixed and
adaptive thresholds.  Here both packages run that configuration on the
CPU, each with its own weights (the reference's Orbax checkpoint, the
port's conversion ``weights_torch/golden_sphere_30k.npz``), in float32,
on a block of 2x2x2 cubes over the sphere's +x cap.  The gather and the
vote take their plain forms in both packages (no Pallas gather,
``ray_pool_mode="affine"``), as the records' scripts run on a CPU
backend.

Bounds: ``degrade_scene`` bitwise; the prepass's per-view shifts within
0.05 px of the reference's (as ``tests/test_torch_refine.py``) and its
RMS residual against the injected shifts within 0.02 px of it; the
sweeps' point counts within one, the vote's near-tie allowance (ROADMAP
C5), and merged voxel sets that agree on >= 0.999 of their union.
"""

import importlib.util
import os

import jax
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from surfacenet_tpu.data import synthetic as jsyn
from surfacenet_tpu_torch.data import synthetic as tsyn

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, S = 32, 0.5
SCENE = dict(n_views=12, hw=(600, 800), radius=30.0, focal=200.0)
# two cubes a side: 16 mm cubes every 12 mm, over the cap x in [16, 30]
BLOCK_MIN = np.array([16.0, -14.0, -14.0])
BLOCK_MAX = BLOCK_MIN + D * S + (D - 8) * S
# the injected shifts and the RMS residual as the parity record computes
# them (scripts/refine_degraded_parity.py)
_spec = importlib.util.spec_from_file_location(
    "refine_degraded_parity",
    os.path.join(ROOT, "scripts", "refine_degraded_parity.py"))
parity = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(parity)
# scripts/robustness_eval.py's combined row
COMBINED = dict(noise_std=0.01, exposure_jitter=0.15, wb_jitter=0.05,
                n_clutter=4, calib_sigma_px=0.5)


@pytest.fixture(scope="module")
def clean():
    """(the reference's clean scene, the port's)."""
    return jsyn.make_sphere_scene(**SCENE), tsyn.make_sphere_scene(**SCENE)


@pytest.fixture(scope="module")
def nets():
    """Both packages' float32 predictors of ``golden_sphere_30k`` and
    their configs at the records' flags, for ``fusion`` keywords."""
    from surfacenet_tpu.config import (
        Config, FusionConfig, ModelConfig, SweepConfig, VoxelConfig,
    )
    from surfacenet_tpu.models.surfacenet import SurfaceNet
    from surfacenet_tpu.models.surfacenet import make_predictor as j_make
    from surfacenet_tpu_torch.config import Config as TConfig
    from surfacenet_tpu_torch.models.convert import load_surfacenet
    from surfacenet_tpu_torch.models.surfacenet import make_predictor

    def configs(**fusion_kw):
        jcfg = Config(
            voxel=VoxelConfig(voxel_size_mm=S, cube_size=D, overlap=8),
            sweep=SweepConfig(cube_batch=8),
            fusion=FusionConfig(n_view_pairs=4, gamma=0.7,
                                ray_pool_mode="affine", n_pool_views=6,
                                **fusion_kw),
            model=ModelConfig(dtype="float32"),
        )
        return jcfg, TConfig.from_json(jcfg.to_json())

    jcfg, tcfg = configs(tau=0.7)
    # the checkpoint's tree as saved (tests/test_torch_weights.py holds
    # the conversion to it bitwise)
    variables = ocp.StandardCheckpointer().restore(
        os.path.join(ROOT, "weights", "golden_sphere_30k"))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    j_pred = j_make(SurfaceNet(jcfg.model), variables, jcfg.model)
    net = load_surfacenet(os.path.join(ROOT, "weights_torch",
                                       "golden_sphere_30k.npz"), tcfg.model)
    return j_pred, make_predictor(net, tcfg.model, "cpu"), configs


def _sweep_both(nets, images, Ps, **fusion_kw):
    """Both packages' sweeps of the block: (port points, reference
    points, port stats, reference stats)."""
    from surfacenet_tpu.pipeline.sweep import run_sweep as j_sweep
    from surfacenet_tpu_torch.pipeline.sweep import run_sweep

    j_pred, t_pred, configs = nets
    jcfg, tcfg = configs(**fusion_kw)
    args = (images, Ps, BLOCK_MIN, BLOCK_MAX)
    store_j, stats_j = j_sweep(*args, jcfg, j_pred)
    store_t, stats_t = run_sweep(*args, tcfg, t_pred, device="cpu")
    return (store_t.merge()[0], np.asarray(store_j.merge()[0]), stats_t,
            stats_j)


def _hold(pts_t, pts_j, stats_t, stats_j, name):
    from surfacenet_tpu_torch.utils.metrics import voxel_set_agreement

    agree = voxel_set_agreement(pts_t, pts_j)
    print(f"{name}: port {len(pts_t)} points, reference {len(pts_j)}, "
          f"agreement {agree:.6f} ({stats_t.n_cubes_nonempty}/"
          f"{stats_t.n_cubes_after_prefilter} cubes non-empty)")
    assert stats_t.n_cubes_total == 8
    assert stats_t.n_cubes_after_prefilter == stats_j.n_cubes_after_prefilter
    assert len(pts_t) > 1000
    assert abs(len(pts_t) - len(pts_j)) <= 1
    assert agree >= 0.999


@pytest.mark.parametrize("kw", [
    COMBINED, dict(noise_std=0.05), dict(exposure_jitter=0.4),
    dict(wb_jitter=0.1), dict(n_clutter=10), dict(calib_sigma_px=2.0),
], ids=["combined_dtu_like", "noise", "exposure", "white_balance",
        "clutter", "calibration"])
def test_degrade_scene_bitwise_on_the_record_sphere(clean, kw):
    ref = jsyn.degrade_scene(clean[0], seed=1, **kw)
    got = tsyn.degrade_scene(clean[1], seed=1, **kw)
    np.testing.assert_array_equal(got.images, ref.images)
    np.testing.assert_array_equal(got.Ps, ref.Ps)
    assert got.images.dtype == ref.images.dtype == np.float32
    assert got.Ps.dtype == ref.Ps.dtype == np.float64


def test_trained_prepass_on_miscalibrated_sphere_matches_reference(
        clean, nets):
    """The prepass at the presets' schedule (80 Adam steps a level and
    phase, 2048 probes) on the sigma 0.5 px scene (its whole bbox, as
    ``run_sweep`` calls it), then both sweeps of the block with the
    prepass off on the reference's refined matrices.

    Shorter schedules and fewer probes make no parity case here: on the
    sigma 1 px scene the reference's own one-ulp spread is 0.28 px at 5
    steps a level and 0.30 px at 10 (2048 probes), and at 512 or 1024
    probes both packages drift to shifts of 2-20 px.  At the full
    schedule sigma 1 takes two passes and differs by 0.083 px, beside
    the reference's one-ulp spread of 0.075 px
    (``results/refine_degraded_parity.json``, which ``chip_smoke.py``
    holds the card to); sigma 0.5 takes one pass in both packages and
    keeps within the 0.05 px of ``tests/test_torch_refine.py``."""
    import surfacenet_tpu.geometry.refine as J
    import surfacenet_tpu_torch.geometry.refine as T

    sc = jsyn.degrade_scene(clean[0], calib_sigma_px=0.5, seed=1)
    kw = dict(steps_per_level=80, n_probes=2048)
    args = (sc.images, sc.Ps, sc.bbox_min, sc.bbox_max)
    P_j, i_j = J.refine_calibration_auto(*args, **kw)
    _, i_t = T.refine_calibration_auto(*args, device="cpu", **kw)
    err = np.abs(np.asarray(i_t["duv_px"]) - np.asarray(i_j["duv_px"]))
    # the injected shifts, to which each correction is the answer
    true = parity.injected_shifts(np.asarray(sc.Ps, np.float64),
                                  np.asarray(clean[0].Ps, np.float64))

    def rms_residual(duv):
        return parity.rms_residual(duv, true)

    rms_t, rms_j = rms_residual(i_t["duv_px"]), rms_residual(i_j["duv_px"])
    print(f"prepass: passes {i_t['passes']} / {i_j['passes']}, largest "
          f"shift {i_t['max_shift_px']:.4f} / {i_j['max_shift_px']:.4f} "
          f"px, largest difference {err.max():.4f} px, RMS residual "
          f"{rms_t:.4f} / {rms_j:.4f} px of {rms_residual(0 * true):.4f}")
    assert i_t["passes"] == i_j["passes"] == 1
    assert i_j["max_shift_px"] > 0.3  # it did move the views
    assert rms_j < 0.8 * rms_residual(0 * true)  # towards the truth
    assert err.max() <= 0.05
    assert abs(rms_t - rms_j) <= 0.02

    _hold(*_sweep_both(nets, sc.images, P_j, tau=0.7), "prepass-off sweep "
          "on the reference's refined matrices")


def test_trained_adaptive_threshold_matches_reference(clean, nets):
    sc = clean[0]
    _hold(*_sweep_both(nets, sc.images, sc.Ps, tau=0.8,
                       adaptive_threshold=True, adaptive_target_density=0.02),
          "adaptive threshold (density 0.02)")
