"""The port's first end-to-end quality number: trained weights on the CPU.

``weights/golden_sphere_fast64_30k`` (fast64 widths) and
``weights/golden_sphere_30k`` (the paper's widths) are read by the JAX
package's loader for the reference, and the port loads their shipped
conversions ``weights_torch/golden_sphere_fast64_30k.npz`` and
``weights_torch/golden_sphere_30k.npz`` (tests/test_torch_weights.py holds
them bitwise to fresh ones); both packages' ``run_sweep`` then sweep the
selftest-scale golden sphere (8 views of 120x160, 16^3 cubes of 2 mm,
3 pairs, exact pooling) in float32 with that trained SurfaceNet as the
predictor.  The merged voxel sets agree on >= 0.99 of their union, and
accuracy and completeness against 4000 samples of the analytic sphere
agree within 2%.  The reference sweeps once a model, shared by the module.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from surfacenet_tpu_torch.utils.metrics import voxel_set_agreement

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# model -> checkpoint name: "fast64" is the dtu9_full preset's widths,
# "paper" the paper's (ModelConfig())
CHECKPOINTS = {"fast64": "golden_sphere_fast64_30k",
               "paper": "golden_sphere_30k"}


@pytest.fixture(scope="module")
def runs():
    """model -> ((reference points, (acc, comp)), (port points, (acc,
    comp)), the port's SweepStats), each model swept once."""
    from surfacenet_tpu.models.surfacenet import make_predictor as j_make
    from surfacenet_tpu.pipeline.sweep import run_sweep as j_sweep
    from surfacenet_tpu.train.train_surface import load_pretrained
    from surfacenet_tpu.utils.metrics import accuracy_completeness as j_ac
    from surfacenet_tpu_torch.cli import selftest_setup
    from surfacenet_tpu_torch.models.convert import load_surfacenet
    from surfacenet_tpu_torch.models.surfacenet import make_predictor
    from surfacenet_tpu_torch.pipeline.sweep import run_sweep
    from surfacenet_tpu_torch.utils.metrics import accuracy_completeness
    from surfacenet_tpu.config import Config as JConfig

    done = {}

    def get(model):
        if model in done:
            return done[model]
        cfg_t, scene = selftest_setup("sphere")
        widths = type(cfg_t.model)
        widths = widths.fast64() if model == "fast64" else widths()
        cfg_t = cfg_t.replace(model=dataclasses.replace(widths,
                                                        dtype="float32"))
        cfg_j = JConfig.from_json(cfg_t.to_json())
        assert cfg_j.fusion.ray_pool_mode == "exact"
        # parameters do not depend on D: initialise the restore template
        # at 8^3
        init_cfg = cfg_j.replace(voxel=dataclasses.replace(cfg_j.voxel,
                                                           cube_size=8))
        flax_model, variables = load_pretrained(
            os.path.join(ROOT, "weights", CHECKPOINTS[model]), init_cfg)
        variables = jax.tree_util.tree_map(np.asarray, variables)
        net = load_surfacenet(os.path.join(
            ROOT, "weights_torch", CHECKPOINTS[model] + ".npz"), cfg_t.model)
        gt = scene.surface_points(4000)
        args = (scene.images, scene.Ps, scene.bbox_min, scene.bbox_max)

        store_j, _ = j_sweep(*args, cfg_j, j_make(flax_model, variables,
                                                  cfg_j.model))
        pts_j, _, _ = store_j.merge()
        store_t, stats = run_sweep(*args, cfg_t,
                                   make_predictor(net, cfg_t.model, "cpu"),
                                   device="cpu")
        pts_t, _, _ = store_t.merge()
        done[model] = ((pts_j, j_ac(pts_j, gt)), (pts_t, accuracy_completeness(
            pts_t, gt, device="cpu")), stats)
        return done[model]

    return get


def check_voxel_sets_agree(model, run):
    (pts_j, _), (pts_t, _), stats = run
    agree = voxel_set_agreement(pts_t, pts_j)
    print(f"trained {model} sphere: port {len(pts_t)} points, reference "
          f"{len(pts_j)}, agreement {agree:.6f} of the union "
          f"({stats.n_cubes_nonempty}/{stats.n_cubes_after_prefilter} "
          f"cubes non-empty)")
    assert len(pts_t) > 500
    assert agree >= 0.99


def check_accuracy_completeness(model, run):
    (_, (acc_j, comp_j)), (_, (acc_t, comp_t)), _ = run
    print(f"trained {model} sphere: accuracy {acc_t:.4f} mm (reference "
          f"{acc_j:.4f}), completeness {comp_t:.4f} mm (reference "
          f"{comp_j:.4f})")
    assert np.isfinite([acc_t, comp_t]).all()
    np.testing.assert_allclose([acc_t, comp_t], [acc_j, comp_j], rtol=0.02)


def test_trained_fast64_sphere_voxel_sets_agree(runs):
    check_voxel_sets_agree("fast64", runs("fast64"))


def test_trained_fast64_sphere_accuracy_completeness(runs):
    check_accuracy_completeness("fast64", runs("fast64"))


def test_trained_paper_sphere_voxel_sets_agree(runs):
    check_voxel_sets_agree("paper", runs("paper"))


def test_trained_paper_sphere_accuracy_completeness(runs):
    check_accuracy_completeness("paper", runs("paper"))
