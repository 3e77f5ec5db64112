"""The port's first end-to-end quality number: trained weights on the CPU.

``weights/golden_sphere_fast64_30k`` is read by the JAX package's loader
for the reference, and the port loads the shipped conversion
``weights_torch/golden_sphere_fast64_30k.npz`` (tests/test_torch_weights.py
holds it bitwise to a fresh one); both packages' ``run_sweep`` then sweep the
selftest-scale golden sphere (8 views of 120x160, 16^3 cubes of 2 mm,
3 pairs, exact pooling) in float32 with that trained SurfaceNet as the
predictor.  The merged voxel sets agree on >= 0.99 of their union, and
accuracy and completeness against 4000 samples of the analytic sphere
agree within 2%.  The reference sweeps once, shared by the module.
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
WEIGHTS = os.path.join(ROOT, "weights", "golden_sphere_fast64_30k")
SHIPPED = os.path.join(ROOT, "weights_torch", "golden_sphere_fast64_30k.npz")


@pytest.fixture(scope="module")
def runs():
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

    cfg_t, scene = selftest_setup("sphere")
    cfg_t = cfg_t.replace(model=dataclasses.replace(
        type(cfg_t.model).fast64(), dtype="float32"))
    cfg_j = JConfig.from_json(cfg_t.to_json())
    assert cfg_j.fusion.ray_pool_mode == "exact"
    # parameters do not depend on D: initialise the restore template at 8^3
    init_cfg = cfg_j.replace(voxel=dataclasses.replace(cfg_j.voxel,
                                                       cube_size=8))
    model, variables = load_pretrained(WEIGHTS, init_cfg)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    net = load_surfacenet(SHIPPED, cfg_t.model)
    gt = scene.surface_points(4000)
    args = (scene.images, scene.Ps, scene.bbox_min, scene.bbox_max)

    store_j, _ = j_sweep(*args, cfg_j, j_make(model, variables,
                                              cfg_j.model))
    pts_j, _, _ = store_j.merge()
    store_t, stats = run_sweep(*args, cfg_t,
                               make_predictor(net, cfg_t.model, "cpu"),
                               device="cpu")
    pts_t, _, _ = store_t.merge()
    return (pts_j, j_ac(pts_j, gt)), (pts_t, accuracy_completeness(
        pts_t, gt, device="cpu")), stats


def test_trained_fast64_sphere_voxel_sets_agree(runs):
    (pts_j, _), (pts_t, _), stats = runs
    agree = voxel_set_agreement(pts_t, pts_j)
    print(f"trained fast64 sphere: port {len(pts_t)} points, reference "
          f"{len(pts_j)}, agreement {agree:.6f} of the union "
          f"({stats.n_cubes_nonempty}/{stats.n_cubes_after_prefilter} "
          f"cubes non-empty)")
    assert len(pts_t) > 500
    assert agree >= 0.99


def test_trained_fast64_sphere_accuracy_completeness(runs):
    (_, (acc_j, comp_j)), (_, (acc_t, comp_t)), _ = runs
    print(f"trained fast64 sphere: accuracy {acc_t:.4f} mm (reference "
          f"{acc_j:.4f}), completeness {comp_t:.4f} mm (reference "
          f"{comp_j:.4f})")
    assert np.isfinite([acc_t, comp_t]).all()
    np.testing.assert_allclose([acc_t, comp_t], [acc_j, comp_j], rtol=0.02)
