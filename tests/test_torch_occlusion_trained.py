"""Port parity: the occlusion-robust path with the records' trained nets.

``results/occlusion_r04.json`` and ``occlusion_r05.json`` sweep the
occluded golden scene (12 views of 600x800, radius 30) with the trained
paper-width SurfaceNet ``weights/golden_sphere_30k`` at 32^3 cubes of
0.5 mm (overlap 8), 4 pairs, tau 0.7, gamma 0.7, 6 pooling views.  Here
both packages run that configuration on the CPU, each with its own
weights (the reference's Orbax ``weights/golden_sphere_30k`` and
``weights/pairnet_10000``, the port's conversions under
``weights_torch/``), in float32, with the learned-local selector of the
pair net and consensus fusion at deadband 0.1, beta 8 (the record's
``geometric_consensus`` setting), on a block of 2x2x2 cubes on the
occluded hemisphere (+x: views 0, 1 and 11 see the occluder).  The
gather and the vote take their plain forms in both packages (no Pallas
gather, ``ray_pool_mode="affine"``), as the record's script runs on a
CPU backend.

Bounds: the same cubes; point counts within one, the vote's near-tie
allowance (a voxel within ~1e-6 of its ray's maximum may fall either side
of the vote's tolerance in either package); merged voxel sets that agree
on >= 0.999 of their union.
"""

import functools
import os

import jax
import numpy as np
import orbax.checkpoint as ocp
import torch

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, S, HW = 32, 0.5, (600, 800)
# two cubes a side: 16 mm cubes every 12 mm, over the cap x in [16, 30]
BLOCK_MIN = np.array([16.0, -14.0, -14.0])
BLOCK_MAX = BLOCK_MIN + D * S + (D - 8) * S


def test_trained_consensus_learned_local_matches_reference():
    from surfacenet_tpu.config import (
        Config, FusionConfig, ModelConfig, SweepConfig, VoxelConfig,
    )
    from surfacenet_tpu.data.synthetic import make_occluded_scene
    from surfacenet_tpu.models.surfacenet import SurfaceNet
    from surfacenet_tpu.models.surfacenet import make_predictor as j_make
    from surfacenet_tpu.ops.view_pairs import (
        select_pairs_learned_local as j_select,
    )
    from surfacenet_tpu.pipeline.sweep import run_sweep as j_sweep
    from surfacenet_tpu.train.train_pair import restore_pairnet as j_pairnet
    from surfacenet_tpu_torch.cli import make_pair_selector
    from surfacenet_tpu_torch.config import Config as TConfig
    from surfacenet_tpu_torch.models.convert import load_surfacenet
    from surfacenet_tpu_torch.models.surfacenet import make_predictor
    from surfacenet_tpu_torch.pipeline.sweep import run_sweep
    from surfacenet_tpu_torch.utils.metrics import voxel_set_agreement

    jcfg = Config(
        voxel=VoxelConfig(voxel_size_mm=S, cube_size=D, overlap=8),
        sweep=SweepConfig(cube_batch=8),
        fusion=FusionConfig(n_view_pairs=4, tau=0.7, gamma=0.7,
                            ray_pool_mode="affine", n_pool_views=6,
                            fusion_mode="consensus", consensus_deadband=0.1,
                            consensus_beta=8.0),
        model=ModelConfig(dtype="float32"),
    )
    tcfg = TConfig.from_json(jcfg.to_json())
    scene = make_occluded_scene(n_views=12, hw=HW, radius=30.0)
    args = (scene.images, scene.Ps, BLOCK_MIN, BLOCK_MAX)

    # the checkpoint's tree as saved, without load_pretrained's template
    # (whose flax init costs ~15 s on the CPU; the tree is the same,
    # tests/test_torch_weights.py holds the conversion to it bitwise)
    variables = ocp.StandardCheckpointer().restore(
        os.path.join(ROOT, "weights", "golden_sphere_30k"))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    flax_model = SurfaceNet(jcfg.model)
    pmodel, pvars = j_pairnet(os.path.join(ROOT, "weights", "pairnet_10000"),
                              Config())
    store_j, stats_j = j_sweep(
        *args, jcfg, j_make(flax_model, variables, jcfg.model),
        pair_selector=functools.partial(
            j_select, n_pairs=4, image_hw=HW, extent_mm=D * S,
            images=scene.images, model=pmodel, variables=pvars,
            patch_size=32))
    pts_j = np.asarray(store_j.merge()[0])

    net = load_surfacenet(os.path.join(ROOT, "weights_torch",
                                       "golden_sphere_30k.npz"), tcfg.model)
    store_t, stats_t = run_sweep(
        *args, tcfg, make_predictor(net, tcfg.model, "cpu"),
        make_pair_selector(os.path.join(ROOT, "weights_torch",
                                        "pairnet_10000.npz"), tcfg,
                           scene.images, "cpu"), device="cpu")
    pts_t = store_t.merge()[0]

    agree = voxel_set_agreement(pts_t, pts_j)
    print(f"trained occlusion block: port {len(pts_t)} points, reference "
          f"{len(pts_j)}, agreement {agree:.6f} "
          f"({stats_t.n_cubes_nonempty}/{stats_t.n_cubes_after_prefilter} "
          f"cubes non-empty)")
    assert stats_t.n_cubes_total == 8
    assert stats_t.n_cubes_after_prefilter == stats_j.n_cubes_after_prefilter
    assert len(pts_t) > 1000
    assert abs(len(pts_t) - len(pts_j)) <= 1
    assert agree >= 0.999
