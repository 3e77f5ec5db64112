"""The JAX package's own random inputs to results/robustness_aug_r04.json's
two training runs, or to the same recipe at another ``train.seed``,
written for ``scripts/torch_aug_replay.py``.

``scripts/calib_aug_eval.py 6000`` trains both arms with
``train_surfacenet`` from ``create_train_state(cfg, PRNGKey(0))`` on the
scan path: ``key = PRNGKey(seed + 1)``, one ``split`` a chunk of 250
steps, and in ``train_steps_scan``'s body one ``split(k, 4)`` a step into
the candidate draw, the jitter, the pair draw and the augmentation's
N(0, 1) offsets.  This script makes the same initial variables and the
same per-step draws on the CPU (threefry gives every backend the same
bits) and writes them as numpy arrays:

  init.npz   the initial variables, keys "params/<path>" and
             "batch_stats/<path>" (flax's nesting joined by "/")
  draws.npz  idx (steps, B) int32, unit (steps, B, 3) float32 (the
             jitter's uniform in [0, 1): the step's jitter is
             (unit * 0.5 - 0.25) D s, bit for bit the reference's),
             choice (steps, B) int32, normal (steps, V, 2) float32, the
             sampler's tables cand_pts (N, 3), cand_pairs (N, k, 2), and
             the seed

Both arms take the same draws (the clean arm leaves ``normal`` unused).
SEED (default 0, the record's) is ``train.seed``: the initial key, the
sampler's seed, and one less than the step keys' seed.

    JAX_PLATFORMS=cpu python scripts/aug_replay_inputs.py OUT_DIR [SEED]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from surfacenet_tpu.config import (
    Config, FusionConfig, SweepConfig, TrainConfig, VoxelConfig,
)
from surfacenet_tpu.data.synthetic import make_sphere_scene
from surfacenet_tpu.train.train_surface import (
    create_train_state, make_device_sampler,
)

N_STEPS = 6000


def record_config(seed):
    """``scripts/calib_aug_eval.py``'s ``base`` at 6,000 steps."""
    return Config(
        voxel=VoxelConfig(voxel_size_mm=0.5, cube_size=32, overlap=8),
        sweep=SweepConfig(cube_batch=32),
        fusion=FusionConfig(n_view_pairs=4, tau=0.7, gamma=0.7,
                            ray_pool_mode="affine", n_pool_views=6),
        train=TrainConfig(batch_size=16, n_steps=N_STEPS,
                          lr_decay="cosine", seed=seed, scan_chunk=250),
    )


def flat(tree, prefix):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = "/".join(str(getattr(p, "key", p)) for p in path)
        out[f"{prefix}/{name}"] = np.asarray(leaf)
    return out


def step_draws(k, *, n_cand, n_pairs, batch, n_views):
    """``train_steps_scan``'s body's draws from its step key ``k``."""
    k1, k2, k3, k_aug = jax.random.split(k, 4)
    return (jax.random.randint(k1, (batch,), 0, n_cand),
            jax.random.uniform(k2, (batch, 3)),
            jax.random.randint(k3, (batch,), 0, n_pairs),
            jax.random.normal(k_aug, (n_views, 2), jnp.float32))


def main(out_dir, seed=0):
    os.makedirs(out_dir, exist_ok=True)
    cfg = record_config(int(seed))
    tc = cfg.train
    scene = make_sphere_scene(n_views=12, hw=(600, 800), radius=30.0)
    _, state = create_train_state(cfg, jax.random.PRNGKey(tc.seed))
    np.savez(os.path.join(out_dir, "init.npz"),
             **flat(state.params, "params"),
             **flat(state.batch_stats, "batch_stats"))
    cand_pts, cand_pairs, _, _ = make_device_sampler(scene, cfg,
                                                     seed=tc.seed)
    draw = jax.jit(jax.vmap(lambda k: step_draws(
        k, n_cand=cand_pts.shape[0], n_pairs=cand_pairs.shape[1],
        batch=tc.batch_size, n_views=scene.Ps.shape[0])))
    key, parts = jax.random.PRNGKey(tc.seed + 1), []
    for done in range(0, N_STEPS, tc.scan_chunk):
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, min(tc.scan_chunk, N_STEPS - done))
        parts.append([np.asarray(a) for a in draw(keys)])
    idx, unit, choice, normal = (np.concatenate(p) for p in zip(*parts))
    # the jitter as the reference's body computes it, from the same key
    k2 = jax.random.split(jax.random.split(jax.random.split(
        jax.random.PRNGKey(tc.seed + 1))[1], tc.scan_chunk)[0], 4)[1]
    want = jax.random.uniform(k2, (tc.batch_size, 3), minval=-0.25,
                              maxval=0.25)
    assert np.array_equal(unit[0] * np.float32(0.5) - np.float32(0.25),
                          np.asarray(want))
    np.savez(os.path.join(out_dir, "draws.npz"), idx=idx, unit=unit,
             choice=choice, normal=normal, cand_pts=np.asarray(cand_pts),
             cand_pairs=np.asarray(cand_pairs), seed=np.int64(tc.seed))
    print(f"{out_dir}: {len(idx)} steps of draws, "
          f"{sum(v.size for v in flat(state.params, 'p').values())} "
          f"initial parameters")


if __name__ == "__main__":
    main(*sys.argv[1:])
