"""The JAX package's own random inputs to results/robustness_aug_r04.json's
two training runs, or to the same recipe at another ``train.seed``,
written for ``scripts/torch_aug_replay.py``; with ``--finetune``, to
results/robustness_ft_r05.json's three fine-tunes instead.

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

``--finetune``: ``scripts/calib_finetune_eval.py``'s recipe, which starts
each arm from ``weights/golden_sphere_30k`` (the port from its
conversion, ``weights_torch/golden_sphere_30k.npz``), so no init.npz;
SEED defaults to its 7 and a chunk is 25 steps.  The arms' 1,000, 3,000
and 6,000 steps draw from one stream, so the 6,000 steps' draws serve
all three, each the first as many; draws.npz also holds
``recipe="finetune"``.

    JAX_PLATFORMS=cpu python scripts/aug_replay_inputs.py OUT_DIR [SEED] \
        [--finetune]
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
# train.scan_chunk of each recipe: calib_aug_eval.py's, calib_finetune_eval.py's
CHUNK = {"aug": 250, "finetune": 25}


def record_config(seed, recipe="aug"):
    """``scripts/calib_aug_eval.py``'s ``base`` at 6,000 steps, with the
    recipe's chunk (the draws depend on nothing else of the config)."""
    return Config(
        voxel=VoxelConfig(voxel_size_mm=0.5, cube_size=32, overlap=8),
        sweep=SweepConfig(cube_batch=32),
        fusion=FusionConfig(n_view_pairs=4, tau=0.7, gamma=0.7,
                            ray_pool_mode="affine", n_pool_views=6),
        train=TrainConfig(batch_size=16, n_steps=N_STEPS,
                          lr_decay="cosine", seed=seed,
                          scan_chunk=CHUNK[recipe]),
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


def step_keys(tc, n_steps):
    """``train_surfacenet``'s step keys on the scan path for its first
    ``n_steps`` steps at ``train`` config ``tc``: ``PRNGKey(seed + 1)``,
    one ``split`` a chunk of ``tc.scan_chunk`` steps, ``split(sub, K)``
    within it.  (n_steps, 2) uint32."""
    key, parts = jax.random.PRNGKey(tc.seed + 1), []
    for done in range(0, n_steps, tc.scan_chunk):
        key, sub = jax.random.split(key)
        parts.append(jax.random.split(sub, min(tc.scan_chunk,
                                               n_steps - done)))
    return jnp.concatenate(parts)


def recipe_draws(tc, n_steps, *, n_cand, n_pairs, n_views):
    """Each of those steps' ``step_draws``: (idx (n, B) int32, unit (n, B,
    3) float32, choice (n, B) int32, normal (n, V, 2) float32)."""
    draw = jax.jit(jax.vmap(lambda k: step_draws(
        k, n_cand=n_cand, n_pairs=n_pairs, batch=tc.batch_size,
        n_views=n_views)))
    return tuple(np.asarray(a) for a in draw(step_keys(tc, n_steps)))


def main(out_dir, seed=None, recipe="aug"):
    os.makedirs(out_dir, exist_ok=True)
    if seed is None:
        seed = 7 if recipe == "finetune" else 0
    cfg = record_config(int(seed), recipe)
    tc = cfg.train
    scene = make_sphere_scene(n_views=12, hw=(600, 800), radius=30.0)
    state = None
    if recipe == "aug":
        _, state = create_train_state(cfg, jax.random.PRNGKey(tc.seed))
        np.savez(os.path.join(out_dir, "init.npz"),
                 **flat(state.params, "params"),
                 **flat(state.batch_stats, "batch_stats"))
    cand_pts, cand_pairs, _, _ = make_device_sampler(scene, cfg,
                                                     seed=tc.seed)
    idx, unit, choice, normal = recipe_draws(
        tc, N_STEPS, n_cand=cand_pts.shape[0], n_pairs=cand_pairs.shape[1],
        n_views=scene.Ps.shape[0])
    # the jitter as the reference's body computes it, from the same key
    k2 = jax.random.split(jax.random.split(jax.random.split(
        jax.random.PRNGKey(tc.seed + 1))[1], tc.scan_chunk)[0], 4)[1]
    want = jax.random.uniform(k2, (tc.batch_size, 3), minval=-0.25,
                              maxval=0.25)
    assert np.array_equal(unit[0] * np.float32(0.5) - np.float32(0.25),
                          np.asarray(want))
    np.savez(os.path.join(out_dir, "draws.npz"), idx=idx, unit=unit,
             choice=choice, normal=normal, cand_pts=np.asarray(cand_pts),
             cand_pairs=np.asarray(cand_pairs), seed=np.int64(tc.seed),
             recipe=recipe)
    print(f"{out_dir}: {len(idx)} steps of draws ({recipe}, seed "
          f"{tc.seed}, chunks of {tc.scan_chunk})" + ("" if state is None else
          f", {sum(v.size for v in flat(state.params, 'p').values())} "
          f"initial parameters"))


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--finetune"]
    main(*args, recipe="finetune" if "--finetune" in sys.argv else "aug")
