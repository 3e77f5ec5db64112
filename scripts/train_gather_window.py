"""What the JAX package's TPU training gather leaves out: voxels that its
crop and chunk windows mark invalid where the oracle gather, and so the
port's, keeps them valid.

On a TPU, ``surfacenet_tpu/train/train_surface.py::train_surfacenet``
gathers each step's CVC pairs with ``build_cvc_batch_pallas``, whose
kernel reads each item's pixels from a window: a crop of ``crop_hw`` at
the projected cube's corner (``auto_crop_hw``, sized once from the
scene's bounding box at the 32^3 tile) and, with
``sweep.gather_chunk_windows``, a window of ``chunk_hw`` a chunk of 8,192
voxels (``auto_chunk_hw``).  A voxel whose projection falls outside its
window comes back invalid (``ops/pallas/warp_gather.py``'s ``in_crop``).
The oracle, ``ops/cvc.py::build_cvc_batch`` (the CPU's training gather,
the port's semantics), has no window.  Training cubes are drawn around
the surface with a jitter of a quarter cube and their cameras moved by
the augmentation, so they need not lie inside the box the windows were
sized for.

This runs both gathers on the CPU (the kernel in Pallas interpret mode,
bf16 images as on the TPU) on the first STEPS steps of a recipe's own
batches (``scripts/aug_replay_inputs.py``'s draws: the sampler at
``train.seed`` SEED, one key a chunk, the step key's candidate, jitter,
pair and N(0, 1) offsets; STEPS at most the first chunk's), at each
augmentation sigma, and counts per
step the voxels valid in the oracle's pair validity and invalid in the
kernel's (and the reverse), with how many of them are labelled surface.
Prints one JSON line.

    JAX_PLATFORMS=cpu python scripts/train_gather_window.py \\
        [--seed 0] [--steps 4] [--sigmas 0,0.7] [--finetune] [--out F]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import jax.numpy as jnp
import numpy as np

from aug_replay_inputs import record_config, step_draws
from surfacenet_tpu.data.synthetic import make_sphere_scene
from surfacenet_tpu.ops.cvc import build_cvc_batch
from surfacenet_tpu.ops.pallas.warp_gather import (
    auto_chunk_hw, auto_crop_hw, build_cvc_batch_pallas, gather_tile_d,
)
from surfacenet_tpu.train.train_surface import (
    make_device_sampler, perturb_calibration,
)


def windows(scene, cfg):
    """``train_surfacenet``'s crop and chunk windows for one scene."""
    D, s = cfg.voxel.cube_size, cfg.voxel.voxel_size_mm
    td = gather_tile_d(D)
    hw = scene.images.shape[1:3]
    crop = auto_crop_hw(np.asarray(scene.Ps), scene.bbox_min,
                        scene.bbox_max, td, s, hw)
    chunk = (auto_chunk_hw(np.asarray(scene.Ps), scene.bbox_min,
                           scene.bbox_max, td, s, hw, PC=min(td**3, 8192))
             if cfg.sweep.gather_chunk_windows else (0, 0))
    return crop, chunk


def count(recipe="aug", seed=None, steps=4, sigmas=(0.0, 0.7)):
    """The counts of the first ``steps`` steps of ``recipe`` ("aug":
    robustness_aug_r04's, seed 0; "finetune": robustness_ft_r05's, seed
    7) at each augmentation sigma: a dict, as the script prints it."""
    if seed is None:
        seed = 7 if recipe == "finetune" else 0
    cfg = record_config(seed, recipe)
    tc, D, s = cfg.train, cfg.voxel.cube_size, cfg.voxel.voxel_size_mm
    if steps > tc.scan_chunk:
        raise ValueError(f"the first chunk holds {tc.scan_chunk} steps")
    scene = make_sphere_scene(n_views=12, hw=(600, 800), radius=30.0)
    crop, chunk = windows(scene, cfg)
    cand_pts, cand_pairs, surf_fn, surf_params = make_device_sampler(
        scene, cfg, seed=tc.seed)
    key = jax.random.split(jax.random.PRNGKey(tc.seed + 1))[1]
    keys = jax.random.split(key, tc.scan_chunk)[:steps]
    images = jnp.asarray(scene.images, jnp.float32)
    Ps = jnp.asarray(scene.Ps, jnp.float32)
    r = (jnp.arange(D, dtype=jnp.float32) + 0.5) * s
    local = jnp.stack(jnp.meshgrid(r, r, r, indexing="ij"), axis=-1)
    out = {"recipe": recipe, "seed": seed, "steps": steps,
           "crop_hw": list(crop), "chunk_hw": list(chunk), "sigmas": {}}
    t0 = time.perf_counter()
    for sigma in sigmas:
        per_step = []
        for k in keys:
            idx, unit, choice, _ = step_draws(
                k, n_cand=cand_pts.shape[0], n_pairs=cand_pairs.shape[1],
                batch=tc.batch_size, n_views=Ps.shape[0])
            origins = cand_pts[idx] - D * s / 2.0 + (unit * 0.5 - 0.25) * (
                D * s)
            pairs = cand_pairs[idx, choice]
            labels = surf_fn(surf_params, origins[:, None, None, None, :]
                             + local) <= s * float(np.sqrt(3)) / 2.0
            P = (perturb_calibration(Ps, jax.random.split(k, 4)[3], sigma)
                 if sigma > 0 else Ps)
            _, v_oracle = build_cvc_batch(images, P, pairs, origins, D, s,
                                          cfg.voxel.center_colors)
            _, v_kernel = build_cvc_batch_pallas(
                images, P, pairs, origins, D, s, cfg.voxel.center_colors,
                interpret=True, CH=crop[0], CW=crop[1], chunk_hw=chunk)
            lost = np.asarray(v_oracle & ~v_kernel)
            gained = np.asarray(~v_oracle & v_kernel)
            lab = np.asarray(labels)
            per_step.append({
                "oracle_valid": int(np.asarray(v_oracle).sum()),
                "window_lost": int(lost.sum()),
                "window_lost_surface": int((lost & lab).sum()),
                "surface_valid": int((np.asarray(v_oracle) & lab).sum()),
                "kernel_only_valid": int(gained.sum()),
                "items_with_loss": int(lost.any(axis=(1, 2, 3)).sum())})
        tot = {k: sum(p[k] for p in per_step) for k in per_step[0]}
        tot["lost_share"] = tot["window_lost"] / max(tot["oracle_valid"], 1)
        tot["lost_surface_share"] = (tot["window_lost_surface"]
                                     / max(tot["surface_valid"], 1))
        out["sigmas"][str(sigma)] = {"total": tot, "per_step": per_step}
    out["seconds"] = time.perf_counter() - t0
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--sigmas", default="0,0.7")
    ap.add_argument("--finetune", action="store_true",
                    help="robustness_ft_r05's recipe (seed 7, chunks of 25)")
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    line = json.dumps(count("finetune" if a.finetune else "aug", a.seed,
                            a.steps, [float(x) for x in a.sigmas.split(",")]))
    if a.out:
        with open(a.out, "w") as f:
            f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
