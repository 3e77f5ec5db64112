"""Replay results/robustness_aug_r04.json's two training runs on the card
with the JAX package's own initial weights and random draws.

``chip_smoke.py`` phase 25 trains the record's two arms with the port's
own random stream (a ``torch.Generator``), so its nets are other draws
of the recipe than the record's.  This script runs the same phase
(``chip_smoke.training_aug_phase``: 2 x 6,000 steps, each net swept on
the sphere and its ``degrade_scene(seed=1)`` copies, fused and from PNGs)
with the reference's inputs instead, as ``scripts/aug_replay_inputs.py``
writes them on a machine with JAX (for the record's ``train.seed`` 0, or
another):

  * each arm starts from the reference's ``create_train_state(cfg,
    PRNGKey(seed))`` variables, mapped by ``models/convert.py``'s
    ``params_from_jax``;
  * every ``torch.randint`` / ``torch.rand`` / ``torch.randn`` that the
    port's ``sample_device_batch`` and ``train_step`` draw from their
    generator returns the reference step's own draw instead (the
    candidate, the jitter's uniform, the pair, the augmentation's
    N(0, 1) offsets), so the port computes each step's origins, labels
    and perturbed cameras from the reference's numbers.

The package is not changed: the draws are fed by replacing the three
functions while ``train_surfacenet`` runs.  What still differs from the
record is the float order (bf16 convolutions on the card, not the TPU)
and the sampler's pair tables where the two packages' pair scores
near-tie (reported).  The phase's gates are reported, not raised.
Prints the phase's readings as one JSON line, last.

Inputs written with ``--finetune`` replay results/robustness_ft_r05.json
instead: ``chip_smoke.finetune_phase`` with its three arms, each from
its own start (the converted ``golden_sphere_30k``, as the record's from
``weights/golden_sphere_30k``), fed the recipe's draws (seed 7, chunks of
25 steps); the rows are held to the record's start rows.

``--dtype float32`` trains in float32 with the gather's f32 entry (TF32
off, as ``resolve_device`` pins it on the card) where the record trained
in bf16 with the bf16 entry; the sweeps keep the record's bf16 model.
``--arms A,B`` (fine-tune inputs) replays only those arms of
``chip_smoke.FT_ARMS``.

    python3 scripts/torch_aug_replay.py INPUTS_DIR [--dtype float32]
        [--arms arm_sigma1_lr1e-4_6k]
"""

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np
import torch

import chip_smoke
from surfacenet_tpu_torch.models.convert import params_from_jax
from surfacenet_tpu_torch.ops.cuda import _build
from surfacenet_tpu_torch.train import train_surface


def nested(flat):
    """{"params/a/b": x} -> {"params": {"a": {"b": x}}}."""
    out = {}
    for name, arr in flat.items():
        *path, leaf = name.split("/")
        d = out
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = arr
    return out


# the reference's draws fed to train_steps_scan (phase 27's feeder too)
fed = chip_smoke.fed


def main(inputs, dtype="bfloat16", arms=None):
    dev = torch.device("cuda", 0)
    chip_smoke.log(chip_smoke.card_line())
    chip_smoke.log(f"kernels built in {_build.build_all():.2f} s")
    draws = dict(np.load(os.path.join(inputs, "draws.npz")))
    finetune = str(draws.get("recipe", "aug")) == "finetune"
    if not finetune and arms:
        raise SystemExit("--arms replays fine-tune inputs only")
    train_sets = () if dtype == "bfloat16" else (
        f'model.dtype="{dtype}"', "sweep.use_pallas_gather=false")
    if not finetune:
        init = params_from_jax(nested(dict(np.load(
            os.path.join(inputs, "init.npz")))))
    real_train = train_surface.train_surfacenet
    fed_steps, tables = {}, {}

    def replay(scene, cfg, state=None, **kw):
        if state is None:  # from scratch: the reference's initial weights
            state = train_surface.create_train_state(cfg, device=dev)
            state.model.load_state_dict(init)
        cand_pts, cand_pairs, *_ = train_surface.make_device_sampler(
            scene, cfg, seed=cfg.train.seed, device=dev)
        tables["cand_pts_max_diff_mm"] = float(np.abs(
            cand_pts.cpu().numpy() - draws["cand_pts"]).max())
        same = (cand_pairs.cpu().numpy() == draws["cand_pairs"]).all(-1)
        tables["cand_pairs_equal_share"] = float(same.mean())
        aug = cfg.train.aug_calib_sigma_px > 0
        with fed(draws, dev, aug) as st:
            out = real_train(scene, cfg, state=state, **kw)
        fed_steps[f"aug={aug} steps={cfg.train.n_steps}"] = st["step"]
        return out

    train_surface.train_surfacenet = replay
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        if finetune:
            out, launches = chip_smoke.finetune_phase(
                dev, tmp, seed=int(draws["seed"]),
                arms=tuple(arms or chip_smoke.FT_ARMS), hold=False,
                train_sets=train_sets)
        else:
            out, launches = chip_smoke.training_aug_phase(
                dev, tmp, seed=int(draws["seed"]), hold=False,
                train_sets=train_sets)
    train_surface.train_surfacenet = real_train
    out.update(wall_s=time.perf_counter() - t0, fed_steps=fed_steps,
               sampler_tables=tables, train_dtype=dtype)
    chip_smoke.log(f"replay fed steps {fed_steps}, tables {tables}, "
                   f"misses {out['misses']}")
    print(json.dumps({"training_replay": out, "launches": launches}),
          flush=True)
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("inputs")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    ap.add_argument("--arms", default=None, type=lambda a: a.split(","))
    args = ap.parse_args()
    sys.exit(main(args.inputs, args.dtype, args.arms))
