"""Port parity over a long run: training steps side by side.

``scripts/train_horizon_parity.py`` holds the port's training step to the
reference's over hundreds of steps at the paper widths (and 50 at the
record's size) and writes ``results/train_horizon_parity.json``; here
both packages train 40 steps of its recipe ``ft_lr1e-4``
(``scripts/calib_finetune_eval.py`` at lr 1e-4, sigma 1 px annealed over
the run, cosine lr, seed 7) at the tiny widths in float32, 16^3 cubes of
2 mm, batch 2, on the record's sphere cut to 120x160, from the
reference's ``create_train_state(cfg, PRNGKey(7))`` variables and on its
own draws (``scripts/aug_replay_inputs.py``'s step keys; the port fed
them by ``chip_smoke.fed``, on the reference's sampler tables).

The reference runs twice more: from its start nudged up by one float32
ulp in every parameter, and with its BatchNorm statistics and loss sums
in float64 (``exact_reductions``: XLA's CPU reductions of those sums lose
up to ~1e-4 relative at this batch, torch's do not).  Those two runs are
its own float-order envelope.  At steps 10, 20 and 40 the port's
trajectory is read as ``chip_smoke.py`` phase 27 reads the card's
(``parity_diffs``: the losses' largest relative difference so far, each
tensor's change from the start by its norm and by its projection on a
seeded direction); bound: each reading within 3x the larger of the two
envelopes' readings.

The second case checks the files phase 27 holds the card to: the draws
are what ``aug_replay_inputs.py``'s functions make for the record's
first 50 steps, the trajectory's first two losses are the reference's
own on the CPU (within 1e-5 relative), and ``chip_smoke``'s
``TRAIN_PARITY_BOUNDS`` are 3x the envelope that trajectory records.
"""

import dataclasses
import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

from surfacenet_tpu.config import Config as JConfig
from surfacenet_tpu.config import FusionConfig as JFusion
from surfacenet_tpu.config import ModelConfig as JModel
from surfacenet_tpu.config import TrainConfig as JTrain
from surfacenet_tpu.config import VoxelConfig as JVoxel
from surfacenet_tpu_torch.config import Config

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


horizon = _script("train_horizon_parity",
                  os.path.join(ROOT, "scripts", "train_horizon_parity.py"))
inputs = _script("aug_replay_inputs",
                 os.path.join(ROOT, "scripts", "aug_replay_inputs.py"))
smoke = _script("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))

N_STEPS, CHECKPOINTS = 40, (10, 20, 40)
SCENE = dict(n_views=12, hw=(120, 160), radius=30.0)
FACTOR = 3.0


def _cfgs():
    jc = JConfig(
        voxel=JVoxel(voxel_size_mm=2.0, cube_size=16, overlap=4),
        model=dataclasses.replace(JModel.tiny(), dtype="float32"),
        fusion=JFusion(n_view_pairs=4),
        train=JTrain(batch_size=2, lr=1e-4, seed=7, n_steps=N_STEPS,
                     lr_decay="cosine", scan_chunk=25,
                     aug_calib_sigma_px=1.0,
                     aug_calib_anneal_steps=N_STEPS))
    return jc, Config.from_json(jc.to_json())


def _trajectory(run, steps):
    losses, snaps = run
    keep = [k for k in snaps[0] if not k.startswith("momentum.")]
    start = {k: snaps[0][k] for k in keep}
    return {"losses": list(losses), "changes": {
        str(c): smoke.change_summary(start, {k: snaps[c][k] for k in keep})
        for c in steps}}


def test_forty_steps_within_the_reference_envelope(monkeypatch):
    from surfacenet_tpu.data.synthetic import make_sphere_scene as j_sphere
    from surfacenet_tpu.train.train_surface import (
        create_train_state, make_device_sampler,
    )
    from surfacenet_tpu_torch.data.synthetic import make_sphere_scene
    from surfacenet_tpu_torch.models.convert import params_from_jax

    jc, tc = _cfgs()
    jsc = j_sphere(**SCENE)
    sampler = make_device_sampler(jsc, jc, seed=7)
    _, state = create_train_state(jc, jax.random.PRNGKey(7))
    keys = inputs.step_keys(jc.train, N_STEPS)
    idx, unit, choice, normal = inputs.recipe_draws(
        jc.train, N_STEPS, n_cand=sampler[0].shape[0],
        n_pairs=sampler[1].shape[1], n_views=jsc.Ps.shape[0])
    draws = dict(idx=idx, unit=unit, choice=choice, normal=normal,
                 cand_pts=np.asarray(sampler[0]),
                 cand_pairs=np.asarray(sampler[1]))
    runs = {v: horizon.train_jax(jc, jsc, sampler, state, keys, CHECKPOINTS,
                                 v) for v in (None, "nudged", "exact")}
    start = params_from_jax({"params": horizon.jax_tree_np(state.params),
                             "batch_stats":
                                 horizon.jax_tree_np(state.batch_stats)})
    port = horizon.train_port(tc, make_sphere_scene(**SCENE), start, draws,
                              CHECKPOINTS)
    monkeypatch.setattr(smoke, "TRAIN_PARITY_STEPS", CHECKPOINTS)
    ref = _trajectory(runs[None], CHECKPOINTS)
    got = smoke.parity_diffs(_trajectory(port, CHECKPOINTS), ref)
    envs = [smoke.parity_diffs(_trajectory(runs[v], CHECKPOINTS), ref)
            for v in ("nudged", "exact")]
    for c in map(str, CHECKPOINTS):
        for key, value in got[c].items():
            bound = FACTOR * max(e[c][key] for e in envs)
            assert value <= bound, (c, key, value, bound, envs)
    # the port moved the net: its changes are not the start's
    assert all(n > 0 for n, _ in _trajectory(port, (40,))["changes"][
        "40"].values())


def test_phase27_files_are_the_reference_own():
    from surfacenet_tpu.data.synthetic import make_sphere_scene as j_sphere
    from surfacenet_tpu.train.train_surface import (
        create_train_state, load_pretrained, make_device_sampler,
    )

    draws = np.load(os.path.join(ROOT, "results", "train_parity_draws.npz"))
    with open(os.path.join(ROOT, "results", "train_parity_ref.json")) as f:
        traj = json.load(f)
    steps = traj["steps"]
    assert steps == smoke.TRAIN_PARITY_STEPS[-1] == len(draws["idx"])
    recipe, size, dtype = horizon.CELLS["full"][0]
    jc, _ = horizon.configs(recipe, size, dtype)
    scene = j_sphere(**horizon.scene_kw(size))
    sampler = make_device_sampler(scene, jc, seed=jc.train.seed)
    assert np.array_equal(draws["cand_pts"], np.asarray(sampler[0]))
    assert np.array_equal(draws["cand_pairs"], np.asarray(sampler[1]))
    want = inputs.recipe_draws(
        inputs.record_config(7, "finetune").train, steps,
        n_cand=sampler[0].shape[0], n_pairs=sampler[1].shape[1],
        n_views=scene.Ps.shape[0])
    for key, arr in zip(("idx", "unit", "choice", "normal"), want):
        assert np.array_equal(draws[key], arr), key
    # the reference's first two steps at the record's size reproduce the
    # trajectory's first two losses
    _, state = create_train_state(jc, jax.random.PRNGKey(7))
    _, variables = load_pretrained(horizon.WEIGHTS, jc)
    state = state.replace(params=variables["params"],
                          batch_stats=variables["batch_stats"])
    keys = inputs.step_keys(jc.train, 2)
    losses, _ = horizon.train_jax(jc, scene, sampler, state, keys, ())
    np.testing.assert_allclose(losses, traj["ref"]["losses"][:2], rtol=1e-5)
    # the card's bounds: 3x the CPU envelope the file records
    for c, bound in smoke.TRAIN_PARITY_BOUNDS.items():
        for key, value in bound.items():
            env = max(traj["envelope"][str(c)][k][key]
                      for k in smoke.TRAIN_PARITY_ENVELOPES)
            assert value == pytest.approx(FACTOR * env, rel=1e-2), (c, key)
