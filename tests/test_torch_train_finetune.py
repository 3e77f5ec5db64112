"""Port parity: fine-tuning the shipped trained net.

``results/robustness_ft_r05.json`` (``scripts/calib_finetune_eval.py``)
fine-tunes ``weights/golden_sphere_30k`` with calibration augmentation
annealed to 0: ``create_train_state(cfg, PRNGKey(7))``, then
``state.replace(params=..., batch_stats=...)`` with the trained net's
variables, then ``train_surfacenet(scene, cfg, state=state)``.  The
port's start is ``train_surface.state_from_weights`` on the converted
``weights_torch/golden_sphere_30k.npz`` (``tests/test_torch_weights.py``
holds the two files equal); ``chip_smoke.py`` phase 26 trains the
record's arms from it on the card.

Here both packages take two of the recipe's steps on the CPU in float32
at the paper's widths: sigma 1 px annealed over 4 steps, lr 3e-4 under
the cosine schedule over 4 steps, the recipe's weight decay and
momentum, batch 2, 16^3 cubes of 2 mm, on the record's sphere (12 views,
radius 30) cut to 120x160, on the reference's host batches.  The port
draws its offsets from a ``torch.Generator``: each step is fed the
reference step's own N(0, 1) draw (``tests/test_torch_train_aug.py``'s
``_fed``).

Bounds: those of ``tests/test_torch_train_aug.py``'s ``_hold``, the loss
within 2e-4 relative and every parameter and BatchNorm statistic within
1e-5 after each step; the built state equal to the file, float32,
channels-last, with no momentum and step 0.
"""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surfacenet_tpu.config import Config as JConfig
from surfacenet_tpu.config import FusionConfig as JFusion
from surfacenet_tpu.config import ModelConfig as JModel
from surfacenet_tpu.config import SweepConfig as JSweep
from surfacenet_tpu.config import TrainConfig as JTrain
from surfacenet_tpu.config import VoxelConfig as JVoxel
from surfacenet_tpu_torch.config import Config
from surfacenet_tpu_torch.models.convert import load_npz, params_from_jax
from surfacenet_tpu_torch.train import train_surface as tt

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "train_aug_parity", os.path.join(ROOT, "tests", "test_torch_train_aug.py"))
aug = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(aug)

WEIGHTS = os.path.join(ROOT, "weights", "golden_sphere_30k")
NPZ = os.path.join(ROOT, "weights_torch", "golden_sphere_30k.npz")
D, S = 16, 2.0
SIGMA, ANNEAL, N_STEPS = 1.0, 4, 2
STEP_KW = dict(D=D, s=S, balanced=True, center_colors=True)


def _cfgs():
    """The recipe's ``ft_cfg`` (``scripts/calib_finetune_eval.py:71-79``)
    in both packages, the port's from the reference's JSON, at float32,
    batch 2 and the CPU's cube size."""
    jc = JConfig(
        voxel=JVoxel(voxel_size_mm=S, cube_size=D, overlap=4),
        model=dataclasses.replace(JModel(), dtype="float32"),
        sweep=JSweep(cube_batch=8),
        fusion=JFusion(n_view_pairs=4, tau=0.7, gamma=0.7,
                       ray_pool_mode="affine", n_pool_views=6),
        train=JTrain(batch_size=2, lr=3e-4, seed=7, n_steps=ANNEAL,
                     lr_decay="cosine", scan_chunk=25,
                     aug_calib_sigma_px=SIGMA,
                     aug_calib_anneal_steps=ANNEAL))
    return jc, Config.from_json(jc.to_json())


@pytest.fixture(scope="module")
def reference():
    """The reference's fine-tune start as the recipe builds it, its host
    batches and step keys, their N(0, 1) draws, and (loss, state dict)
    after each of its N_STEPS steps."""
    from surfacenet_tpu.data.synthetic import make_sphere_scene as j_sphere
    from surfacenet_tpu.train.train_surface import (
        create_train_state, load_pretrained, sample_training_batch,
        train_step,
    )
    from surfacenet_tpu_torch.data.synthetic import make_sphere_scene

    jsc, tsc = j_sphere(**aug.SCENE), make_sphere_scene(**aug.SCENE)
    jc, _ = _cfgs()
    _, variables = load_pretrained(WEIGHTS, jc)
    _, st = create_train_state(jc, jax.random.PRNGKey(7))
    st = st.replace(params=variables["params"],
                    batch_stats=variables["batch_stats"])
    rng = np.random.default_rng(7)
    batches = [sample_training_batch(jsc, jc, rng) for _ in range(N_STEPS)]
    keys = [jax.random.fold_in(jax.random.PRNGKey(8), i)
            for i in range(N_STEPS)]
    draws = [np.asarray(jax.random.normal(k, (jsc.Ps.shape[0], 2),
                                          jnp.float32)) for k in keys]
    images = jnp.asarray(jsc.images, jnp.float32)
    Ps = jnp.asarray(jsc.Ps, jnp.float32)
    start = aug._state_dict(st)
    steps = []
    for i, (o, p, lab) in enumerate(batches):
        st, loss = train_step(
            st, images, Ps, jnp.asarray(o), jnp.asarray(p), jnp.asarray(lab),
            keys[i], **STEP_KW, aug_sigma_px=SIGMA, aug_anneal_steps=ANNEAL)
        steps.append((float(loss), aug._state_dict(st)))
    return dict(scene=tsc, batches=batches, draws=draws, start=start,
                steps=steps)


def test_state_from_weights_is_the_file_at_step_0():
    """The built state: the converted file's every tensor, float32 where
    the file is, the kernels channels-last, no momentum buffer, step 0,
    the recipe's optimizer settings."""
    _, tc = _cfgs()
    state = tt.state_from_weights(tc, NPZ, device="cpu")
    want = load_npz(NPZ)
    got = state.model.state_dict()
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    for name, p in state.model.named_parameters():
        assert p.dtype == torch.float32, name
        if p.dim() == 5:
            assert p.is_contiguous(memory_format=torch.channels_last_3d), name
    assert state.step == 0 and not state.optimizer.state
    group = state.optimizer.param_groups[0]
    assert (group["lr"], group["momentum"], group["weight_decay"]) == (
        3e-4, 0.9, 1e-4)


def test_finetune_steps_match_reference(reference, monkeypatch):
    """Two annealed steps from each package's start: the start equal to
    the reference's variables, then each step's loss and state held with
    ``_hold``; the steps move the net by more than the bound, and a step
    without the draws differs."""
    ref = reference
    _, tc = _cfgs()
    state = tt.state_from_weights(tc, NPZ, device="cpu")
    start = state.model.state_dict()
    for k, v in ref["start"].items():
        if "num_batches" not in k:
            assert torch.equal(start[k], v), k
    start = {k: v.clone() for k, v in start.items()}
    sc = ref["scene"]
    images = torch.tensor(sc.images)
    Ps = torch.tensor(sc.Ps, dtype=torch.float32)

    def step(st, i):
        o, p, lab = ref["batches"][i]
        return tt.train_step(
            st, images, Ps, torch.tensor(o), torch.tensor(p),
            torch.tensor(lab), torch.Generator(), **STEP_KW,
            aug_sigma_px=SIGMA, aug_anneal_steps=ANNEAL).item()

    left = aug._fed(monkeypatch, ref["draws"])
    for i in range(N_STEPS):
        loss = step(state, i)
        assert state.step == i + 1
        aug._hold(loss, state, *ref["steps"][i], f"step {i + 1}")
    assert not left
    got = state.model.state_dict()
    moved = max((got[k] - start[k]).abs().max().item() for k in start
                if "num_batches" not in k)
    assert moved > 100 * 1e-5, moved
    monkeypatch.undo()
    plain = tt.state_from_weights(tc, NPZ, device="cpu")
    o, p, lab = ref["batches"][0]
    loss = tt.train_step(plain, images, Ps, torch.tensor(o), torch.tensor(p),
                         torch.tensor(lab), None, **STEP_KW).item()
    assert abs(loss - ref["steps"][0][0]) > 2e-4 * abs(ref["steps"][0][0])
