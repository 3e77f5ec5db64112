"""Port parity: training with calibration augmentation.

``train.aug_calib_sigma_px`` moves every view's principal point by
N(0, sigma) pixels before each step's gather (the reference's
``_train_step_impl`` with ``perturb_calibration``), and
``train.aug_calib_anneal_steps`` decays sigma linearly to 0 at that
step.  ``results/robustness_aug_r04.json`` trains one arm with sigma 0.7;
``chip_smoke.py`` phase 25 trains it on the card.  Here both packages run
the augmented step on the CPU in float32, at the tiny widths, 16^3 cubes
of 2 mm and batch 4 (the ``_cfgs`` of ``tests/test_torch_train.py``), on
the record's sphere (12 views, radius 30) with its images cut to 120x160,
from the reference's initial weights on its host batches.

The port draws its per-step offsets from a ``torch.Generator``, the
reference from ``jax.random``.  Each test feeds the port the reference's
own draws, ``jax.random.normal(k_aug, (V, 2))`` of the key the reference
step took, by replacing ``torch.randn`` for the step's call here (the
package is not changed).

Bounds: the loss within 2e-4 relative and every parameter and BatchNorm
statistic within 1e-5 after each of three steps (those of
``test_train_step_matches_reference``); the annealed step the same, and
at ``state.step`` >= the anneal horizon bitwise the port's plain step;
after 20 steps, the loss within 2e-4 relative and both nets' sweeps of
a 2x2x2 block of 16^3 cubes over the sphere: point counts within one
(the vote's near-tie allowance, ROADMAP C5) and merged voxel sets
agreeing on >= 0.99 of their union.  The initial kernels: flax's
truncated LeCun normal in both packages.
"""

import dataclasses

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
from surfacenet_tpu_torch.models.convert import params_from_jax
from surfacenet_tpu_torch.train import train_surface as tt

torch.set_num_threads(2)

D, S = 16, 2.0
SIGMA = 0.7
ANNEAL = 4
N_STEPS = 20
# the record's sphere (scripts/calib_aug_eval.py) at 120x160
SCENE = dict(n_views=12, hw=(120, 160), radius=30.0)
# 2x2x2 cubes of 32 mm every 24 mm over the sphere's middle
BLOCK_MIN = np.full(3, -28.0)
BLOCK_MAX = BLOCK_MIN + D * S + (D - 4) * S
# the sweep's threshold: after 20 steps at lr 1e-2 the net's
# probabilities lie in 0.50-0.55, so tau 0.5 keeps ~2,800 of the block's
# voxels, and the vote thins them
TAU = 0.5
# a trainer without weight decay is 1e-4 off in every BatchNorm scale
# after one step at lr 1e-2, ten times the bound (tests/test_torch_train.py)
WD_PARITY = 1e-2
STEP_KW = dict(D=D, s=S, balanced=True, center_colors=True)


def _cfgs(**train):
    """The same tiny config in both packages, the port's from the
    reference's JSON; the sweep at the record's flags but its widths."""
    kw = dict(batch_size=4, lr=1e-2, n_steps=N_STEPS, seed=0, scan_chunk=0,
              weight_decay=WD_PARITY, aug_calib_sigma_px=SIGMA)
    kw.update(train)
    jc = JConfig(
        voxel=JVoxel(voxel_size_mm=S, cube_size=D, overlap=4),
        model=dataclasses.replace(JModel.tiny(), dtype="float32"),
        sweep=JSweep(cube_batch=8),
        fusion=JFusion(n_view_pairs=4, tau=TAU, gamma=0.7,
                       ray_pool_mode="affine", n_pool_views=6),
        train=JTrain(**kw))
    return jc, Config.from_json(jc.to_json())


def _state_dict(jstate):
    return params_from_jax(jax.tree_util.tree_map(
        np.asarray, {"params": jstate.params,
                     "batch_stats": jstate.batch_stats}))


@pytest.fixture(scope="module")
def reference():
    """The reference's run: the scene (both packages'), its initial
    weights, N_STEPS host batches (seed 0), the keys its steps took and
    their draws; ``steps``: (loss, state dict) after each augmented step
    under the cosine schedule; ``anneal``: {state.step: (loss, state
    dict)}, one annealed step from the initial weights at each start;
    ``variables``: the weights after the N_STEPS."""
    from surfacenet_tpu.data.synthetic import make_sphere_scene as j_sphere
    from surfacenet_tpu.train.train_surface import (
        create_train_state, sample_training_batch, train_step,
    )
    from surfacenet_tpu_torch.data.synthetic import make_sphere_scene

    jsc, tsc = j_sphere(**SCENE), make_sphere_scene(**SCENE)
    jc, _ = _cfgs(lr_decay="cosine")
    rng = np.random.default_rng(0)
    batches = [sample_training_batch(jsc, jc, rng) for _ in range(N_STEPS)]
    keys = [jax.random.fold_in(jax.random.PRNGKey(7), i)
            for i in range(N_STEPS)]
    V = jsc.Ps.shape[0]
    draws = [np.asarray(jax.random.normal(k, (V, 2), jnp.float32))
             for k in keys]
    images = jnp.asarray(jsc.images, jnp.float32)
    Ps = jnp.asarray(jsc.Ps, jnp.float32)

    def step(st, i, **kw):
        o, p, lab = batches[i]
        return train_step(st, images, Ps, jnp.asarray(o), jnp.asarray(p),
                          jnp.asarray(lab), keys[i], **STEP_KW, **kw)

    _, st = create_train_state(jc, jax.random.PRNGKey(0))
    init = _state_dict(st)
    steps = []
    for i in range(N_STEPS):
        st, loss = step(st, i, aug_sigma_px=SIGMA)
        steps.append((float(loss), _state_dict(st)))
    variables = {"params": st.params, "batch_stats": st.batch_stats}

    # the anneal from the initial weights at a constant lr: optax counts
    # the schedule's steps in its own state, which ``state.step`` here
    # does not move
    _, st0 = create_train_state(_cfgs(lr_decay="none")[0],
                                jax.random.PRNGKey(0))
    anneal = {}
    for start in (0, 2, 4, 6):
        st, loss = step(st0.replace(step=start),
                        start, aug_sigma_px=SIGMA, aug_anneal_steps=ANNEAL)
        anneal[start] = (float(loss), _state_dict(st))
    return dict(scenes=(jsc, tsc), init=init, batches=batches, draws=draws,
                steps=steps, anneal=anneal, variables=variables)


def _fed(monkeypatch, draws):
    """``train_step``'s draw (``torch.randn`` with its generator) returns
    ``draws`` in turn; returns the list of those not yet taken.  Install
    it after the state is made: the initialisation draws too."""
    real, left = torch.randn, list(draws)

    def randn(*size, generator=None, **kw):
        if generator is None:
            return real(*size, **kw)
        assert tuple(size[0]) == left[0].shape
        return torch.tensor(left.pop(0))

    monkeypatch.setattr(torch, "randn", randn)
    return left


def _port_state(ref, **train):
    _, tc = _cfgs(**train)
    state = tt.create_train_state(tc, device="cpu")
    state.model.load_state_dict(ref["init"])
    return state


def _port_step(state, ref, i, **kw):
    o, p, lab = ref["batches"][i]
    sc = ref["scenes"][1]
    return tt.train_step(
        state, torch.tensor(sc.images), torch.tensor(sc.Ps,
                                                     dtype=torch.float32),
        torch.tensor(o), torch.tensor(p), torch.tensor(lab),
        torch.Generator(), **STEP_KW, **kw).item()


def _hold(loss, state, ref_loss, ref_sd, name):
    got = state.model.state_dict()
    diffs = {k: (got[k] - ref_sd[k]).abs().max().item()
             for k in ref_sd if "num_batches" not in k}
    worst = max(diffs, key=diffs.get)
    assert abs(loss - ref_loss) <= 2e-4 * abs(ref_loss), (name, loss,
                                                          ref_loss)
    assert diffs[worst] <= 1e-5, (name, worst, diffs[worst])


def test_augmented_step_matches_reference(reference, monkeypatch):
    """Three augmented steps under the cosine schedule from the
    reference's weights on its batches and draws: a wrong sign, unit or
    row of the principal-point shift moves the gather's colours, and so
    the loss at step 1."""
    ref = reference
    state = _port_state(ref, lr_decay="cosine")
    left = _fed(monkeypatch, ref["draws"][:3])
    for i in range(3):
        loss = _port_step(state, ref, i, aug_sigma_px=SIGMA)
        assert state.step == i + 1
        _hold(loss, state, *ref["steps"][i], f"step {i + 1}")
    assert not left
    # the draws moved the step: the same step without them differs
    monkeypatch.undo()
    plain = _port_state(ref, lr_decay="cosine")
    assert abs(_port_step(plain, ref, 0) - ref["steps"][0][0]) > 1e-4


@pytest.mark.parametrize("start", [0, 2, 4, 6])
def test_annealed_step_matches_reference(reference, monkeypatch, start):
    """One step with ``aug_anneal_steps`` 4 from ``state.step`` = start:
    sigma 0.7 (1 - start / 4), 0 from step 4 on, where the step is the
    plain one bitwise."""
    ref = reference
    state = _port_state(ref, lr_decay="none")
    state.step = start
    left = _fed(monkeypatch, ref["draws"][start:start + 1])
    loss = _port_step(state, ref, start, aug_sigma_px=SIGMA,
                      aug_anneal_steps=ANNEAL)
    assert not left and state.step == start + 1
    _hold(loss, state, *ref["anneal"][start], f"from step {start}")
    monkeypatch.undo()
    plain = _port_state(ref, lr_decay="none")
    plain.step = start
    plain_loss = _port_step(plain, ref, start)
    same = all(torch.equal(v, plain.model.state_dict()[k])
               for k, v in state.model.state_dict().items())
    if start >= ANNEAL:
        assert loss == plain_loss and same
    else:
        assert loss != plain_loss and not same


def test_augmented_run_sweeps_as_reference(reference, monkeypatch):
    """N_STEPS augmented steps under the cosine schedule from one
    initialisation, then each package's net sweeps the block: the
    reference's train -> reconstruct path at the tiny widths."""
    from surfacenet_tpu.models.surfacenet import SurfaceNet
    from surfacenet_tpu.models.surfacenet import make_predictor as j_make
    from surfacenet_tpu.pipeline.sweep import run_sweep as j_sweep
    from surfacenet_tpu_torch.models.surfacenet import make_predictor
    from surfacenet_tpu_torch.pipeline.sweep import run_sweep
    from surfacenet_tpu_torch.utils.metrics import voxel_set_agreement

    ref = reference
    state = _port_state(ref, lr_decay="cosine")
    left = _fed(monkeypatch, ref["draws"])
    for i in range(N_STEPS):
        loss = _port_step(state, ref, i, aug_sigma_px=SIGMA)
    assert not left and state.step == N_STEPS
    # float32 rounding differences grow over the steps: the loss is held,
    # the parameters are compared through what the nets sweep
    ref_loss = ref["steps"][-1][0]
    assert abs(loss - ref_loss) <= 2e-4 * abs(ref_loss), (loss, ref_loss)

    jc, tc = _cfgs()
    jsc, tsc = ref["scenes"]
    store_j, stats_j = j_sweep(
        jsc.images, jsc.Ps, BLOCK_MIN, BLOCK_MAX, jc,
        j_make(SurfaceNet(jc.model), ref["variables"], jc.model))
    store_t, stats_t = run_sweep(
        tsc.images, tsc.Ps, BLOCK_MIN, BLOCK_MAX, tc,
        make_predictor(state.model, tc.model, "cpu"), device="cpu")
    pts_j, pts_t = np.asarray(store_j.merge()[0]), store_t.merge()[0]
    agree = voxel_set_agreement(pts_t, pts_j)
    print(f"port {len(pts_t)} points, reference {len(pts_j)}, agreement "
          f"{agree:.6f}")
    assert stats_t.n_cubes_total == 8
    assert stats_t.n_cubes_after_prefilter == stats_j.n_cubes_after_prefilter
    assert len(pts_j) > 500
    assert abs(len(pts_t) - len(pts_j)) <= 1
    assert agree >= 0.99


@pytest.mark.parametrize("widths", ["tiny", "paper"])
def test_initial_kernels_follow_the_reference_distribution(reference,
                                                           widths):
    """Training from scratch starts from flax's LeCun normal: every
    kernel within two deviations of the untruncated normal, 2 / 0.8796 /
    sqrt(fan_in), and deviating by 1 / sqrt(fan_in), as the reference's
    initial kernels at the tiny widths are (an untruncated normal of
    that deviation reaches ~4.5 / sqrt(fan_in) at the paper's)."""
    import math

    from surfacenet_tpu_torch.config import ModelConfig
    from surfacenet_tpu_torch.models.surfacenet import init_surfacenet

    ref = reference["init"]
    cfg = _cfgs()[1].model if widths == "tiny" else ModelConfig()
    got = init_surfacenet(cfg, torch.Generator().manual_seed(0)).state_dict()
    kernels = [k for k, v in got.items() if k.endswith("weight")
               and v.dim() == 5]
    n_blocks = len(cfg.block_channels)
    assert len(kernels) == sum(cfg.convs_per_block) + n_blocks + 1
    checked = [got] if widths == "paper" else [got, ref]
    for sd in checked:
        for k in kernels:
            fan_in = math.prod(sd[k].shape[1:])
            w = sd[k].double() * math.sqrt(fan_in)
            assert w.abs().max().item() <= 2 / 0.87962566103423978 + 1e-6, k
            if w.numel() >= 5000:
                assert abs(w.std().item() - 1.0) < 0.03, k
    if widths == "tiny":  # biases zero, BatchNorm at identity
        assert got.keys() == ref.keys()
        for k, v in ref.items():
            if k not in kernels and "num_batches" not in k:
                assert torch.equal(got[k], v), k
