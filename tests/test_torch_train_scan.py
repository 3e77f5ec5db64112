"""Port parity: the scan path's training steps, with device sampling.

``train_surfacenet`` on a scene with an analytic surface and
``train.scan_chunk`` > 0 (every training run of ``chip_smoke.py`` phase
25) runs ``train_steps_scan``: each step draws a candidate, a jitter and
one of the candidate's pairs from ``make_device_sampler``'s tables,
labels the cube by the analytic distance, and with
``train.aug_calib_sigma_px`` draws the views' principal-point offsets,
then takes ``train_step``.  The reference's ``train_steps_scan`` does the
same inside one ``lax.scan`` from one key a step.

Both packages run it here on the CPU in float32 at the tiny widths, 16^3
cubes of 2 mm and batch 4, on the robustness_aug_r04 sphere (12 views,
radius 30) cut to 120x160, from the reference's initial weights.  The
port draws from a ``torch.Generator``, the reference from
``jax.random``: each test feeds the port the reference step's own draws
(the candidates, the jitter's uniform in [0, 1), the pairs, the N(0, 1)
offsets, each from the key the reference's body split), by replacing
``torch.randint`` / ``torch.rand`` / ``torch.randn`` for the calls made
with a generator (the package is not changed).  So the port computes
each step's origins, labels and cameras from the reference's numbers.
The draws and the feeding are those of the two scripts that replay the
record's training on the card, ``scripts/aug_replay_inputs.py``
(``step_draws``) and ``scripts/torch_aug_replay.py`` (``fed``).

Bounds: the sampler's candidates equal, and their pairs but for the
order of near-tied ones; the losses of the three steps within
2e-4 relative and every parameter and BatchNorm statistic within 1e-5
after them (those of ``tests/test_torch_train.py``'s
``test_train_step_matches_reference``).
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
from surfacenet_tpu.config import TrainConfig as JTrain
from surfacenet_tpu.config import VoxelConfig as JVoxel
from surfacenet_tpu_torch.config import Config
from surfacenet_tpu_torch.models.convert import params_from_jax
from surfacenet_tpu_torch.train import train_surface as tt

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


inputs, replay = _script("aug_replay_inputs"), _script("torch_aug_replay")

D, S, BATCH, K = 16, 2.0, 4, 3
SCENE = dict(n_views=12, hw=(120, 160), radius=30.0)
# a trainer without weight decay is 1e-4 off in every BatchNorm scale
# after one step at lr 1e-2 (tests/test_torch_train.py)
WD_PARITY = 1e-2
STEP_KW = dict(D=D, s=S, balanced=True, center_colors=True)


def _cfgs(sigma):
    jc = JConfig(
        voxel=JVoxel(voxel_size_mm=S, cube_size=D, overlap=4),
        model=dataclasses.replace(JModel.tiny(), dtype="float32"),
        fusion=JFusion(n_view_pairs=4),
        train=JTrain(batch_size=BATCH, lr=1e-2, n_steps=20, seed=0,
                     scan_chunk=K, lr_decay="cosine",
                     weight_decay=WD_PARITY, aug_calib_sigma_px=sigma))
    return jc, Config.from_json(jc.to_json())


def _state_dict(jstate):
    return params_from_jax(jax.tree_util.tree_map(
        np.asarray, {"params": jstate.params,
                     "batch_stats": jstate.batch_stats}))


@pytest.fixture(scope="module")
def scenes():
    from surfacenet_tpu.data.synthetic import make_sphere_scene as j_sphere
    from surfacenet_tpu_torch.data.synthetic import make_sphere_scene

    return j_sphere(**SCENE), make_sphere_scene(**SCENE)


@pytest.fixture(scope="module")
def tables(scenes):
    """Both packages' ``make_device_sampler`` tables (seed 0)."""
    from surfacenet_tpu.train.train_surface import make_device_sampler

    jc, tc = _cfgs(0.0)
    return (make_device_sampler(scenes[0], jc, seed=0),
            tt.make_device_sampler(scenes[1], tc, seed=0, device="cpu"))


def _reference_scan(scenes, tables, sigma):
    """The reference's K steps from its initial weights: (initial state
    dict, losses, final state dict, each step's draws)."""
    from surfacenet_tpu.train.train_surface import (
        create_train_state, train_steps_scan,
    )

    jc, _ = _cfgs(sigma)
    cand_pts, cand_pairs, surf_fn, surf_params = tables[0]
    jsc = scenes[0]
    _, st = create_train_state(jc, jax.random.PRNGKey(0))
    init = _state_dict(st)
    key = jax.random.PRNGKey(5)
    st, losses = train_steps_scan(
        st, jnp.asarray(jsc.images, jnp.float32),
        jnp.asarray(jsc.Ps, jnp.float32), cand_pts, cand_pairs, surf_params,
        key, surf_fn=surf_fn, K=K, batch=BATCH, aug_sigma_px=sigma,
        **STEP_KW)
    # train_steps_scan's body's draws from the keys it splits
    draws = [np.asarray(a) for a in jax.vmap(lambda k: inputs.step_draws(
        k, n_cand=cand_pts.shape[0], n_pairs=cand_pairs.shape[1],
        batch=BATCH, n_views=jsc.Ps.shape[0]))(jax.random.split(key, K))]
    draws = dict(zip(("idx", "unit", "choice", "normal"), draws))
    return init, np.asarray(losses), _state_dict(st), draws


def test_device_sampler_tables_match_reference(tables):
    """The candidates (the scene's seeded surface points) equal, and each
    one's top-k pairs, scored at its un-jittered cube origin: the same
    pairs, in the same order but where two scores near-tie (one row of
    the 8,192 here, as at the record's scale)."""
    (jp, jpairs, _, jparams), (tp, tpairs, _, tparams) = tables
    assert np.array_equal(tp.numpy(), np.asarray(jp))
    a, b = np.asarray(jpairs), tpairs.numpy()
    assert a.shape == b.shape
    assert all(set(map(tuple, x)) == set(map(tuple, y))
               for x, y in zip(a, b))
    assert (a == b).all(axis=(1, 2)).mean() >= 0.999
    for a, b in zip(jparams, tparams):
        assert np.array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("sigma", [0.0, 0.7])
def test_scan_steps_match_reference(scenes, tables, sigma):
    """K scanned steps under the cosine schedule, without and with the
    calibration augmentation: a wrong jitter, label rule, pair lookup or
    offset moves the first step's loss."""
    init, ref_losses, ref_sd, draws = _reference_scan(scenes, tables, sigma)
    _, tc = _cfgs(sigma)
    state = tt.create_train_state(tc, device="cpu")
    state.model.load_state_dict(init)
    tsc = scenes[1]
    with replay.fed(draws, "cpu", sigma > 0) as fed:
        losses = tt.train_steps_scan(
            state, tt.gather_copy(tsc.images, tc, "cpu"),
            torch.tensor(tsc.Ps, dtype=torch.float32), tables[1],
            torch.Generator(), K=K, batch=BATCH, aug_sigma_px=sigma,
            **STEP_KW).numpy()
    assert fed == {"step": K, "call": 0} and state.step == K
    np.testing.assert_allclose(losses, ref_losses, rtol=2e-4)
    got = state.model.state_dict()
    diffs = {k: (got[k] - v).abs().max().item()
             for k, v in ref_sd.items() if "num_batches" not in k}
    worst = max(diffs, key=diffs.get)
    assert diffs[worst] <= 1e-5, (worst, diffs[worst])
