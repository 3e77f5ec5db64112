"""Port parity: the calibration-refinement prepass.

End to end, the port's ``refine_calibration_auto`` must land within
0.05 px of the reference's per-view shifts: over a short schedule (2
pyramid levels x 5 Adam steps per phase) and over the preset's own (4
levels x 80 steps per phase, 2048 probes).  Over the long schedule Adam
near convergence steps by ~lr whatever the gradient's size, so float-order
differences grow; the full-schedule case measures how far the reference
itself moves when its matrices are nudged by one float32 ulp and holds the
port to that spread too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import surfacenet_tpu.geometry.refine as J
import surfacenet_tpu_torch.geometry.refine as T

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def degraded():
    from surfacenet_tpu.data.synthetic import degrade_scene, make_sphere_scene

    sc = make_sphere_scene(n_views=8, hw=(120, 160))
    return degrade_scene(sc, calib_sigma_px=1.5, seed=3)


KW = dict(n_probes=512, grid=32, steps_per_level=5, levels=(4, 2),
          probe_pool=2)


def test_refine_calibration_auto_matches_reference(degraded):
    Ps64 = np.asarray(degraded.Ps, np.float64)
    P_j, i_j = J.refine_calibration_auto(
        degraded.images, Ps64, degraded.bbox_min, degraded.bbox_max, **KW)
    P_t, i_t = T.refine_calibration_auto(
        degraded.images, Ps64, degraded.bbox_min, degraded.bbox_max,
        device="cpu", **KW)
    assert i_t["passes"] == i_j["passes"] == 1
    assert np.abs(i_j["duv_px"]).max() > 0.1  # it did move the views
    assert np.abs(i_t["duv_px"] - i_j["duv_px"]).max() <= 0.05
    # both return float32 for float64 input, shifted in float32
    assert P_t.dtype == P_j.dtype == np.float32
    np.testing.assert_allclose(P_t, P_j, rtol=1e-4, atol=1e-2)


def test_refine_calibration_auto_full_schedule_matches_reference(degraded):
    kw = dict(n_probes=2048, steps_per_level=80)  # dtu9_full's prepass
    args = (degraded.bbox_min, degraded.bbox_max)
    Ps64 = np.asarray(degraded.Ps, np.float64)
    _, i_j = J.refine_calibration_auto(degraded.images, Ps64, *args, **kw)
    nudged = np.nextafter(Ps64.astype(np.float32), np.float32(np.inf))
    _, i_n = J.refine_calibration_auto(degraded.images,
                                       nudged.astype(np.float64), *args,
                                       **kw)
    _, i_t = T.refine_calibration_auto(degraded.images, Ps64, *args,
                                       device="cpu", **kw)
    assert i_t["passes"] == i_j["passes"] == 2
    err = np.abs(i_t["duv_px"] - i_j["duv_px"]).max()
    spread = np.abs(i_n["duv_px"] - i_j["duv_px"]).max()
    assert err <= 0.05, (err, spread)
    assert err <= 2 * spread, (err, spread)

    # schedule-independent: distance to the true calibration, up to the
    # common shift the refinement cannot see (it centres duv)
    from surfacenet_tpu.data.synthetic import make_sphere_scene

    clean = make_sphere_scene(n_views=8, hw=(120, 160)).Ps
    row2 = clean[:, 2]
    true = np.stack([((Ps64[:, r] - clean[:, r]) * row2).sum(1)
                     / (row2 * row2).sum(1) for r in (0, 1)], axis=1)

    def rms_residual(duv):
        r = duv + true
        return np.sqrt(((r - r.mean(0)) ** 2).mean())

    assert abs(rms_residual(i_t["duv_px"])
               - rms_residual(i_j["duv_px"])) <= 0.02


def test_second_pass_composes_with_the_first(degraded):
    """A polish pass (forced by a low threshold) starts from the first
    pass's matrices; the two passes' shifts, applied in turn to the input
    matrices, reproduce the final matrices, and the reported total is
    their sum.  (Its duv is not compared with the reference: it starts at
    the optimum, where Adam's steps follow the sign of near-zero
    gradients.)"""
    Ps64 = np.asarray(degraded.Ps, np.float64)
    args = (degraded.images, Ps64, degraded.bbox_min, degraded.bbox_max)
    P_t, info = T.refine_calibration_auto(
        *args, device="cpu", second_pass_threshold_px=0.1, **KW)
    assert info["passes"] == 2 and info["pass_kinds"] == ["default",
                                                          "polish"]
    assert len(info["level_losses"]) == 4
    # the same two passes run by hand (deterministic on the CPU)
    P1, i1 = T.refine_calibration(*args, device="cpu", **KW)
    _, i2 = T.refine_calibration(degraded.images, P1, *args[2:],
                                 device="cpu", **KW)
    np.testing.assert_array_equal(info["duv_px"],
                                  i1["duv_px"] + i2["duv_px"])
    # each pass shifts float32 matrices, as the reference's passes do
    assert P_t.dtype == np.float32
    again = T.apply_uv_shift(
        T.apply_uv_shift(torch.tensor(Ps64, dtype=torch.float32),
                         torch.tensor(i1["duv_px"])),
        torch.tensor(i2["duv_px"]))
    np.testing.assert_allclose(P_t, again.numpy(), rtol=1e-9, atol=1e-6)


def test_components_match_reference(degraded):
    rng = np.random.default_rng(0)
    x = rng.normal(0, 10, (64, 3)).astype(np.float32)
    dx = rng.normal(0, 0.3, (64, 3)).astype(np.float32)
    np.testing.assert_allclose(
        T._remove_rigid(torch.tensor(dx), torch.tensor(x)).numpy(),
        np.asarray(J._remove_rigid(jnp.asarray(dx), jnp.asarray(x))),
        atol=1e-5,
    )
    Ps = degraded.Ps.astype(np.float32)
    duv = rng.normal(0, 1, (len(Ps), 2)).astype(np.float32)
    np.testing.assert_allclose(
        T.apply_uv_shift(torch.tensor(Ps), torch.tensor(duv)).numpy(),
        np.asarray(J.apply_uv_shift(jnp.asarray(Ps), jnp.asarray(duv))),
        rtol=1e-6,
    )
    imgs = degraded.images
    pyr_t = T._build_pyramid(torch.tensor(imgs), (4, 2, 1))
    pyr_j = J._build_pyramid(jnp.asarray(imgs), (4, 2, 1))
    for lv in (4, 2, 1):
        np.testing.assert_allclose(pyr_t[lv].numpy(), np.asarray(pyr_j[lv]),
                                   atol=1e-6)
    c = rng.uniform(size=(8, 50, 3)).astype(np.float32)
    m = rng.uniform(size=(8, 50)) > 0.3
    for a, b in zip(T._robust_view_stats(torch.tensor(c), torch.tensor(m)),
                    J._robust_view_stats(jnp.asarray(c), jnp.asarray(m))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-7)


def test_probes_match_reference(degraded):
    args = (degraded.bbox_min, degraded.bbox_max)
    p_j = J.photometric_probes(jnp.asarray(degraded.images),
                               jnp.asarray(degraded.Ps, jnp.float32), *args,
                               n_probes=256, grid=24, pool=2)
    p_t = T.photometric_probes(torch.tensor(degraded.images),
                               torch.tensor(degraded.Ps, dtype=torch.float32),
                               *args, n_probes=256, grid=24, pool=2)
    assert p_t.shape == (256, 3) and p_t.dtype == np.float32
    # the same probe set up to float ties at the top-k boundary
    d = np.linalg.norm(p_t[:, None] - np.asarray(p_j)[None], axis=-1)
    assert (d.min(axis=1) < 1e-3).mean() >= 0.98


def test_adam_step_equals_optax():
    import optax

    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(5, 2)).astype(np.float32)
    grads = rng.normal(size=(7, 5, 2)).astype(np.float32)
    tx = optax.adam(0.3)
    pj = jnp.asarray(p0)
    st = tx.init(pj)
    pt = torch.tensor(p0)
    opt = T.OptaxAdam(pt, 0.3)
    for g in grads:
        up, st = tx.update(jnp.asarray(g), st, pj)
        pj = optax.apply_updates(pj, up)
        opt.step(torch.tensor(g))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-6,
                               atol=1e-6)
