"""Port parity: pair selection, gather dedup and fusion (exact)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import surfacenet_tpu.ops.fusion as JF
import surfacenet_tpu.ops.view_pairs as JV
import surfacenet_tpu_torch.ops.fusion as TF
import surfacenet_tpu_torch.ops.view_pairs as TV

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scene():
    from surfacenet_tpu.data.synthetic import make_sphere_scene

    return make_sphere_scene(n_views=6, hw=(90, 120))


@pytest.mark.parametrize("n_pairs,sigma", [(2, 0.0), (5, 0.0), (3, 0.25)])
def test_select_pairs_geometric_exact(scene, n_pairs, sigma):
    rng = np.random.default_rng(n_pairs)
    origins = rng.uniform(-60, 30, (50, 3))
    hw = scene.images.shape[1:3]
    ref_i, ref_w = JV.select_pairs_geometric(
        scene.Ps, origins, n_pairs, hw, extent_mm=24.0,
        dist_sigma_frac=sigma,
    )
    got_i, got_w = TV.select_pairs_geometric(
        scene.Ps, origins, n_pairs, hw, extent_mm=24.0,
        dist_sigma_frac=sigma, device="cpu",
    )
    np.testing.assert_array_equal(got_i, ref_i)
    assert got_i.dtype == np.int32 and got_w.dtype == np.float32
    np.testing.assert_allclose(got_w, ref_w, rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(TV.candidate_pairs(6),
                                  JV.candidate_pairs(6))


def test_dedup_view_slots_exact():
    rng = np.random.default_rng(0)
    pair_idx = rng.integers(0, 9, (20, 5, 2))
    for k in (None, 10):
        u_t, s_t = TV.dedup_view_slots(pair_idx, k)
        u_j, s_j = JV.dedup_view_slots(pair_idx, k)
        np.testing.assert_array_equal(u_t, u_j)
        np.testing.assert_array_equal(s_t, s_j)
    rows = np.arange(20)[:, None, None]
    np.testing.assert_array_equal(u_t[rows, s_t], pair_idx)
    with pytest.raises(ValueError):
        TV.dedup_view_slots(pair_idx, 2)


def test_fuse_pairs_and_adaptive_threshold_exact():
    rng = np.random.default_rng(1)
    probs = rng.uniform(size=(3, 4, 6, 6, 6)).astype(np.float32)
    w = rng.uniform(size=(3, 4)).astype(np.float32)
    valid = rng.uniform(size=(3, 4, 6, 6, 6)) > 0.2
    ref = np.stack([
        np.asarray(JF.fuse_pairs(jnp.asarray(probs[i]), jnp.asarray(w[i]),
                                 jnp.asarray(valid[i])))
        for i in range(3)
    ])
    got = TF.fuse_pairs(torch.tensor(probs), torch.tensor(w),
                        torch.tensor(valid)).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        TF.fuse_pairs(torch.tensor(probs[0]), torch.tensor(w[0])).numpy(),
        np.asarray(JF.fuse_pairs(jnp.asarray(probs[0]), jnp.asarray(w[0]))),
    )
    taus = np.array([0.3, 0.5, 0.7, 0.9], np.float32)
    t_ref = np.asarray(JF.adaptive_threshold(jnp.asarray(ref),
                                             jnp.asarray(taus), 0.2))
    t_got = TF.adaptive_threshold(torch.tensor(ref), torch.tensor(taus),
                                  0.2).numpy()
    np.testing.assert_array_equal(t_got, t_ref)
