"""Port parity: the affine ray-pooling vote (plain version of the kernel).

Against the Pallas vote kernel in interpret mode: agreement >= 0.995 (the
bar of tests/test_pallas.py).  Against the sum of the reference's XLA
``ray_max_mask_affine`` over the active views: exactly equal.

The affine-pool mask (plain version of the mask kernel) against the
reference's ``ray_max_mask_affine_pallas`` in interpret mode: agreement
>= 0.999 per item (the bar tests/test_pallas.py holds the reference to).

The exact mode (scatter-max raster, plain PyTorch as the reference's is
XLA) against the reference's ``ray_max_mask_single_view`` and
``ray_pool``: masks, votes and occupancy agree on >= 0.999.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surfacenet_tpu.ops.pallas.affine_pool import (
    ray_max_mask_affine_pallas, ray_vote_affine_pallas,
)
from surfacenet_tpu.ops.ray_pooling import ray_max_mask_affine as j_mask
from surfacenet_tpu_torch.ops.cuda.affine_pool import (
    affine_pool, ray_max_mask_affine_cuda,
)
from surfacenet_tpu_torch.ops.cuda.affine_vote import (
    affine_route, affine_vote, ray_vote_affine,
)
from surfacenet_tpu_torch.ops.ray_pooling import (
    _projection_jacobian, item_params, ray_max_mask_affine,
    ray_max_mask_affine_batch, ray_max_mask_exact, ray_pool,
    ray_vote_affine_plain, vote_params,
)

torch.set_num_threads(2)

D, S, N, K = 16, 2.0, 4, 3


@pytest.fixture(scope="module")
def case():
    from surfacenet_tpu.data.synthetic import make_sphere_scene

    scene = make_sphere_scene(n_views=4, hw=(96, 128))
    rng = np.random.default_rng(2)
    probs = rng.uniform(size=(N, D, D, D)).astype(np.float32)
    origins = np.array([[-16.0, -16.0, -16.0], [0.0, -16.0, 0.0],
                        [-30.0, 5.0, -10.0], [4.0, 4.0, -20.0]], np.float32)
    views = rng.integers(0, 4, (N, K))
    Ps_pool = scene.Ps[views].astype(np.float32)
    mask = np.ones((N, K), bool)
    mask[0, 2] = False  # padded slots must not vote
    mask[3, 1] = False
    return probs, origins, Ps_pool, mask


def _port(case, window):
    probs, origins, Ps_pool, mask = case
    return ray_vote_affine(
        torch.tensor(probs), torch.tensor(origins), S,
        torch.tensor(Ps_pool), torch.tensor(mask), window=window,
    ).numpy()


@pytest.mark.parametrize("window", [0, 2])
def test_vote_matches_pallas_interpret(case, window):
    probs, origins, Ps_pool, mask = case
    ref = np.asarray(ray_vote_affine_pallas(
        jnp.asarray(probs), jnp.asarray(origins), S, jnp.asarray(Ps_pool),
        jnp.asarray(mask), window=window, interpret=True,
    ))
    got = _port(case, window)
    assert got.dtype == np.int32 and got.shape == (N, D, D, D)
    assert (got == ref).mean() >= 0.995


@pytest.mark.parametrize("window", [0, 1, 2])
def test_vote_equals_summed_xla_masks(case, window):
    probs, origins, Ps_pool, mask = case
    ref = np.zeros((N, D, D, D), np.int64)
    for i in range(N):
        for k in range(K):
            if mask[i, k]:
                m = np.asarray(j_mask(
                    jnp.asarray(probs[i]), jnp.asarray(origins[i]), S,
                    jnp.asarray(Ps_pool[i, k]), window=window,
                ))
                ref[i] += m
                single = ray_max_mask_affine(
                    torch.tensor(probs[i]), torch.tensor(origins[i]), S,
                    torch.tensor(Ps_pool[i, k]), window=window,
                ).numpy()
                np.testing.assert_array_equal(single, m)
    np.testing.assert_array_equal(_port(case, window), ref)


def test_vote_params_match_reference_slopes(case):
    from surfacenet_tpu.ops.ray_pooling import _projection_jacobian as j_jac

    probs, origins, Ps_pool, mask = case
    centers = origins + 0.5 * D * S
    A_j = np.stack([np.stack([
        np.asarray(j_jac(jnp.asarray(Ps_pool[i, k]), jnp.asarray(centers[i])))
        for k in range(K)]) for i in range(N)])
    A_t = _projection_jacobian(torch.tensor(Ps_pool),
                               torch.tensor(centers)[:, None]).numpy()
    np.testing.assert_allclose(A_t, A_j, rtol=1e-5, atol=1e-9)
    axis, slopes = vote_params(torch.tensor(origins), S,
                               torch.tensor(Ps_pool), torch.tensor(mask), D)
    n = np.cross(A_j[..., 0, :], A_j[..., 1, :])
    ref_axis = np.where(mask, np.argmax(np.abs(n), axis=-1), -1)
    np.testing.assert_array_equal(axis.numpy(), ref_axis)
    assert axis.dtype == torch.int32 and slopes.shape == (N, K, 2)
    assert (slopes.abs() <= 1).all()


def test_boundary_voxels_with_rays_leaving_the_cube_vote():
    """A voxel whose sheared ray position leaves the cube has ray max NEG,
    so every active view counts it (the reference's face rule)."""
    fused = torch.rand((1, 8, 8, 8), generator=torch.Generator().manual_seed(0))
    axis = torch.tensor([[2]], dtype=torch.int32)
    slopes = torch.tensor([[[1.0, 0.0]]])
    votes = affine_vote(fused, axis, slopes, window=0)
    # slab t is shifted by t - 4 along x: x + (t - 4) outside [0, 8) votes
    x = torch.arange(8)[:, None]
    t = torch.arange(8)[None, :]
    outside = ((x + t - 4) < 0) | ((x + t - 4) >= 8)
    assert (votes[0, :, 0, :][outside] == 1).all()
    assert (votes[0, :, 0, :][~outside] == 0).any()
    inactive = affine_vote(fused, torch.tensor([[-1]], dtype=torch.int32),
                           slopes, window=0)
    assert (inactive == 0).all()


@pytest.fixture(scope="module")
def mask_case():
    """N = 6 items of D = 16, one pooling view each, all three ray axes."""
    from surfacenet_tpu.data.synthetic import make_sphere_scene

    scene = make_sphere_scene(n_views=6, hw=(96, 128))
    rng = np.random.default_rng(7)
    probs = rng.uniform(size=(6, 16, 16, 16)).astype(np.float32)
    origins = rng.uniform(-40, 10, (6, 3)).astype(np.float32)
    Ps = scene.Ps.astype(np.float32)
    return probs, origins, Ps


@pytest.mark.parametrize("window", [0, 2, 4])
def test_mask_batch_matches_pallas_interpret(mask_case, window):
    probs, origins, Ps = mask_case
    ref = np.asarray(ray_max_mask_affine_pallas(
        jnp.asarray(probs), jnp.asarray(origins), S, jnp.asarray(Ps),
        window=window, interpret=True,
    ))
    got = ray_max_mask_affine_batch(torch.tensor(probs),
                                    torch.tensor(origins), S,
                                    torch.tensor(Ps), window=window).numpy()
    assert got.dtype == bool and got.shape == probs.shape
    agree = (got == ref).reshape(len(probs), -1).mean(axis=1)
    assert (agree >= 0.999).all(), agree
    axis, _ = item_params(torch.tensor(origins), S, torch.tensor(Ps), 16)
    assert len(set(axis.tolist())) > 1  # more than one ray axis exercised
    # the kernel's wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(
        ray_max_mask_affine_cuda(torch.tensor(probs), torch.tensor(origins),
                                 S, torch.tensor(Ps), window=window).numpy(),
        got)


@pytest.mark.parametrize("window", [0, 2])
def test_masks_summed_over_views_are_the_votes(case, window):
    probs, origins, Ps_pool, mask = case
    axis, slopes = vote_params(torch.tensor(origins), S,
                               torch.tensor(Ps_pool), torch.tensor(mask), D)
    votes = ray_vote_affine_plain(torch.tensor(probs), axis, slopes, window)
    masks = affine_pool(
        torch.tensor(probs).repeat_interleave(K, dim=0),
        axis.reshape(-1).contiguous(), slopes.reshape(-1, 2).contiguous(),
        window,
    ).reshape(N, K, D, D, D)
    # inactive slots (axis -1) give all-False masks
    assert not masks[torch.tensor(~mask)].any()
    np.testing.assert_array_equal(masks.sum(dim=1).numpy(), votes.numpy())


@pytest.mark.parametrize("D,K,window,route", [
    (64, 6, 2, "tile"), (64, 1, 1, "tile"), (17, 6, 4, "tile"),
    (64, 6, 0, "segment"), (64, 1, -1, "segment"), (17, 6, 16, "segment"),
    (64, 6, 63, "segment"), (64, 6, 5, "direct"), (64, 65, 2, "direct"),
])
def test_affine_route_by_shape(D, K, window, route):
    """The kernels' route follows the shapes alone: the tile for windows
    1-4 (at most 64 views a cube), the segment for the whole ray (window 0,
    or D - 1 and more, the same taps), the first design otherwise."""
    assert affine_route(D, K, window) == route


def test_affine_pool_rejects_bad_inputs():
    probs = torch.zeros((2, 4, 4, 4))
    axis = torch.zeros(2, dtype=torch.int32)
    slopes = torch.zeros((2, 2))
    for bad in (dict(probs=probs.double()), dict(probs=probs[:, :3]),
                dict(axis=axis.long()), dict(axis=axis[:1]),
                dict(slopes=slopes[:, :1]),
                dict(slopes=slopes.t().contiguous().t())):
        args = dict(probs=probs, axis=axis, slopes=slopes) | bad
        with pytest.raises(ValueError):
            affine_pool(**args)


@pytest.mark.parametrize("window", [0, 2])
def test_exact_mask_matches_reference(mask_case, window):
    """The exact (scatter-max raster) mask against the reference's
    ``ray_max_mask_single_view`` on each item: agreement >= 0.999 per item
    (the two project with differently rounded divisions, so a voxel centre
    on a raster-cell or depth-bin edge may fall on either side)."""
    import jax

    from surfacenet_tpu.ops.ray_pooling import ray_max_mask_single_view

    probs, origins, Ps = mask_case
    ref = np.asarray(jax.vmap(
        lambda p, o, P: ray_max_mask_single_view(p, o, S, P, window=window)
    )(jnp.asarray(probs), jnp.asarray(origins), jnp.asarray(Ps)))
    got = ray_max_mask_exact(torch.tensor(probs), torch.tensor(origins), S,
                             torch.tensor(Ps), window=window).numpy()
    assert got.dtype == bool and got.shape == probs.shape
    agree = (got == ref).reshape(len(probs), -1).mean(axis=1)
    assert (agree >= 0.999).all(), agree
    assert 0.01 < got.mean() < 0.9


@pytest.mark.parametrize("window", [0, 2])
def test_exact_ray_pool_matches_reference(case, window):
    """The exact ``ray_pool`` with padded pooling slots against the
    reference's ``ray_pool(mode="exact")`` per cube, and without a mask
    against its ``ray_pool_batch`` with views shared by every cube: votes
    and occupancy agree on >= 0.999 of the voxels."""
    import jax

    from surfacenet_tpu.ops.ray_pooling import ray_pool as j_pool
    from surfacenet_tpu.ops.ray_pooling import ray_pool_batch as j_batch

    probs, origins, Ps_pool, mask = case
    taus = np.array([0.3, 0.5, 0.2, 0.4], np.float32)
    occ_j, votes_j = jax.vmap(
        lambda p, o, P, t, m: j_pool(p, o, S, P, t, 0.6, mode="exact",
                                     view_mask=m, window=window)
    )(jnp.asarray(probs), jnp.asarray(origins), jnp.asarray(Ps_pool),
      jnp.asarray(taus), jnp.asarray(mask))
    occ_t, votes_t = ray_pool(
        torch.tensor(probs), torch.tensor(origins), S, torch.tensor(Ps_pool),
        torch.tensor(taus), 0.6, view_mask=torch.tensor(mask), window=window)
    assert votes_t.dtype == torch.int32 and occ_t.dtype == torch.bool
    assert (votes_t.numpy() == np.asarray(votes_j)).mean() >= 0.999
    assert (occ_t.numpy() == np.asarray(occ_j)).mean() >= 0.999
    assert occ_t.any()
    shared = Ps_pool[0]
    occ_j, votes_j = j_batch(jnp.asarray(probs), jnp.asarray(origins), S,
                             jnp.asarray(shared), 0.3, 0.5, mode="exact",
                             window=window)
    occ_t, votes_t = ray_pool(
        torch.tensor(probs), torch.tensor(origins), S,
        torch.tensor(shared).expand(len(probs), *shared.shape), 0.3, 0.5,
        window=window)
    assert (votes_t.numpy() == np.asarray(votes_j)).mean() >= 0.999
    assert (occ_t.numpy() == np.asarray(occ_j)).mean() >= 0.999
