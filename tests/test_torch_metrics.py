"""Port parity: the reconstruction metrics (``utils/metrics.py``).

Both packages compute nearest-neighbour distances by the float32 expansion
``|q|^2 + |r|^2 - 2 q.r``, whose rounding error scales with the squared
norms (~1e3 mm^2 here), not with the squared distance (~1 mm^2): each
package is off the exact distance by up to ~1e-3 relative on single points,
in a float order of its own.  So per point the squared distances are held
within 1e-5 of the expansion's scale ``|q|^2 + |r|^2``, against the
reference and against a float64 brute force; the means, which average
those errors, within 1e-4 relative (measured 1.4e-5 at worst); medians,
which are single points, by the per-point bound; counts exactly.
``ObsMask`` (numpy in both packages) is equal on the same points.
"""

import numpy as np
import pytest
import torch

from surfacenet_tpu.utils import metrics as J
from surfacenet_tpu_torch.utils import metrics as T

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def clouds():
    """A sphere's surface samples (gt) and a noisy prediction with outliers."""
    from surfacenet_tpu.data.synthetic import make_sphere_scene

    scene = make_sphere_scene(n_views=4, hw=(60, 80))
    rng = np.random.default_rng(0)
    gt = scene.surface_points(3000)
    p = rng.normal(size=(2500, 3))
    p /= np.linalg.norm(p, axis=1, keepdims=True)
    pred = (30 + rng.normal(0, 1.0, (2500, 1))) * p
    pred[:60] += rng.uniform(-40, 40, (60, 3))
    return scene, pred, gt


def _exact(q, r):
    q, r = q.astype(np.float64), r.astype(np.float64)
    d2 = ((q[:, None, :] - r[None, :, :]) ** 2).sum(-1)
    return np.sqrt(d2.min(axis=1))


def test_min_dists_matches_reference_and_exact(clouds):
    _, pred, gt = clouds
    q, r = pred.astype(np.float32), gt.astype(np.float32)
    got = T.min_dists(q, r, chunk=1000, device="cpu")
    ref = J.min_dists(q, r)
    exact = _exact(q, r)
    assert got.dtype == np.float32 and got.shape == (len(q),)
    scale = (q.astype(np.float64) ** 2).sum(1) + (r.astype(np.float64)
                                                  ** 2).sum(1).max()
    for other in (ref, exact):
        d2_err = np.abs(got.astype(np.float64) ** 2 - other ** 2)
        assert (d2_err <= 1e-5 * scale).all()
    # chunking does not change the answer's accuracy class
    whole = T.min_dists(q, r, device="cpu")
    assert (np.abs(whole ** 2 - got ** 2) <= 1e-5 * scale).all()


@pytest.mark.parametrize("max_dist", [None, 5.0])
def test_accuracy_completeness_matches_reference(clouds, max_dist):
    _, pred, gt = clouds
    got = T.accuracy_completeness(pred, gt, max_dist=max_dist, device="cpu")
    ref = J.accuracy_completeness(pred, gt, max_dist=max_dist)
    np.testing.assert_allclose(got, ref, rtol=1e-4)
    assert T.accuracy_completeness(np.zeros((0, 3)), gt,
                                   device="cpu") == (np.inf, np.inf)


def test_dtu_eval_with_obs_mask_and_plane_matches_reference(clouds,
                                                            tmp_path):
    scene, pred, gt = clouds
    args = (scene.Ps, scene.images.shape[1:3], scene.bbox_min,
            scene.bbox_max)
    mask_t = T.ObsMask.from_cameras(*args, res_mm=4.0)
    mask_j = J.ObsMask.from_cameras(*args, res_mm=4.0)
    np.testing.assert_array_equal(mask_t.vol, mask_j.vol)
    assert 0.05 < mask_t.vol.mean() < 0.95  # the mask does drop points
    path = str(tmp_path / "mask.npz")
    mask_t.save(path)
    loaded = T.ObsMask.load(path)
    np.testing.assert_array_equal(loaded.vol, mask_t.vol)
    np.testing.assert_array_equal(loaded.contains(pred),
                                  mask_j.contains(pred))
    plane = [0.1, 0.2, 1.0, 5.0]
    got = T.dtu_eval(pred, gt, max_dist=5.0, obs_mask=loaded, plane=plane,
                     device="cpu")
    ref = J.dtu_eval(pred, gt, max_dist=5.0, obs_mask=mask_j, plane=plane)
    assert set(got) == set(ref)
    for k in ("n_pred_total", "n_pred_eval", "n_gt_total", "n_gt_eval"):
        assert got[k] == ref[k], k
    assert got["n_pred_eval"] < got["n_pred_total"]
    assert got["n_gt_eval"] < got["n_gt_total"]
    for k in ("acc_mean_mm", "comp_mean_mm", "overall_mm"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, err_msg=k)
    # a median is one point's distance: the per-point bound (an order
    # statistic moves no more than the values it is taken from)
    scale = 2 * max((pred ** 2).sum(1).max(), (gt ** 2).sum(1).max())
    for k in ("acc_median_mm", "comp_median_mm"):
        assert abs(got[k] ** 2 - ref[k] ** 2) <= 1e-5 * scale, k
    # an outlier sits exactly at max_dist only by chance: within one point
    assert abs(got["acc_outlier_frac"] - ref["acc_outlier_frac"]) \
        <= 1.0 / got["n_pred_eval"]
    assert got["acc_outlier_frac"] > 0
    empty = T.dtu_eval(np.zeros((0, 3)), gt, device="cpu")
    assert empty["overall_mm"] == np.inf


def test_metrics_refuse_missing_cuda(clouds, monkeypatch):
    _, pred, gt = clouds
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.accuracy_completeness(pred, gt)
