"""COLMAP text models between the packages, and ``reconstruct --colmap``.

A model the reference's ``write_colmap_model`` wrote (PIL PNGs) loads in
the port, and the port's (its own PNG writer) loads in the reference: the
projection matrices within 1e-12 relative (each package rebuilds R from
the same quaternion text), the images bitwise and the ``points3D`` bbox
equal.  The parsers agree on camera models and blank 2D-point lines.
"""

import numpy as np
import pytest
import torch

from surfacenet_tpu_torch.data import colmap as TC

torch.set_num_threads(2)


def _decompose(P):
    """P = K [R|t] with K upper-triangular, positive diagonal, K[2,2] = 1."""
    from scipy.linalg import rq

    K, R = rq(P[:, :3])
    S = np.diag(np.sign(np.diag(K)))
    K, R = K @ S, S @ R
    t = np.linalg.solve(K, P[:, 3])
    return K / K[2, 2], R, t


@pytest.fixture(scope="module")
def model():
    from surfacenet_tpu_torch.data.synthetic import make_sphere_scene

    sc = make_sphere_scene(n_views=4, hw=(60, 80))
    Ks, Rs, ts = zip(*(_decompose(P) for P in sc.Ps))
    return sc, np.stack(Ks), np.stack(Rs), np.stack(ts)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_colmap_model_loads_in_both_packages(tmp_path, model, writer):
    from surfacenet_tpu.data import colmap as JC

    sc, Ks, Rs, ts = model
    pts = sc.surface_points(300)
    write = JC.write_colmap_model if writer == "reference" else \
        TC.write_colmap_model
    write(str(tmp_path / "sparse"), sc.images, Ks, Rs, ts, points3d=pts)
    got = TC.load_colmap_scan(str(tmp_path / "sparse"))
    want = JC.load_colmap_scan(str(tmp_path / "sparse"))
    want_Ps = np.stack([K @ np.concatenate([R, t[:, None]], 1)
                        for K, R, t in zip(Ks, Rs, ts)])
    for Ps in (got.Ps, want.Ps):
        np.testing.assert_allclose(Ps, want_Ps, rtol=1e-12,
                                   atol=1e-12 * np.abs(want_Ps).max())
    np.testing.assert_array_equal(got.Ps, want.Ps)
    np.testing.assert_allclose(got.Ps, sc.Ps, rtol=1e-9,
                               atol=1e-9 * np.abs(sc.Ps).max())
    u8 = np.clip(sc.images * 255, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.images, u8.astype(np.float32) / 255)
    np.testing.assert_array_equal(got.bbox_min, want.bbox_min)
    np.testing.assert_array_equal(got.bbox_max, want.bbox_max)
    assert got.name == want.name == "sparse"
    # a max_views cut and a downsample, as the reference's
    a = TC.load_colmap_scan(str(tmp_path / "sparse"), max_views=2,
                            downsample=2)
    b = JC.load_colmap_scan(str(tmp_path / "sparse"), max_views=2,
                            downsample=2)
    np.testing.assert_array_equal(a.images, b.images)
    np.testing.assert_array_equal(a.Ps, b.Ps)


def test_colmap_parsers_match_reference(tmp_path):
    from surfacenet_tpu.data import colmap as JC

    cams = tmp_path / "cameras.txt"
    cams.write_text(
        "# c\n1 PINHOLE 80 60 100.5 101.5 40 30\n"
        "2 SIMPLE_PINHOLE 80 60 99 41 29\n"
        "3 SIMPLE_RADIAL 80 60 98 40.5 30.5 0.01\n"
        "4 OPENCV 80 60 97 96 40 30 0.1 0.2 0 0\n")
    with pytest.warns(UserWarning):
        got = TC.parse_cameras(str(cams))
    with pytest.warns(UserWarning):
        want = JC.parse_cameras(str(cams))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    bad = tmp_path / "bad.txt"
    bad.write_text("1 FISHEYE 80 60 1 2 3\n")
    with pytest.raises(ValueError, match="unsupported"):
        TC.parse_cameras(str(bad))
    imgs = tmp_path / "images.txt"
    imgs.write_text(
        "# i\n2 0.9 0.1 0.2 0.3 1 2 3 1 b.png\n\n"
        "1 1 0 0 0 4 5 6 2 a.png\n10.0 20.0 -1 30.0 40.0 7\n")
    got, want = TC.parse_images(str(imgs)), JC.parse_images(str(imgs))
    assert [g[:2] for g in got] == [w[:2] for w in want] == [
        ("a.png", 2), ("b.png", 1)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[2], w[2])
        np.testing.assert_array_equal(g[3], w[3])


def test_reconstruct_colmap_cli(tmp_path, model):
    """``reconstruct --colmap`` on the CPU: the model's bbox from its
    points, the sweep at the CLI tests' small settings."""
    from surfacenet_tpu_torch.cli import main
    from surfacenet_tpu_torch.utils.ply import read_ply

    sc, Ks, Rs, ts = model
    TC.write_colmap_model(str(tmp_path / "sparse"), sc.images, Ks, Rs, ts,
                          points3d=sc.surface_points(500))
    out = str(tmp_path / "c.ply")
    n, stats, _ = main([
        "reconstruct", "--colmap", "--scan", str(tmp_path / "sparse"),
        "--out", out, "--device", "cpu",
        "--set", "voxel.cube_size=16", "--set", "voxel.voxel_size_mm=2.0",
        "--set", "voxel.overlap=4", "--set", "fusion.n_view_pairs=2",
        "--set", "fusion.tau=0.25", "--set", "sweep.cube_batch=8"])
    pts, _ = read_ply(out)
    assert n == len(pts) > 50 and np.isfinite(pts).all()
    assert stats.n_cubes_after_prefilter > 0
