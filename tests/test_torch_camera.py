"""Port parity: config, camera geometry and host data modules.

The same numpy inputs go through the JAX package and the PyTorch port
(``device="cpu"``).  Geometry tolerance: 1e-5 relative (float32, with the
reference's Newton-refined reciprocal against the port's true division).
"""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import surfacenet_tpu.geometry.camera as J
import surfacenet_tpu_torch.geometry.camera as T
from surfacenet_tpu.config import Config as JConfig
from surfacenet_tpu.config import baseline_config as j_baseline
from surfacenet_tpu_torch.config import Config as TConfig
from surfacenet_tpu_torch.config import baseline_config as t_baseline

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESETS = ("dtu9_single", "dtu9_full", "dtu9_paper", "dtu_eval_split",
           "highres_sharded", "tanks_temples", "golden_aligned",
           "golden_fast")


@pytest.fixture(scope="module")
def cams():
    from surfacenet_tpu.data.synthetic import make_sphere_scene

    sc = make_sphere_scene(n_views=5, hw=(90, 120))
    rng = np.random.default_rng(0)
    pts = rng.uniform(-45, 45, (300, 3)).astype(np.float32)
    return sc, sc.Ps.astype(np.float32), pts


@pytest.mark.parametrize("name", PRESETS)
def test_baseline_config_matches_reference(name):
    assert t_baseline(name).to_json() == j_baseline(name).to_json()


def test_preset_files_load_like_reference():
    for path in sorted(glob.glob(os.path.join(ROOT, "configs", "*.json"))):
        with open(path) as f:
            raw = f.read()
        assert TConfig.from_json(raw).to_json() == JConfig.from_json(raw).to_json()
    with open(os.path.join(ROOT, "configs", "dtu9_full.json")) as f:
        assert TConfig.from_json(f.read()) == t_baseline("dtu9_full")


def test_project_matches_reference(cams):
    _, Ps, pts = cams
    uv_j, w_j = J.project(jnp.asarray(Ps), jnp.asarray(pts))
    uv_t, w_t = T.project(torch.tensor(Ps), torch.tensor(pts))
    np.testing.assert_allclose(uv_t.numpy(), np.asarray(uv_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-5)
    # one camera, batched points
    uv1, _ = T.project(torch.tensor(Ps[2]), torch.tensor(pts))
    np.testing.assert_allclose(uv1.numpy(), uv_t[2].numpy(), rtol=1e-6)


def test_camera_center_and_baseline_angle(cams):
    _, Ps, pts = cams
    c_j = np.asarray(J.camera_center(jnp.asarray(Ps)))
    c_t = T.camera_center(torch.tensor(Ps)).numpy()
    np.testing.assert_allclose(c_t, c_j, rtol=1e-5, atol=1e-4)
    a_j = J.baseline_angle(jnp.asarray(Ps[0]), jnp.asarray(Ps[1]),
                           jnp.asarray(pts))
    a_t = T.baseline_angle(torch.tensor(Ps[0]), torch.tensor(Ps[1]),
                           torch.tensor(pts))
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=1e-5,
                               atol=1e-6)


def test_frustum_and_cube_visibility(cams):
    sc, Ps, pts = cams
    hw = sc.images.shape[1:3]
    f_j = np.asarray(J.in_frustum(jnp.asarray(Ps), jnp.asarray(pts), hw))
    f_t = T.in_frustum(torch.tensor(Ps), torch.tensor(pts), hw).numpy()
    assert (f_j == f_t).mean() > 0.999
    origins = np.random.default_rng(1).uniform(-60, 30, (40, 3)).astype(
        np.float32)
    v_j = np.asarray(J.cube_visible(jnp.asarray(Ps), jnp.asarray(origins),
                                    16.0, hw))
    v_t = T.cube_visible(torch.tensor(Ps), torch.tensor(origins), 16.0,
                         hw).numpy()
    assert v_t.shape == v_j.shape == (40, 5)
    assert (v_j == v_t).mean() > 0.995
    c_j = np.asarray(J.cube_corners(jnp.asarray(origins), 16.0))
    c_t = T.cube_corners(torch.tensor(origins), 16.0).numpy()
    np.testing.assert_array_equal(c_t, c_j)


def test_voxel_centers_bbox_and_look_at(cams):
    sc, _, _ = cams
    o = np.array([-3.0, 1.5, 2.25], np.float32)
    np.testing.assert_allclose(
        T.voxel_centers(torch.tensor(o), 8, 0.4).numpy(),
        np.asarray(J.voxel_centers(jnp.asarray(o), 8, 0.4)), rtol=1e-6)
    for a, b in zip(T.estimate_bbox_from_cameras(sc.Ps),
                    J.estimate_bbox_from_cameras(sc.Ps)):
        np.testing.assert_array_equal(a, b)
    args = ([100.0, 20.0, 30.0], [0.0, 0.0, 0.0], [0, 0, 1.0], 250.0,
            (60.0, 45.0))
    np.testing.assert_array_equal(T.look_at_projection(*args),
                                  J.look_at_projection(*args))


def test_sphere_scene_and_ply_roundtrip(tmp_path):
    from surfacenet_tpu.data.synthetic import make_sphere_scene as jscene
    from surfacenet_tpu.utils.ply import read_ply as j_read
    from surfacenet_tpu_torch.data.synthetic import make_sphere_scene
    from surfacenet_tpu_torch.utils.ply import read_ply, write_ply

    a = make_sphere_scene(n_views=3, hw=(60, 80))
    b = jscene(n_views=3, hw=(60, 80))
    np.testing.assert_array_equal(a.images, b.images)
    np.testing.assert_array_equal(a.Ps, b.Ps)
    np.testing.assert_array_equal(a.bbox_min, b.bbox_min)
    pts = a.surface_points(50)
    np.testing.assert_array_equal(pts, b.surface_points(50))
    np.testing.assert_allclose(a.surface_distance(pts), 0.0, atol=1e-9)
    path = str(tmp_path / "p.ply")
    write_ply(path, pts, np.full((50, 3), 0.25))
    got, col = read_ply(path)
    ref, ref_col = j_read(path)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(col, ref_col)


def test_tori_scene_matches_reference():
    """The tori golden scene: images, matrices, bbox and surface samples
    bit-identical to the reference's; the samples lie on the surface."""
    from surfacenet_tpu.data.synthetic import make_tori_scene as jscene
    from surfacenet_tpu_torch.data.synthetic import make_tori_scene

    a = make_tori_scene(n_views=3, hw=(48, 64))
    b = jscene(n_views=3, hw=(48, 64))
    np.testing.assert_array_equal(a.images, b.images)
    np.testing.assert_array_equal(a.Ps, b.Ps)
    np.testing.assert_array_equal(a.bbox_min, b.bbox_min)
    np.testing.assert_array_equal(a.bbox_max, b.bbox_max)
    pts = a.surface_points(300, seed=2)
    np.testing.assert_array_equal(pts, b.surface_points(300, seed=2))
    np.testing.assert_allclose(a.surface_distance(pts), 0.0, atol=1e-9)
    centers = np.random.default_rng(1).uniform(-30, 40, (200, 3))
    np.testing.assert_array_equal(a.occupancy(centers, 2.0),
                                  b.occupancy(centers, 2.0))
    assert (a.images != 0.1).any()  # the tori are in view


def test_scan_roundtrip_matches_reference_loader(tmp_path):
    from surfacenet_tpu.data.dtu import load_scan as j_load
    from surfacenet_tpu_torch.data.dtu import load_scan, write_scan
    from surfacenet_tpu_torch.data.synthetic import make_sphere_scene

    sc = make_sphere_scene(n_views=3, hw=(40, 50))
    d = str(tmp_path / "scan")
    write_scan(d, sc.images, sc.Ps, sc.bbox_min, sc.bbox_max)
    a, b = load_scan(d), j_load(d)
    np.testing.assert_array_equal(a.images, b.images)
    np.testing.assert_array_equal(a.Ps, b.Ps)
    np.testing.assert_array_equal(a.bbox_max, b.bbox_max)
