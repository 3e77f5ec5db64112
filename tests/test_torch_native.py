"""The port's native merge and denoise against the reference's.

``native/`` is built by g++ into the git-ignored ``_build/`` at first use.
Bounds: the port's native merge and the reference's native merge are the
same C++ code built by the same compiler, so their outputs are bitwise
equal once sorted by coordinate (the hash map's order is not sorted); the
port's native merge against its numpy plain version: the same coordinate
set, probabilities and colours within 1e-6 (float32 sums against float64
sums of values in [0, 1] over at most 8 records).  Components: labels equal
up to a permutation, sizes exact; the filter mask exact.
"""

import time

import numpy as np
import pytest
import torch

from surfacenet_tpu_torch import native as T
from surfacenet_tpu_torch.ops import denoise as TD
from surfacenet_tpu_torch.pipeline.sparse import CubeResult, SparseCubeStore

torch.set_num_threads(2)

Dc, STRIDE = 8, 6


@pytest.fixture(scope="module")
def reference_native():
    """The reference's native module, loaded (it builds its library in its
    package directory; a concurrent test process may be building it)."""
    from surfacenet_tpu import native as J

    for _ in range(40):
        if J.load() is not None:
            return J
        time.sleep(0.5)
    pytest.fail("the reference's native library did not build")


def _stores(vote, seed=5):
    """A port store (native and numpy backends) of overlapping cubes, some
    processed but empty, and the records the merge consumes."""
    rng = np.random.default_rng(seed)
    kw = dict(scene_origin=np.array([-3.0, 1.0, 2.0]), voxel_size_mm=0.5,
              cube_size=Dc, stride=STRIDE, occupancy_vote=vote)
    stores = {b: SparseCubeStore(**kw, merge_backend=b)
              for b in ("native", "numpy")}
    grids = [(0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 1), (2, 0, 1),
             (1, 1, 0), (-1, 0, 0), (2, 2, 2)]
    for g in grids:
        occ = rng.uniform(size=(Dc,) * 3) > (0.5 if g != (2, 0, 1) else 1.1)
        prob = rng.uniform(size=(Dc,) * 3).astype(np.float32)
        col = rng.uniform(size=(Dc,) * 3 + (3,)).astype(np.float32)
        for s in stores.values():
            s.add(CubeResult(g, occ, prob, col))
    return stores


def _sorted(coords, *vals):
    o = np.lexsort(np.asarray(coords).T)
    return (coords[o],) + tuple(v[o] for v in vals)


@pytest.mark.parametrize("vote", [0.0, 0.5])
def test_native_merge_matches_reference_native(reference_native, vote):
    store = _stores(vote)["native"]
    coords, probs, colors = store._records()
    done = np.asarray(sorted(store.done_set()), np.int64)
    got = T.native_merge(coords, probs, colors, done, STRIDE, Dc, vote)
    want = reference_native.native_merge(coords, probs, colors, done,
                                         STRIDE, Dc, vote)
    # the same code on the same records: the same hash order too
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    for g, w in zip(_sorted(*got), _sorted(*want)):
        np.testing.assert_array_equal(g, w)
    assert len(got[0]) > 100
    if vote > 0:  # the vote dropped some voxels
        assert len(got[0]) < len(np.unique(coords, axis=0))


@pytest.mark.parametrize("vote", [0.0, 0.5])
def test_native_merge_matches_numpy_plain(vote):
    stores = _stores(vote)
    pn, qn, cn = _sorted(*stores["native"].merge())
    pp, qp, cp = _sorted(*stores["numpy"].merge())
    np.testing.assert_array_equal(pn, pp)
    np.testing.assert_allclose(qn, qp, rtol=0, atol=1e-6)
    np.testing.assert_allclose(cn, cp, rtol=0, atol=1e-6)
    assert len(pn) > 100


def _clusters(seed=2):
    """Unique voxel coords: blobs of assorted sizes, lines touching only
    diagonally (26- but not 6-connected), and isolated specks."""
    rng = np.random.default_rng(seed)
    pts = []
    for c, n in (((0, 0, 0), 400), ((40, 5, -9), 120), ((-30, 20, 7), 30),
                 ((10, -40, 3), 6)):
        pts.append(np.asarray(c) + rng.integers(-4, 5, (n, 3)))
    pts.append(np.arange(12)[:, None] * np.array([1, 1, 1]) + [60, 60, 60])
    pts.append(rng.integers(-200, 200, (25, 3)))
    return np.unique(np.concatenate(pts), axis=0).astype(np.int64)


def _same_partition(a, b):
    """Labels a and b describe the same partition (a bijection of ids)."""
    pairs = np.unique(np.stack([a, b], axis=1), axis=0)
    return (len(pairs) == len(np.unique(a)) == len(np.unique(b)))


@pytest.mark.parametrize("backend", ["native", "numpy"])
def test_connected_components_match_reference(backend):
    from surfacenet_tpu.ops.denoise import connected_components

    coords = _clusters()
    rng = np.random.default_rng(0)
    coords = coords[rng.permutation(len(coords))]
    lj, sj = connected_components(coords)
    lt, st = TD.connected_components(coords, backend=backend)
    assert lt.dtype == np.int64 and st.dtype == np.int64
    assert _same_partition(lj, lt)
    np.testing.assert_array_equal(st, sj)
    assert lt.min() == 0 and lt.max() == len(np.unique(lt)) - 1
    assert len(np.unique(lt)) > 25  # the specks are components of 1
    assert st.max() >= 300
    if backend == "native":  # the same code: the same numbering
        np.testing.assert_array_equal(lt, lj)
    assert len(TD.connected_components(coords[:0], backend)[0]) == 0


@pytest.mark.parametrize("min_size,keep_top", [
    (1, None), (5, None), (50, None), (0, 1), (0, 2), (5, 2), (50, 1),
])
def test_component_filter_mask_matches_reference(min_size, keep_top):
    from surfacenet_tpu.ops.denoise import component_filter_mask

    coords = _clusters()
    want = component_filter_mask(coords, min_size, keep_top)
    got = TD.component_filter_mask(coords, min_size, keep_top)
    np.testing.assert_array_equal(got, want)
    # the component sizes have no ties among the kept ones: the plain
    # version keeps the same records
    np.testing.assert_array_equal(
        TD.component_filter_mask(coords, min_size, keep_top, "numpy"), want)
    if min_size > 1 or keep_top is not None:
        assert 0 < got.sum() < len(coords)


def test_store_merge_denoises_like_reference(reference_native):
    """SparseCubeStore.merge(min_component, keep_top_components) against
    the reference's store on the same cubes: the same points, in the same
    order (both native), with bitwise probabilities and colours."""
    from surfacenet_tpu.pipeline.sparse import CubeResult as JResult
    from surfacenet_tpu.pipeline.sparse import SparseCubeStore as JStore

    rng = np.random.default_rng(9)
    kw = dict(scene_origin=np.zeros(3), voxel_size_mm=1.0, cube_size=Dc,
              stride=STRIDE, occupancy_vote=0.0)
    js, ts = JStore(**kw), SparseCubeStore(**kw)
    for g in [(0, 0, 0), (1, 0, 0), (0, 0, 1), (3, 3, 3)]:
        occ = rng.uniform(size=(Dc,) * 3) > 0.93
        prob = rng.uniform(size=(Dc,) * 3).astype(np.float32)
        js.add(JResult(g, occ, prob, None))
        ts.add(CubeResult(g, occ, prob, None))
    for mc, top in ((0, None), (3, None), (2, 3)):
        want = js.merge(min_component=mc, keep_top_components=top)
        got = ts.merge(min_component=mc, keep_top_components=top)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert len(got[0]) > 0


def test_failed_native_build_raises_with_compiler_output(tmp_path,
                                                         monkeypatch):
    """A source that does not compile raises; nothing falls back."""
    for src in T.SRCS:
        (tmp_path / src).write_text("int broken( {\n")
    monkeypatch.setattr(T, "_DIR", str(tmp_path))
    monkeypatch.setattr(T, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(T, "_lib", None)
    with pytest.raises(RuntimeError, match="(?s)build failed.*error:"):
        T.load()
    monkeypatch.setattr(T, "_lib", None)
    with pytest.raises(RuntimeError):
        T.native_components(np.zeros((3, 3), np.int64))
    assert not any(p.suffix == ".so" for p in (tmp_path / "build").iterdir())


def test_bad_inputs_are_refused():
    with pytest.raises(ValueError, match="merge_backend"):
        SparseCubeStore(np.zeros(3), 1.0, 8, 6, merge_backend="fast")
    with pytest.raises(ValueError, match="backend"):
        TD.connected_components(np.zeros((2, 3), np.int64), backend="gpu")
    with pytest.raises(ValueError, match=r"\(N, 3\)"):
        T.native_components(np.zeros((4, 2), np.int64))
    with pytest.raises(ValueError, match="range"):
        T.native_components(np.array([[1 << 20, 0, 0]]))
