"""The resume ledger, run_sweep's resume and metrics, and observability.

A ledger written by either package's ``SparseCubeStore`` resumes in the
other: the same done set, merges bitwise equal (both merge natively), a
torn last line skipped, and the two packages write the same JSON lines for
the same cubes.  ``run_sweep`` on the CPU at the CLI tests' TINY settings
with the photoconsistency predictor: a sweep cut after half its cubes and
resumed from its ledger sweeps only the missing cubes, their core claims
equal an uninterrupted plan's, and the merged point set is the
uninterrupted one exactly (probabilities within 5e-5: the ledger keeps 4
decimals).  ``FlopModel`` counts and ``scaling_efficiency`` equal the
reference's; ``trace`` writes a Chrome trace.
"""

import json
import os

import numpy as np
import pytest
import torch

from surfacenet_tpu_torch.config import Config, FusionConfig, SweepConfig
from surfacenet_tpu_torch.config import ModelConfig, VoxelConfig
from surfacenet_tpu_torch.pipeline import sweep as TS
from surfacenet_tpu_torch.pipeline.sparse import CubeResult, SparseCubeStore
from surfacenet_tpu_torch.utils import observability as TO

torch.set_num_threads(2)

Dc, STRIDE = 8, 6

def _cubes(seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for g in [(0, 0, 0), (1, 0, 0), (0, 1, 1), (2, 1, 0), (1, 1, 1)]:
        occ = rng.uniform(size=(Dc,) * 3) > (0.8 if g != (2, 1, 0) else 1.1)
        prob = rng.uniform(size=(Dc,) * 3).astype(np.float32)
        col = rng.uniform(size=(Dc,) * 3 + (3,)).astype(np.float32)
        out.append((g, occ, prob, None if g == (0, 1, 1) else col))
    return out


def _kw(ledger):
    return dict(scene_origin=np.array([1.0, -2.0, 0.5]), voxel_size_mm=0.5,
                cube_size=Dc, stride=STRIDE, ledger_path=str(ledger),
                occupancy_vote=0.5)


def _tear(path):
    """Append half of a record, as a process killed mid-append leaves."""
    with open(path) as f:
        line = f.readline()
    with open(path, "a") as f:
        f.write(line[: len(line) // 2])


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_ledger_resumes_in_the_other_package(tmp_path, writer):
    from surfacenet_tpu.pipeline.sparse import CubeResult as JResult
    from surfacenet_tpu.pipeline.sparse import SparseCubeStore as JStore

    cubes = _cubes()
    lj, lt = tmp_path / "j.jsonl", tmp_path / "t.jsonl"
    js, ts = JStore(**_kw(lj)), SparseCubeStore(**_kw(lt))
    for g, occ, prob, col in cubes:
        js.add(JResult(g, occ, prob, col))
        ts.add(CubeResult(g, occ, prob, col))
    # record for record the reference's format
    assert lj.read_text() == lt.read_text()
    assert len(lj.read_text().splitlines()) == len(cubes)
    written = lj if writer == "reference" else lt
    _tear(written)
    # resume in the other package (and in the same one, as control)
    other = (SparseCubeStore(**_kw(written)) if writer == "reference"
             else JStore(**_kw(written)))
    same = (JStore(**_kw(written)) if writer == "reference"
            else SparseCubeStore(**_kw(written)))
    want_done = {tuple(g) for g, *_ in cubes}
    assert other.done_set() == same.done_set() == want_done
    assert len(other) == len(same) == len(cubes) - 1  # one cube is empty
    for a, b in zip(other.merge(), same.merge()):
        np.testing.assert_array_equal(a, b)
    # the ledger's 4 decimals, occupancy exact
    pts, probs, _ = ts.merge()
    np.testing.assert_array_equal(other.merge()[0], pts)
    np.testing.assert_allclose(other.merge()[1], probs, rtol=0, atol=5e-5)


def _sweep_cfg():
    """tests/test_torch_cli.py's TINY settings."""
    return Config(
        voxel=VoxelConfig(voxel_size_mm=2.0, cube_size=16, overlap=4),
        fusion=FusionConfig(n_view_pairs=2, tau=0.25,
                            ray_pool_mode="affine"),
        sweep=SweepConfig(cube_batch=8),
    )


@pytest.fixture(scope="module")
def sphere():
    from surfacenet_tpu_torch.data.synthetic import make_sphere_scene

    return make_sphere_scene(n_views=4, hw=(90, 120))


def _run(sc, cfg, ledger=None, metrics=None):
    return TS.run_sweep(sc.images, sc.Ps, sc.bbox_min, sc.bbox_max, cfg,
                        TS.photoconsistency_predictor, ledger_path=ledger,
                        metrics=metrics, device="cpu")


def test_run_sweep_resume_matches_uninterrupted(tmp_path, sphere):
    cfg = _sweep_cfg()
    full = str(tmp_path / "full.jsonl")
    store_a, stats_a = _run(sphere, cfg, full)
    lines = open(full).read().splitlines()
    assert len(lines) == stats_a.n_cubes_after_prefilter  # empty ones too
    keep = lines[: len(lines) // 2]
    cut = str(tmp_path / "cut.jsonl")
    torn = lines[len(keep)][: len(lines[len(keep)]) // 2]
    with open(cut, "w") as f:
        f.write("\n".join(keep) + "\n" + torn)
    kept = {tuple(json.loads(x)["grid_idx"]) for x in keep}
    missing = ({tuple(json.loads(x)["grid_idx"]) for x in lines} - kept)

    # the resumed plan: only the missing cubes, claiming what they claim
    # in the uninterrupted plan
    hw = sphere.images.shape[1:3]
    p_full = TS.plan_sweep(sphere.Ps, sphere.bbox_min, sphere.bbox_max, hw,
                           cfg, "cpu")
    p_res = TS.plan_sweep(sphere.Ps, sphere.bbox_min, sphere.bbox_max, hw,
                          cfg, "cpu", done=kept)
    assert {tuple(g) for g in p_res.grid} == missing
    assert p_res.n_prefilter == p_full.n_prefilter == len(lines)
    row = {tuple(g): i for i, g in enumerate(p_full.grid)}
    rows = [row[tuple(g)] for g in p_res.grid]
    np.testing.assert_array_equal(p_res.core_bounds[: p_res.n],
                                  p_full.core_bounds[rows])

    m = TO.Metrics(str(tmp_path / "m.jsonl"))
    store_b, stats_b = _run(sphere, cfg, cut, m)
    assert m.data["cubes_processed"] == len(missing)
    assert stats_b.n_cubes_after_prefilter == stats_a.n_cubes_after_prefilter
    assert stats_b.n_batches == -(-len(missing) // cfg.sweep.cube_batch)
    res_lines = open(cut).read().splitlines()
    swept = {tuple(json.loads(x)["grid_idx"])
             for x in res_lines[len(keep) + 1:]}
    assert swept == missing and len(res_lines) == len(keep) + 1 + len(missing)

    pa, qa, _ = store_a.merge()
    pb, qb, _ = store_b.merge()
    oa, ob = np.lexsort(pa.T), np.lexsort(pb.T)
    assert len(pa) > 200
    np.testing.assert_array_equal(pb[ob], pa[oa])
    np.testing.assert_allclose(qb[ob], qa[oa], rtol=0, atol=5e-5)
    # a second resume has nothing left to sweep; the zero-cube run is
    # still recorded
    m0 = TO.Metrics(str(tmp_path / "m0.jsonl"))
    store_c, stats_c = _run(sphere, cfg, cut, m0)
    assert stats_c.n_batches == 0
    rec = json.loads(open(tmp_path / "m0.jsonl").read())
    assert rec["cubes_per_s"] == 0.0 and rec["sweep_wall_s"] == 0.0
    np.testing.assert_array_equal(store_c.merge()[0], store_b.merge()[0])


def test_flop_model_and_scaling_match_reference():
    from surfacenet_tpu.config import ModelConfig as JModel
    from surfacenet_tpu.utils import observability as JO

    for name in ("__init__", "fast64", "tiny", "mxu_aligned"):
        jc = JModel() if name == "__init__" else getattr(JModel, name)()
        tc = (ModelConfig() if name == "__init__"
              else getattr(ModelConfig, name)())
        for D in (32, 64):
            j, t = JO.FlopModel(jc, D), TO.FlopModel(tc, D)
            assert t.conv_stack_flops() == j.conv_stack_flops()
            assert t.side_flops() == j.side_flops()
            assert t.cvc_gather_bytes(5) == j.cvc_gather_bytes(5)
            assert t.utilization(100.0, 197.0) == j.utilization(100.0, 197.0)
    tp = {1: 100.0, 2: 180.0, 4: 320.0}
    assert TO.scaling_efficiency(tp) == JO.scaling_efficiency(tp)
    assert TO.scaling_efficiency(tp, 2) == JO.scaling_efficiency(tp, 2)
    # no card here: the table's H100 figure is the default
    assert TO.detect_peak_tflops() == TO.PEAK_TFLOPS["H100"] == 989.0


def test_metrics_sink_and_trace(tmp_path, monkeypatch):
    m = TO.Metrics(str(tmp_path / "sub" / "m.jsonl"))
    m.count("cubes", 5)
    m.count("cubes", 3)
    m.gauge("occupancy", 0.12)
    with m.timer("stage"):
        pass
    assert m.snapshot()["cubes"] == 8 and m.snapshot()["stage_n"] == 1
    m.flush(extra={"round": 1})
    rec = json.loads(open(tmp_path / "sub" / "m.jsonl").read())
    assert rec["cubes"] == 8 and rec["round"] == 1 and "ts" in rec
    TO.Metrics(None).flush()  # no path: nothing written

    monkeypatch.delenv(TO.PROFILER_DIR_ENV, raising=False)
    with TO.trace("off"):
        torch.ones(4).sum()
    monkeypatch.setenv(TO.PROFILER_DIR_ENV, str(tmp_path / "prof"))
    with TO.trace("on"):
        torch.ones(64, 64).matmul(torch.ones(64, 64))
    files = os.listdir(tmp_path / "prof")
    assert len(files) == 1 and files[0].startswith("on.")
    assert "traceEvents" in json.load(open(tmp_path / "prof" / files[0]))
