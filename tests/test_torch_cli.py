"""The port's CLI on the CPU, and its refusal to fall back to the CPU.

``selftest`` (sphere: exact pooling; tori: affine, window 1) against the
reference's ``run_sweep`` and ``accuracy_completeness`` on the same config
and scene: merged voxel sets agree on >= 0.99 of their union, accuracy and
completeness within 2%.  ``eval`` against the reference's metrics within
1e-4 relative (the float32 distance expansion; tests/test_torch_metrics.py).
The reference sweeps once per scene, shared by the module.
``reconstruct --min-component`` against the reference's ``.ply`` (same
count, agreement >= 0.99); ``--sharded`` on one device exits with the
reference's message unless ``--allow-unsharded`` (on 2 ranks:
tests/test_torch_sweep_sharded.py); ``export`` round-trips
within 1e-5, the reference's self-check bound, unfused and fused.
"""

import numpy as np
import pytest
import torch

from surfacenet_tpu_torch.cli import main, selftest_setup
from surfacenet_tpu_torch.utils.metrics import voxel_set_agreement
from surfacenet_tpu_torch.utils.ply import read_ply, write_ply

torch.set_num_threads(2)

TINY = [
    "--set", "voxel.cube_size=16", "--set", "voxel.voxel_size_mm=2.0",
    "--set", "voxel.overlap=4", "--set", "fusion.n_view_pairs=2",
    "--set", "fusion.tau=0.25", "--set", "sweep.cube_batch=8",
    "--set", "fusion.ray_pool_mode=affine",
]


@pytest.fixture(scope="module")
def reference_selftest():
    """The reference's selftest per scene: its Config, built as its
    ``cli selftest`` builds it, the swept points and the metrics."""
    from surfacenet_tpu.config import (
        Config, FusionConfig, SweepConfig, VoxelConfig,
    )
    from surfacenet_tpu.pipeline.sweep import (
        photoconsistency_predictor, run_sweep,
    )
    from surfacenet_tpu.utils.metrics import accuracy_completeness

    runs = {}

    def get(scene):
        if scene not in runs:
            hard = scene == "tori"
            cfg = Config(
                voxel=VoxelConfig(voxel_size_mm=2.0, cube_size=16,
                                  overlap=4),
                fusion=FusionConfig(
                    n_view_pairs=3, tau=0.25, gamma=0.6,
                    **({"pool_window_vox": 1, "ray_pool_mode": "affine"}
                       if hard else {}),
                ),
                sweep=SweepConfig(cube_batch=8),
            )
            _, sc = selftest_setup(scene)  # bit-identical scenes
            store, _ = run_sweep(sc.images, sc.Ps, sc.bbox_min, sc.bbox_max,
                                 cfg, photoconsistency_predictor)
            pts, _, _ = store.merge()
            runs[scene] = (cfg, pts, accuracy_completeness(
                pts, sc.surface_points(4000)))
        return runs[scene]

    return get


@pytest.fixture(scope="module")
def scan_dir(tmp_path_factory):
    from surfacenet_tpu_torch.data.dtu import write_scan
    from surfacenet_tpu_torch.data.synthetic import make_sphere_scene

    sc = make_sphere_scene(n_views=4, hw=(90, 120))
    d = str(tmp_path_factory.mktemp("scan") / "scan")
    write_scan(d, sc.images, sc.Ps, sc.bbox_min, sc.bbox_max)
    return d


def test_reconstruct_cli_cpu(tmp_path, scan_dir, capsys):
    out = str(tmp_path / "out.ply")
    main(["reconstruct", "--scan", scan_dir, "--out", out, "--device", "cpu",
          *TINY])
    pts, colors = read_ply(out)
    assert len(pts) > 50
    assert "photoconsistency" in capsys.readouterr().out


def test_reconstruct_cli_preset_with_npz_checkpoint(tmp_path, scan_dir):
    """--preset dtu9_full (narrowed by --set) with --checkpoint .npz weights:
    bf16 model, kernel-path switches and the refinement prepass, on the CPU."""
    from surfacenet_tpu_torch.config import ModelConfig
    from surfacenet_tpu_torch.models.convert import save_npz
    from surfacenet_tpu_torch.models.surfacenet import init_surfacenet

    ckpt = str(tmp_path / "w.npz")
    tiny = ModelConfig.tiny()
    save_npz(init_surfacenet(tiny, torch.Generator().manual_seed(0))
             .state_dict(), ckpt)
    out = str(tmp_path / "m.ply")
    main([
        "reconstruct", "--scan", scan_dir, "--out", out, "--device", "cpu",
        "--preset", "dtu9_full", "--checkpoint", ckpt, *TINY,
        "--set", "model.block_channels=[8,12,16,16]",
        "--set", "model.convs_per_block=[1,1,1,1]",
        "--set", "model.side_channels=4",
        "--set", "sweep.refine_calib_steps=2",
        "--set", "sweep.refine_calib_probes=128",
    ])
    pts, _ = read_ply(out)
    assert np.isfinite(pts).all()


def test_reconstruct_cli_fused_inference_runs_the_fused_forward(
        tmp_path, scan_dir, monkeypatch):
    """--set model.fused_inference=true reaches the config and routes the
    predictor through fused_infer_apply: on the CPU every 3^3 conv is the
    conv kernel's plain version, and SurfaceNet.forward is never called."""
    import surfacenet_tpu_torch.ops.cuda.conv3d as cuda_conv
    from surfacenet_tpu_torch.config import ModelConfig
    from surfacenet_tpu_torch.models.convert import save_npz
    from surfacenet_tpu_torch.models.surfacenet import (
        SurfaceNet, init_surfacenet,
    )

    ckpt = str(tmp_path / "tiny.npz")
    save_npz(init_surfacenet(ModelConfig.tiny(),
                             torch.Generator().manual_seed(0)).state_dict(),
             ckpt)
    calls = []
    plain = cuda_conv.conv3d_plain

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return plain(*args, **kw)

    def refuse(*args, **kw):
        raise AssertionError("the unfused forward ran")

    monkeypatch.setattr(cuda_conv, "conv3d_plain", counted)
    monkeypatch.setattr(SurfaceNet, "forward", refuse)
    out = str(tmp_path / "f.ply")
    main(["reconstruct", "--scan", scan_dir, "--out", out, "--device", "cpu",
          "--checkpoint", ckpt, *TINY,
          "--set", "model.block_channels=[8,12,16,16]",
          "--set", "model.convs_per_block=[1,1,1,1]",
          "--set", "model.side_channels=4",
          "--set", 'model.dtype="float32"',
          "--set", "model.fused_inference=true"])
    # four convs a forward, one forward per cube batch
    assert calls and len(calls) % 4 == 0
    pts, _ = read_ply(out)
    assert np.isfinite(pts).all()


@pytest.mark.parametrize("scene", ["sphere", "tori"])
def test_selftest_matches_reference(reference_selftest, scene, capsys):
    from surfacenet_tpu_torch.config import Config

    cfg_j, pts_j, (acc_j, comp_j) = reference_selftest(scene)
    cfg_t, _ = selftest_setup(scene)
    assert cfg_t == Config.from_json(cfg_j.to_json())
    assert cfg_t.fusion.ray_pool_mode == ("affine" if scene == "tori"
                                          else "exact")
    pts, acc, comp, stats = main(["selftest", "--scene", scene,
                                  "--device", "cpu"])
    assert capsys.readouterr().out.startswith(f"selftest: {len(pts)} points")
    assert len(pts) > 500
    assert voxel_set_agreement(pts, pts_j) >= 0.99
    np.testing.assert_allclose([acc, comp], [acc_j, comp_j], rtol=0.02)


@pytest.mark.parametrize("protocol", ["clamp", "dtu"])
def test_eval_cli_matches_reference(tmp_path, protocol):
    from surfacenet_tpu.utils.metrics import ObsMask as JMask
    from surfacenet_tpu.utils.metrics import accuracy_completeness, dtu_eval
    from surfacenet_tpu_torch.data.synthetic import make_sphere_scene

    sc = make_sphere_scene(n_views=4, hw=(60, 80))
    rng = np.random.default_rng(3)
    gt = sc.surface_points(2000)
    pred = gt[:1500] * (1 + rng.normal(0, 0.02, (1500, 1)))
    pred[:30] += rng.uniform(-30, 30, (30, 3))
    pred_path, gt_path = str(tmp_path / "pred.ply"), str(tmp_path / "gt.ply")
    write_ply(pred_path, pred)
    write_ply(gt_path, gt)
    pred32, gt32 = read_ply(pred_path)[0], read_ply(gt_path)[0]
    args = ["eval", "--pred", pred_path, "--gt", gt_path, "--max-dist",
            "4", "--device", "cpu", "--protocol", protocol]
    if protocol == "clamp":
        got = main(args)
        acc, comp = accuracy_completeness(pred32, gt32, max_dist=4.0)
        ref = {"acc_mean_mm": acc, "comp_mean_mm": comp}
    else:
        mask = JMask.from_cameras(sc.Ps, (60, 80), sc.bbox_min, sc.bbox_max)
        mask_path = str(tmp_path / "mask.npz")
        mask.save(mask_path)
        got = main(args + ["--obs-mask", mask_path, "--plane", "0,0,1,3"])
        ref = dtu_eval(pred32, gt32, max_dist=4.0, obs_mask=mask,
                       plane=[0, 0, 1, 3])
        assert got["n_pred_eval"] == ref["n_pred_eval"] < len(pred)
        assert got["n_gt_eval"] == ref["n_gt_eval"] < len(gt)
    for k in ("acc_mean_mm", "comp_mean_mm"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, err_msg=k)
    assert np.isfinite(got["overall_mm"])


def test_reconstruct_cli_refuses_min_component(tmp_path, scan_dir):
    """``--min-component 5`` (the denoise, once refused) and the ledger
    through the CLI against the reference's ``cli reconstruct`` on the same
    scan: the same point count, voxel agreement >= 0.99 (the sweep's
    parity bound), fewer points than without the denoise; and
    ``--keep-top-components 1`` keeps one 26-connected cluster."""
    from surfacenet_tpu.cli import main as jmain
    from surfacenet_tpu_torch.ops.denoise import connected_components

    args = ["reconstruct", "--scan", scan_dir, *TINY, "--min-component", "5"]
    jmain(args + ["--out", str(tmp_path / "j.ply")])
    n, _, _ = main(args + ["--out", str(tmp_path / "t.ply"), "--device",
                           "cpu", "--ledger", str(tmp_path / "l.jsonl")])
    pj, pt = read_ply(str(tmp_path / "j.ply"))[0], read_ply(
        str(tmp_path / "t.ply"))[0]
    assert n == len(pt) == len(pj) > 50
    assert voxel_set_agreement(pt, pj) >= 0.99
    # from the ledger (no sweep), without the denoise, and the largest
    # cluster alone
    n_all, st, _ = main(args[:-2] + ["--out", str(tmp_path / "a.ply"),
                                     "--device", "cpu", "--ledger",
                                     str(tmp_path / "l.jsonl")])
    assert st.n_batches == 0 and n_all > n
    n_top, _, _ = main(args[:-2] + ["--out", str(tmp_path / "k.ply"),
                                    "--device", "cpu", "--ledger",
                                    str(tmp_path / "l.jsonl"),
                                    "--keep-top-components", "1"])
    top = read_ply(str(tmp_path / "k.ply"))[0]
    assert 0 < n_top == len(top) < n
    vox = np.round(top / 2.0 - 0.5).astype(np.int64)  # 2 mm voxels
    assert len(np.unique(connected_components(vox)[0])) == 1


def test_sharded_request_on_one_device(tmp_path, scan_dir, capsys):
    """``--sharded`` (or ``mesh.block_axis > 1``) on one device exits with
    the reference's message; ``--allow-unsharded`` then sweeps on one
    device with the config's other settings."""
    from surfacenet_tpu.cli import _degrade_or_die as jdegrade

    why = ("sharded sweep needs block_axis=2 to divide the 1 available "
           "device(s)")

    class Args:
        allow_unsharded = False

    with pytest.raises(SystemExit) as want:
        jdegrade(Args, why)
    out = str(tmp_path / "s.ply")
    base = ["reconstruct", "--scan", scan_dir, "--out", out, "--device",
            "cpu", *TINY]
    for extra in (["--set", "mesh.block_axis=2"],
                  ["--sharded", "--set", "mesh.block_axis=2"]):
        with pytest.raises(SystemExit) as got:
            main(base + extra)
        assert str(got.value) == str(want.value)
    with pytest.raises(SystemExit, match="block_axis=1 to divide the 1"):
        main(base + ["--sharded"])
    n, stats, _ = main(base + ["--set", "mesh.block_axis=2",
                               "--allow-unsharded"])
    assert "running unsharded (--allow-unsharded)" in capsys.readouterr().out
    assert n == len(read_ply(out)[0]) > 50 and stats.n_batches > 0


def test_sharded_request_on_several_cards_raises(monkeypatch):
    """Where the sharded sweep can run (a world of 2 ranks, block_axis 2)
    the layout is sharded with the config unchanged (it once raised here:
    the sharded sweep was not ported); a world block_axis 2 does not
    divide (3 ranks) takes ``--allow-unsharded``'s single-device sweep."""
    from surfacenet_tpu_torch.cli import _sweep_layout
    from surfacenet_tpu_torch.config import baseline_config
    from surfacenet_tpu_torch.parallel import distributed

    class Args:
        sharded = allow_unsharded = True

    cfg = baseline_config("highres_sharded")
    joined = []
    monkeypatch.setattr(distributed, "init_distributed",
                        lambda device: joined.append(device))
    monkeypatch.setattr(distributed, "process_info", lambda: (0, 2))
    got, sharded = _sweep_layout(Args, cfg, torch.device("cpu"))
    assert sharded and got == cfg and joined == [torch.device("cpu")]
    monkeypatch.setattr(distributed, "process_info", lambda: (0, 3))
    got, sharded = _sweep_layout(Args, cfg, torch.device("cpu"))
    assert not sharded and got.mesh.block_axis == 1
    assert got.replace(mesh=cfg.mesh) == cfg


def test_export_round_trip_unfused_and_fused(tmp_path):
    """``cli export`` of a small net on the CPU, unfused and fused: the
    loaded program against the direct forward within 1e-5 (the reference's
    self-check bound); the fused program calls the registered conv op and
    equals ``fused_infer_apply``."""
    from surfacenet_tpu_torch.cli import _apply_overrides
    from surfacenet_tpu_torch.config import Config, ModelConfig
    from surfacenet_tpu_torch.models.convert import (
        load_surfacenet, save_npz,
    )
    from surfacenet_tpu_torch.models.surfacenet import (
        fused_infer_apply, fused_params, init_surfacenet,
    )

    ckpt = str(tmp_path / "tiny.npz")
    save_npz(init_surfacenet(ModelConfig.tiny(),
                             torch.Generator().manual_seed(0)).state_dict(),
             ckpt)
    tiny = ["--set", "voxel.cube_size=16",
            "--set", "model.block_channels=[8,12,16,16]",
            "--set", "model.convs_per_block=[1,1,1,1]",
            "--set", "model.side_channels=4"]
    out = str(tmp_path / "f.pt2")
    r = main(["export", "--checkpoint", ckpt, "--out", out, "--batch", "2",
              "--device", "cpu", "--selfcheck", *tiny])
    assert r["selfcheck_err"] <= 1e-5 and r["bytes"] > 10000
    prog = torch.export.load(out)
    x = torch.rand((2, 16, 16, 16, 6)) - 0.5
    assert prog.module()(x).shape == (2, 16, 16, 16)

    fused = str(tmp_path / "fused.pt2")
    r = main(["export", "--checkpoint", ckpt, "--out", fused, "--batch",
              "2", "--device", "cpu", "--selfcheck", *tiny,
              "--set", "model.fused_inference=true"])
    assert r["selfcheck_err"] <= 1e-5 and r["bytes"] > 10000
    prog = torch.export.load(fused)
    ops = [str(n.target) for n in prog.graph.nodes
           if n.op == "call_function"]
    # 4 blocks of one conv each
    assert ops.count("surfacenet_tpu_torch.conv3d.default") == 4
    # the command's model config: the default Config()'s with tiny widths
    cfg = _apply_overrides(Config(), tiny[1::2] + [
        "model.fused_inference=true"]).model
    params = fused_params(load_surfacenet(ckpt, cfg).state_dict(), cfg,
                          "cpu")
    with torch.inference_mode():
        got = prog.module()(x)
        assert torch.equal(got, fused_infer_apply(cfg, params, x))


def test_entry_points_refuse_missing_cuda(scan_dir, tmp_path, monkeypatch):
    """Without a card, every entry point raises unless the CPU is asked for."""
    from surfacenet_tpu_torch.cli import reconstruct_scan
    from surfacenet_tpu_torch.config import baseline_config
    from surfacenet_tpu_torch.data.dtu import load_scan
    from surfacenet_tpu_torch.device import resolve_device
    from surfacenet_tpu_torch.geometry.refine import refine_calibration
    from surfacenet_tpu_torch.pipeline.sweep import (
        photoconsistency_predictor, run_sweep,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scan = load_scan(scan_dir)
    cfg = baseline_config("dtu9_full")
    calls = [
        lambda: resolve_device(),
        lambda: run_sweep(scan.images, scan.Ps, scan.bbox_min, scan.bbox_max,
                          cfg, photoconsistency_predictor),
        lambda: reconstruct_scan(scan, cfg, photoconsistency_predictor,
                                 str(tmp_path / "x.ply")),
        lambda: refine_calibration(scan.images, scan.Ps, scan.bbox_min,
                                   scan.bbox_max),
        lambda: main(["reconstruct", "--scan", scan_dir, "--out",
                      str(tmp_path / "y.ply")]),
        lambda: main(["selftest"]),
        lambda: main(["eval", "--pred", "p.ply", "--gt", "g.ply"]),
        lambda: main(["reconstruct-all", "--scans", scan_dir, "--out-dir",
                      str(tmp_path / "all")]),
        lambda: main(["reconstruct", "--colmap", "--scan", scan_dir,
                      "--out", str(tmp_path / "c.ply")]),
        lambda: main(["export", "--checkpoint", "w.npz"]),
        # the native merge's caller, with the ledger and the denoise
        lambda: main(["reconstruct", "--scan", scan_dir, "--out",
                      str(tmp_path / "z.ply"), "--ledger",
                      str(tmp_path / "l.jsonl"), "--min-component", "5"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("mps")
