"""The port's CLI on the CPU, and its refusal to fall back to the CPU."""

import numpy as np
import pytest
import torch

from surfacenet_tpu_torch.cli import main
from surfacenet_tpu_torch.utils.ply import read_ply

torch.set_num_threads(2)

TINY = [
    "--set", "voxel.cube_size=16", "--set", "voxel.voxel_size_mm=2.0",
    "--set", "voxel.overlap=4", "--set", "fusion.n_view_pairs=2",
    "--set", "fusion.tau=0.25", "--set", "sweep.cube_batch=8",
    "--set", "fusion.ray_pool_mode=affine",  # the default "exact" waits
]


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
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("mps")
