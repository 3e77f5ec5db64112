"""The shipped SurfaceNet weights and the registered conv op.

``weights_torch/golden_{sphere,tori}_fast64_30k.npz`` (fast64 widths),
``weights_torch/golden_{sphere,tori}_30k.npz`` and the eval split's shared
``weights_torch/golden_multi_30k.npz`` (the paper's widths) are
conversions of the reference's Orbax checkpoints ``weights/golden_*_30k``
(``models/convert.py``'s recipe).  Each is checked bitwise against a fresh
conversion, and its forward through ``load_surfacenet`` against the
reference's ``model.apply`` with the Orbax weights: float32, 2 items of
16^3, within 1e-4 absolute on the probabilities (the port's float32
forward bound, tests/test_torch_model.py); the paper-width bf16 predictor
is held to the reference's bf16 forward above tau.  The registered conv op
(``torch.ops.surfacenet_tpu_torch.conv3d``) passes ``torch.library.opcheck``
on CPU tensors.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surfacenet_tpu_torch.config import ModelConfig as TModel
from surfacenet_tpu_torch.models.convert import (
    load_npz, load_surfacenet, params_from_jax,
)
from surfacenet_tpu_torch.models.surfacenet import make_predictor
from surfacenet_tpu_torch.ops.conv3d import conv3d_plain
from surfacenet_tpu_torch.ops.cuda.conv3d import conv3d_op

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# case id -> (checkpoint name under weights/ and weights_torch/, float32
# values in it, widths): "fast64" is the dtu9_full preset's widths,
# "paper" the paper's (ModelConfig()); golden_multi_30k is the one net
# the eval split shares over its scenes
CHECKPOINTS = {
    "sphere": ("golden_sphere_fast64_30k", 4110337, "fast64"),
    "tori": ("golden_tori_fast64_30k", 4110337, "fast64"),
    "paper-sphere": ("golden_sphere_30k", 8375537, "paper"),
    "paper-tori": ("golden_tori_30k", 8375537, "paper"),
    "multi": ("golden_multi_30k", 8375537, "paper"),
}
CASES = pytest.mark.parametrize("case", list(CHECKPOINTS))


def shipped(case):
    return os.path.join(ROOT, "weights_torch", CHECKPOINTS[case][0] + ".npz")


def widths(config_cls, case):
    return (config_cls.fast64() if CHECKPOINTS[case][2] == "fast64"
            else config_cls())


@pytest.fixture(scope="module")
def reference():
    """case -> (flax model, numpy variables) of the Orbax checkpoint,
    restored as ``models/convert.py`` says: an 8^3 float32 template."""
    from surfacenet_tpu.config import Config, ModelConfig
    from surfacenet_tpu.train.train_surface import load_pretrained

    runs = {}

    def get(case):
        if case not in runs:
            cfg = Config(model=dataclasses.replace(widths(ModelConfig, case),
                                                   dtype="float32"))
            cfg = cfg.replace(voxel=dataclasses.replace(cfg.voxel,
                                                        cube_size=8))
            flax_model, variables = load_pretrained(os.path.join(
                ROOT, "weights", CHECKPOINTS[case][0]), cfg)
            runs[case] = (flax_model, jax.tree_util.tree_map(np.asarray,
                                                             variables))
        return runs[case]

    return get


@CASES
def test_shipped_surfacenet_npz_is_a_fresh_conversion(reference, case):
    _, variables = reference(case)
    fresh = params_from_jax(variables)
    stored = load_npz(shipped(case))
    assert sorted(fresh) == sorted(stored)
    for k in fresh:
        assert fresh[k].dtype == stored[k].dtype, k
        assert torch.equal(fresh[k], stored[k]), k
    n_values = sum(v.numel() for k, v in stored.items()
                   if not k.endswith("num_batches_tracked"))
    assert n_values == CHECKPOINTS[case][1]


@CASES
def test_shipped_surfacenet_forward_matches_reference(reference, case):
    flax_model, variables = reference(case)
    x = np.random.default_rng(4).normal(0, 0.2, (2, 16, 16, 16, 6)).astype(
        np.float32)
    ref = np.asarray(jax.jit(
        lambda v, x: flax_model.apply(v, x, train=False))(
            variables, jnp.asarray(x)))
    cfg = dataclasses.replace(widths(TModel, case), dtype="float32")
    net = load_surfacenet(shipped(case), cfg)
    got = make_predictor(net, cfg, "cpu")(torch.tensor(x)).numpy()
    assert got.shape == (2, 16, 16, 16)
    assert np.abs(got - ref).max() <= 1e-4
    assert 0.0 < ref.min() and ref.max() < 1.0


class Captured(Exception):
    """Ends a sweep at its first batch (raised by ``capture_first_batch``)."""


def test_paper_bf16_forward_matches_reference_bf16(reference, tmp_path,
                                                   monkeypatch):
    """The shipped paper-width weights in bf16: the port's predictor (bf16
    convs, float32 BatchNorm) against the reference's bf16 ``model.apply``
    on the op-point sphere's cube 5 (items 25 and 27 of the first batch,
    its pairs 0 and 2: 12 views of 600x800, focal 200, as
    ``scripts/op_point_qualify.py`` renders it; ``cli reconstruct
    --preset dtu9_paper`` on the CPU, stopped at its first batch of 6
    cubes).  The voxels above tau 0.7 agree on >= 0.99 of their union
    (0.9932: the two round at other places; with BatchNorm's statistics
    rounded to bf16, 0.987)."""
    from surfacenet_tpu_torch import cli
    from surfacenet_tpu_torch.data.dtu import write_scan
    from surfacenet_tpu_torch.data.synthetic import make_sphere_scene
    from surfacenet_tpu_torch.models import surfacenet as model_mod

    sc = make_sphere_scene(n_views=12, hw=(600, 800), radius=30.0,
                           focal=200.0)
    write_scan(str(tmp_path / "scan"), sc.images, sc.Ps, sc.bbox_min,
               sc.bbox_max)
    batch = {}

    def capture_first_batch(*args, **kw):
        def keep(x, origins=None):
            batch["x"] = x[[25, 27]].float().numpy()
            raise Captured

        keep.in_dtype = "bfloat16"
        return keep

    monkeypatch.setattr(model_mod, "make_predictor", capture_first_batch)
    with pytest.raises(Captured):
        cli.main(["reconstruct", "--scan", str(tmp_path / "scan"),
                  "--preset", "dtu9_paper", "--checkpoint",
                  shipped("paper-sphere"), "--out",
                  str(tmp_path / "x.ply"), "--device", "cpu",
                  "--set", "sweep.refine_calib=false",
                  "--set", "sweep.cube_batch=6"])
    monkeypatch.undo()
    x = batch["x"]
    flax_model, variables = reference("paper-sphere")
    bf16_model = type(flax_model)(dataclasses.replace(flax_model.cfg,
                                                      dtype="bfloat16"))
    ref = np.asarray(jax.jit(
        lambda v, x: bf16_model.apply(v, x, train=False))(
            variables, jnp.asarray(x, jnp.bfloat16))).astype(np.float32)
    net = load_surfacenet(shipped("paper-sphere"), TModel())
    got = make_predictor(net, TModel(), "cpu")(
        torch.tensor(x).to(torch.bfloat16)).float().numpy()
    a, b = got > 0.7, ref > 0.7
    agreement = (a & b).sum() / (a | b).sum()
    print(f"paper bf16 forward: {a.sum()} / {b.sum()} voxels above tau, "
          f"agreement {agreement:.6f}, max |diff| "
          f"{np.abs(got - ref).max():.4f}")
    assert b.sum() > 10000
    assert agreement >= 0.99


@pytest.mark.parametrize("cin,dil,relu", [(6, 1, True), (8, 2, False)])
def test_registered_conv_op_passes_opcheck_on_cpu(cin, dil, relu):
    """The op's schema, fake (meta) implementation, and its dispatch under
    ``torch.compile``'s tracing, on CPU tensors, where it is the plain
    version."""
    g = torch.Generator().manual_seed(cin)
    x = torch.randn((2, 5, 5, 5, cin), generator=g).to(torch.bfloat16)
    w = (torch.randn((27 * cin, 8), generator=g) * 0.2).to(torch.bfloat16)
    b = torch.randn((8,), generator=g)
    torch.library.opcheck(conv3d_op, (x, w, b, dil, relu))
    out = torch.ops.surfacenet_tpu_torch.conv3d(x, w, b, dil, relu)
    assert torch.equal(out, conv3d_plain(x, w, b, dil, relu))
