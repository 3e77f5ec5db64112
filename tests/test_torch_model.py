"""Port parity: SurfaceNet forward with weights carried over from flax.

float32 on both sides, tolerance 1e-4 absolute on the probabilities
(different convolution summation orders).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from surfacenet_tpu.config import ModelConfig as JModel
from surfacenet_tpu.models.surfacenet import SurfaceNet as JSurfaceNet
from surfacenet_tpu_torch.config import ModelConfig as TModel
from surfacenet_tpu_torch.models.convert import (
    load_npz, load_surfacenet, params_from_jax, save_npz,
)
from surfacenet_tpu_torch.models.surfacenet import (
    SurfaceNet, forward_flops, init_surfacenet, make_predictor,
)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _perturbed(variables, seed):
    """numpy copy with non-trivial BatchNorm statistics and biases."""
    rng = np.random.default_rng(seed)

    def walk(d):
        out = {}
        for k, v in d.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in ("mean", "bias"):
                out[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
            elif k in ("var", "scale"):
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out

    return walk(jax.tree_util.tree_map(np.asarray, variables))


@pytest.mark.parametrize("widths,mode", [
    ("tiny", "resize"), ("tiny", "deconv"), ("fast64", "resize"),
])
def test_surfacenet_forward_matches_flax(widths, mode):
    jc = dataclasses.replace(getattr(JModel, widths)(), dtype="float32",
                             upsample_mode=mode)
    tc = dataclasses.replace(getattr(TModel, widths)(), dtype="float32",
                             upsample_mode=mode)
    # parameters do not depend on D: a jitted init at D=8 costs seconds
    # on the CPU where flax's eager init costs tens of seconds
    model = JSurfaceNet(jc)
    variables = jax.jit(lambda k, x: model.init(k, x, train=False))(
        jax.random.PRNGKey(1), jnp.zeros((1, 8, 8, 8, 6)))
    variables = _perturbed(variables, 0)
    x = np.random.default_rng(1).normal(size=(2, 16, 16, 16, 6)).astype(
        np.float32)
    apply = jax.jit(lambda v, x: model.apply(v, x, train=False))
    ref = np.asarray(apply(variables, jnp.asarray(x)))
    net = SurfaceNet(tc)
    net.load_state_dict(params_from_jax(variables))
    with torch.no_grad():
        got = net.eval()(torch.tensor(x)).numpy()
    assert got.shape == (2, 16, 16, 16) and got.dtype == np.float32
    assert np.abs(got - ref).max() <= 1e-4


def test_golden_fast64_weights_load_and_match(tmp_path):
    """The shipped fast64 weights, read by the JAX package's own loader,
    converted, stored as .npz and reloaded, give the flax forward."""
    from surfacenet_tpu.config import baseline_config as j_baseline
    from surfacenet_tpu.train.train_surface import load_pretrained

    cfg = j_baseline("dtu9_full")
    cfg = cfg.replace(
        voxel=dataclasses.replace(cfg.voxel, cube_size=8),  # init shape
        model=dataclasses.replace(cfg.model, dtype="float32"),
    )
    model, variables = load_pretrained(
        os.path.join(ROOT, "weights", "golden_sphere_fast64_30k"), cfg
    )
    variables = jax.tree_util.tree_map(np.asarray, variables)
    x = np.random.default_rng(2).normal(0, 0.2, (1, 16, 16, 16, 6)).astype(
        np.float32)
    ref = np.asarray(jax.jit(lambda v, x: model.apply(v, x, train=False))(
        variables, jnp.asarray(x)))
    path = str(tmp_path / "fast64.npz")
    save_npz(params_from_jax(variables), path)
    tcfg = dataclasses.replace(TModel.fast64(), dtype="float32")
    net = load_surfacenet(path, tcfg)
    with torch.no_grad():
        got = net(torch.tensor(x)).numpy()
    assert np.abs(got - ref).max() <= 1e-4
    assert set(load_npz(path)) == set(net.state_dict())


@pytest.mark.parametrize("scale", [2, 4])
def test_trilinear_resize_matches_jax_image_resize(scale):
    x = np.random.default_rng(scale).normal(size=(2, 5, 6, 4, 3)).astype(
        np.float32)
    b, d1, d2, d3, c = x.shape
    ref = np.asarray(jax.image.resize(
        jnp.asarray(x), (b, d1 * scale, d2 * scale, d3 * scale, c),
        method="trilinear",
    ))
    got = F.interpolate(torch.tensor(x).permute(0, 4, 1, 2, 3),
                        scale_factor=scale, mode="trilinear",
                        align_corners=False).permute(0, 2, 3, 4, 1)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


def test_seeded_init_and_bf16_predictor():
    cfg = TModel.tiny()
    a = init_surfacenet(cfg, torch.Generator().manual_seed(3))
    b = init_surfacenet(cfg, torch.Generator().manual_seed(3))
    c = init_surfacenet(cfg, torch.Generator().manual_seed(4))
    for (k, va), vb, vc in zip(a.state_dict().items(),
                               b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(va, vb), k
    w = a.blocks[0].convs[0].weight
    assert not torch.equal(w, c.blocks[0].convs[0].weight)
    assert abs(w.std().item() * (6 * 27) ** 0.5 - 1.0) < 0.2  # LeCun std

    bf = dataclasses.replace(cfg, dtype="bfloat16")
    pred = make_predictor(init_surfacenet(bf, torch.Generator().manual_seed(3)),
                          bf, "cpu")
    assert pred.in_dtype == "bfloat16"
    x = torch.randn(1, 8, 8, 8, 6, generator=torch.Generator().manual_seed(0))
    p_bf = pred(x.to(torch.bfloat16), None)
    with torch.no_grad():
        p_32 = a(x)
    assert p_bf.dtype == torch.float32 and p_bf.shape == (1, 8, 8, 8)
    assert (p_bf - p_32).abs().max().item() < 0.05  # bf16 compute


@pytest.mark.parametrize("widths,mode", [
    ("tiny", "resize"), ("tiny", "deconv"), ("fast64", "resize"),
])
def test_forward_flops_matches_flop_counter(widths, mode):
    from torch.utils.flop_counter import FlopCounterMode

    cfg = dataclasses.replace(getattr(TModel, widths)(), dtype="float32",
                              upsample_mode=mode)
    net = SurfaceNet(cfg).eval()
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        net(torch.zeros(1, 16, 16, 16, 6))
    assert forward_flops(cfg, 16) == counter.get_total_flops()
