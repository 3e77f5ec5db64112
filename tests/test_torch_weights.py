"""The shipped SurfaceNet weights and the registered conv op.

``weights_torch/golden_{sphere,tori}_fast64_30k.npz`` are conversions of
the reference's Orbax checkpoints ``weights/golden_*_fast64_30k``
(``models/convert.py``'s recipe).  Each is checked bitwise against a fresh
conversion, and its forward through ``load_surfacenet`` against the
reference's ``model.apply`` with the Orbax weights: float32, 2 items of
16^3, within 1e-4 absolute on the probabilities (the port's float32
forward bound, tests/test_torch_model.py).  The registered conv op
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
SCENES = ("sphere", "tori")


def shipped(scene):
    return os.path.join(ROOT, "weights_torch",
                        f"golden_{scene}_fast64_30k.npz")


@pytest.fixture(scope="module")
def reference():
    """scene -> (flax model, numpy variables) of the Orbax checkpoint,
    restored as ``models/convert.py`` says: an 8^3 float32 template."""
    from surfacenet_tpu.config import Config, ModelConfig
    from surfacenet_tpu.train.train_surface import load_pretrained

    cfg = Config(model=dataclasses.replace(ModelConfig.fast64(),
                                           dtype="float32"))
    cfg = cfg.replace(voxel=dataclasses.replace(cfg.voxel, cube_size=8))
    runs = {}

    def get(scene):
        if scene not in runs:
            model, variables = load_pretrained(os.path.join(
                ROOT, "weights", f"golden_{scene}_fast64_30k"), cfg)
            runs[scene] = (model, jax.tree_util.tree_map(np.asarray,
                                                         variables))
        return runs[scene]

    return get


@pytest.mark.parametrize("scene", SCENES)
def test_shipped_surfacenet_npz_is_a_fresh_conversion(reference, scene):
    _, variables = reference(scene)
    fresh = params_from_jax(variables)
    stored = load_npz(shipped(scene))
    assert sorted(fresh) == sorted(stored)
    for k in fresh:
        assert fresh[k].dtype == stored[k].dtype, k
        assert torch.equal(fresh[k], stored[k]), k
    assert sum(v.numel() for k, v in stored.items()
               if not k.endswith("num_batches_tracked")) == 4110337


@pytest.mark.parametrize("scene", SCENES)
def test_shipped_surfacenet_forward_matches_reference(reference, scene):
    model, variables = reference(scene)
    x = np.random.default_rng(4).normal(0, 0.2, (2, 16, 16, 16, 6)).astype(
        np.float32)
    ref = np.asarray(jax.jit(lambda v, x: model.apply(v, x, train=False))(
        variables, jnp.asarray(x)))
    cfg = dataclasses.replace(TModel.fast64(), dtype="float32")
    net = load_surfacenet(shipped(scene), cfg)
    got = make_predictor(net, cfg, "cpu")(torch.tensor(x)).numpy()
    assert got.shape == (2, 16, 16, 16)
    assert np.abs(got - ref).max() <= 1e-4
    assert 0.0 < ref.min() and ref.max() < 1.0


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
