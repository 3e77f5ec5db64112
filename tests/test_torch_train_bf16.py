"""The bf16 training step's backward, against a float64 one.

The reference trains in bf16 (``ModelConfig.dtype``) with float32
parameters.  Its forward rounds to bf16 where flax's bf16 layers do.  The
port's bf16 step keeps its activations in bf16 tensors, so its backward
rounds every cotangent to bf16 too; on the card, robustness_ft_r05's lr
1e-4 fine-tune trained so un-learns 1.30-1.36x the TPU record's clean
error on the record's own draws, and within 1.3% with a float32 backward
(``scripts/torch_bf16_variants.py``'s ``fp32_backward``: bf16 values in
float32 tensors; ROADMAP C13).

Here the tiny widths in bf16 (16^3 cubes, batch 2, seeded inputs) train
one step under the port as shipped and under ``fp32_backward``, each held
to the same network written out in float64: the weights, biases, each
conv's and each BatchNorm's output and the resized side outputs rounded
to bf16, every gradient exact.  Both forwards agree with it to the bf16
roundings (logits within 1e-2 absolute, the loss within 1e-4 relative).
``fp32_backward``'s gradients are within 1e-3 of the float64 ones (each
parameter's difference over its norm; ~1.3e-6 measured); the shipped
step's miss by more than 1e-3 (~5e-3: its bf16 cotangents), the gap the
variant closes.  ``fp32_backward`` keeps the same 1e-3 with learned
transposed-conv side outputs and with data-parallel BatchNorm, the
layers it would reach if the port shipped it.
"""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from surfacenet_tpu_torch.config import ModelConfig
from surfacenet_tpu_torch.models import surfacenet
from surfacenet_tpu_torch.models.surfacenet import BN_EPS, init_surfacenet
from surfacenet_tpu_torch.train.losses import class_balanced_bce

D, B = 16, 2
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "torch_bf16_variants", os.path.join(ROOT, "scripts",
                                        "torch_bf16_variants.py"))
variants = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(variants)


def _rounded(t):
    """float64 ``t`` rounded to bf16 values; the gradient passes
    through."""
    return t + (t.to(torch.bfloat16).double() - t).detach()


def _reference(model, x):
    """The train-mode forward of ``model`` in float64 with the bf16
    forward's roundings: logits (B, D, D, D)."""
    p = {k: v.detach().double().requires_grad_(True)
         for k, v in model.named_parameters()}

    def conv(name, mod, h):
        b = p.get(f"{name}.bias")
        w, b = _rounded(p[f"{name}.weight"]), None if b is None else \
            _rounded(b)
        if isinstance(mod, torch.nn.ConvTranspose3d):
            return _rounded(F.conv_transpose3d(
                h, w, b, mod.stride, mod.padding, mod.output_padding))
        return _rounded(F.conv3d(h, w, b, mod.stride, mod.padding,
                                 mod.dilation))

    def bn(name, h):
        mean = h.mean((0, 2, 3, 4), keepdim=True)
        var = ((h - mean) ** 2).mean((0, 2, 3, 4), keepdim=True)
        w = p[f"{name}.weight"].view(1, -1, 1, 1, 1)
        b = p[f"{name}.bias"].view(1, -1, 1, 1, 1)
        return _rounded((h - mean) / torch.sqrt(var + BN_EPS) * w + b)

    h = x.to(torch.bfloat16).double().permute(0, 4, 1, 2, 3)
    sides, scale = [], 1
    for i, (block, side, pool) in enumerate(zip(
            model.blocks, model.sides, model.cfg.pool_after_block)):
        for j, c in enumerate(block.convs):
            h = torch.relu(bn(f"blocks.{i}.bns.{j}",
                              conv(f"blocks.{i}.convs.{j}", c, h)))
        s = torch.relu(bn(f"sides.{i}.bn", conv(f"sides.{i}.conv",
                                                side.conv, h)))
        if scale > 1 and side.deconv is not None:
            s = conv(f"sides.{i}.deconv", side.deconv, s)
        elif scale > 1:
            s = _rounded(F.interpolate(s, scale_factor=scale,
                                       mode="trilinear",
                                       align_corners=False))
        sides.append(s)
        if pool:
            h = F.max_pool3d(h, 2, 2)
            scale *= 2
    return conv("head", model.head, torch.cat(sides, 1))[:, 0], p


def _gradient_errors(cfg, variant, bn_group=None):
    """One train-mode step of ``cfg``'s seeded net under ``variant``
    against ``_reference``, the forwards checked: each parameter's
    gradient difference over its norm."""
    model = init_surfacenet(cfg, torch.Generator().manual_seed(3)).train()
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.random((B, D, D, D, 6), np.float32))
    labels = torch.from_numpy(
        (rng.random((B, D, D, D)) < 0.05).astype(np.float32))
    valid = torch.ones(B, D, D, D, dtype=torch.bool)

    with variants.patched(variant):
        logits = model(x, return_logits=True, bn_group=bn_group)
        loss = class_balanced_bce(logits, labels, valid)
        loss.backward()

    ref_logits, p = _reference(model, x.double())
    ref_loss = class_balanced_bce(ref_logits, labels.double(), valid)
    ref_loss.backward()
    assert (logits.detach().double() - ref_logits.detach()).abs().max() \
        <= 1e-2
    assert abs(loss.item() - ref_loss.item()) <= 1e-4 * ref_loss.item()
    return {name: ((param.grad.double() - p[name].grad).norm()
                   / p[name].grad.norm()).item()
            for name, param in model.named_parameters()}


@pytest.mark.parametrize("variant", ["fp32_backward", "shipped"])
def test_bf16_training_backward(variant):
    cfg = dataclasses.replace(ModelConfig.tiny(), dtype="bfloat16")
    errs = _gradient_errors(cfg, variant)
    worst = max(errs, key=errs.get)
    if variant == "fp32_backward":
        assert errs[worst] <= 1e-3, (worst, errs[worst])
    else:
        assert errs[worst] > 1e-3, (worst, errs[worst])


@pytest.mark.parametrize("case", ["deconv", "bn_group"])
def test_fp32_backward_on_other_layers(case, monkeypatch):
    """``fp32_backward`` through the layers the default config does not
    reach, within the same 1e-3: learned transposed-conv side outputs,
    and data-parallel BatchNorm (``SyncBatchNormFn``, here over one rank,
    whose all-reduce is the identity)."""
    cfg = dataclasses.replace(ModelConfig.tiny(), dtype="bfloat16")
    group = None
    if case == "deconv":
        cfg = dataclasses.replace(cfg, upsample_mode="deconv")
    else:
        group = object()
        monkeypatch.setattr(surfacenet, "all_reduce_",
                            lambda t, group: t)
    errs = _gradient_errors(cfg, "fp32_backward", group)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-3, (worst, errs[worst])
