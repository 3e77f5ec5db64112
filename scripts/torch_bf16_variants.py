"""The bf16 training step changed in one place, to find which bf16 rounding
separates the port's bf16 training from its float32 training.

``replay``: ``scripts/torch_aug_replay.py`` trains on a record's own
draws (bf16 as the record, or ``--dtype float32``); this runs the same
replay (robustness_ft_r05's fine-tunes or robustness_aug_r04's training,
as the inputs say) with the model's bf16 step patched while it trains
(the package is not changed; the sweeps after training run the model as
shipped, bf16).

``grads``: one step's gradients, the first of ``chip_smoke.py`` phase 27
(the record's size and draws, from ``golden_sphere_30k``), under the
shipped step (twice), each variant and the float32 step, each tensor's
held to ``grad32``'s (the same forward, a float32 backward): the norm of
the difference over ``grad32``'s norm, and the ratio of the norms.

Variants:

  logits32  the head's 1^3 conv in float32 on the bf16 concatenation of
            the side outputs: the logits are not rounded to bf16 (flax's
            head returns bf16 logits, then float32);
  mxu       every conv takes its input and weights rounded to bf16 and
            computes and returns float32 (products of bf16 values are
            exact in float32; a TPU's matrix unit accumulates them so),
            BatchNorm normalises that float32 output, and the roundings
            pass gradients straight through in float32: bf16 operands,
            float32 everywhere else, logits too;
  grad32    ``mxu`` with each conv's and each BatchNorm's output rounded
            to bf16 too, the gradient passed straight through: the
            forward rounds as the bf16 step does, the backward is
            float32 (no bf16 cotangents or weight gradients);
  fp32_backward  the step that keeps bf16 values in float32 tensors,
            rounded where flax's bf16 layers round (each conv's output,
            each BatchNorm's, the resized side outputs): each conv's
            forward is the bf16 conv as shipped, its backward float32 on
            the same bf16 operands with TF32 allowed (``_Bf16ValuesConv``),
            BatchNorm's backward float32: the bf16 forward's values and a
            float32 backward but for the cotangents' rounding to TF32;
  wgrad32   the shipped bf16 step but for each conv's weight gradient,
            computed in float32 from its bf16 input and bf16 output
            gradient (TF32 allowed: bf16 values are exact in TF32, so the
            products are exact and the sums float32's) and kept float32
            (the shipped step's cuDNN writes it in bf16).

    python3 scripts/torch_bf16_variants.py replay INPUTS_DIR VARIANT \\
        [--arms arm_sigma1_lr1e-4_6k]
    python3 scripts/torch_bf16_variants.py grads [--device cpu]
    python3 scripts/torch_bf16_variants.py steps VARIANT [--steps 500]
    python3 scripts/torch_bf16_variants.py chip VARIANT --finetune-alone

``steps``: the record's training step alone (robustness_ft_r05's lr 1e-4
arm: 32^3, batch 16, the paper width from ``golden_sphere_30k``, its
config and the port's own draws at seed 7) under the shipped step and
VARIANT in turns (shipped, VARIANT, VARIANT, shipped), each run N steps
from the same start: ms a step from CUDA events around each chunk of 25
(the first chunk left out) and the peak memory allocated.

``replay`` prints ``torch_aug_replay``'s JSON line with ``"variant"``
added; ``grads`` one JSON line ``{"grads": ...}``; ``steps`` one JSON
line ``{"steps": ...}``; ``chip`` runs
``chip_smoke.py``'s ``--*-alone`` phase (its arguments after the
variant) with the variant's patches while each net trains.
"""

import argparse
import contextlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import torch
import torch.nn as nn
import torch.nn.functional as F

from surfacenet_tpu_torch.models import surfacenet as model_mod

BF16 = torch.bfloat16


def rounded(t):
    """``t``'s values rounded to bf16, in float32, with the gradient
    passed straight through."""
    return t + (t.to(BF16).float() - t).detach()


def mxu_conv(conv, x, dt):
    """``_conv`` with bf16 operands and a float32 result."""
    if dt != BF16:
        return REAL_CONV(conv, x, dt)
    x = rounded(x.float()) if x.dtype != BF16 else x.float()
    w = rounded(conv.weight)
    if isinstance(conv, nn.ConvTranspose3d):
        return F.conv_transpose3d(x, w, conv.bias, conv.stride, conv.padding,
                                  conv.output_padding, conv.groups,
                                  conv.dilation)
    return F.conv3d(x, w, conv.bias, conv.stride, conv.padding,
                    conv.dilation, conv.groups)


def head_fp32_forward(self, x, return_logits=False, bn_group=None):
    """``SurfaceNet.forward`` with the head conv in float32."""
    dt = model_mod.DTYPES[self.cfg.dtype]
    h = x.to(dt).permute(0, 4, 1, 2, 3)
    sides = []
    for block, side, do_pool in zip(self.blocks, self.sides,
                                    self.cfg.pool_after_block):
        h = block(h, dt, bn_group)
        sides.append(side(h, dt, bn_group))
        if do_pool:
            h = F.max_pool3d(h, 2, 2)
    logits = REAL_CONV(self.head, torch.cat(sides, dim=1).float(),
                       torch.float32)[:, 0]
    return logits if return_logits else torch.sigmoid(logits)


def grad32_conv(conv, x, dt):
    """``mxu_conv`` with its output rounded to bf16."""
    out = mxu_conv(conv, x, dt)
    return rounded(out) if dt == BF16 else out


def grad32_batchnorm(bn, x, group=None):
    """``_batchnorm`` with its float32 output rounded to bf16."""
    out = REAL_BATCHNORM(bn, x, group)
    return rounded(out) if out.dtype == torch.float32 else out


class _Wgrad32(torch.autograd.Function):
    """A bf16 conv whose weight gradient is computed in float32."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding, dilation, groups):
        w = weight.to(BF16)
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, dilation, groups, bias is not None)
        return F.conv3d(x, w, None if bias is None else bias.to(BF16),
                        stride, padding, dilation, groups)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        stride, padding, dilation, groups, has_bias = ctx.conf
        back = torch.ops.aten.convolution_backward
        gx = back(gy, x, w, None, stride, padding, dilation, False,
                  [0, 0, 0], groups, [True, False, False])[0]
        cudnn = torch.backends.cudnn
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=True):
            gw = back(gy.float(), x.float(), w.float(), None, stride,
                      padding, dilation, False, [0, 0, 0], groups,
                      [False, True, False])[1]
        gb = gy.float().sum((0, 2, 3, 4)) if has_bias else None
        return gx, gw, gb, None, None, None, None


def wgrad32_conv(conv, x, dt):
    """``_conv`` with ``_Wgrad32``'s weight gradient."""
    if dt != BF16 or isinstance(conv, nn.ConvTranspose3d):
        return REAL_CONV(conv, x, dt)
    return _Wgrad32.apply(x, conv.weight, conv.bias, conv.stride,
                          conv.padding, conv.dilation, conv.groups)


# fp32_backward: activations of a bf16 training step as bf16 values in
# float32 tensors (the dtype its convs and BatchNorms are given)
BF16_VALUES = object()


class _RoundBF16(torch.autograd.Function):
    """A float32 tensor's values rounded to bf16, still float32; the
    gradient passes through unrounded."""

    @staticmethod
    def forward(ctx, t):
        return t.to(BF16).float()

    @staticmethod
    def backward(ctx, g):
        return g


@contextlib.contextmanager
def _tf32():
    """TF32 allowed in cuDNN within the block: exact for bf16 operands
    (8-bit significands fit TF32's 11), so a conv of bf16 values sums
    exact products in float32; a float32 cotangent loses its last 13
    bits."""
    cudnn = torch.backends.cudnn
    prev = cudnn.allow_tf32
    cudnn.allow_tf32 = True
    try:
        yield
    finally:
        cudnn.allow_tf32 = prev


class _Bf16ValuesConv(torch.autograd.Function):
    """``conv`` (its geometry; ``weight`` and ``bias`` given, float32) on
    a float32 tensor of bf16 values: the forward is the bf16 conv (bf16
    operands, float32 sums, rounded to bf16 once), its result float32;
    the backward is float32 on the same bf16 operands with TF32
    allowed."""

    @staticmethod
    def forward(ctx, x, weight, bias, conv):
        transposed = isinstance(conv, nn.ConvTranspose3d)
        geom = (conv.stride, conv.padding, conv.dilation, transposed,
                conv.output_padding if transposed else (0, 0, 0),
                conv.groups)
        xb, wb = x.to(BF16), weight.to(BF16)
        ctx.save_for_backward(xb, wb)
        ctx.geom, ctx.has_bias = geom, bias is not None
        return torch.ops.aten.convolution(
            xb, wb, None if bias is None else bias.to(BF16), *geom).float()

    @staticmethod
    def backward(ctx, gy):
        xb, wb = ctx.saved_tensors
        bias_sizes = [gy.shape[1]] if ctx.has_bias else None
        with _tf32():
            gx, gw, gb = torch.ops.aten.convolution_backward(
                gy, xb.float(), wb.float(), bias_sizes, *ctx.geom,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                 ctx.has_bias])
        return gx, gw, gb, None


def fp32_backward_conv(conv, x, dt):
    """``_conv``, through ``_Bf16ValuesConv`` at ``BF16_VALUES``."""
    if dt is BF16_VALUES:
        return _Bf16ValuesConv.apply(x, conv.weight, conv.bias, conv)
    return REAL_CONV(conv, x, dt)


def _bn(bn, x, dt, group=None):
    """``_batchnorm``, its output rounded to bf16 values at
    ``BF16_VALUES``."""
    y = REAL_BATCHNORM(bn, x, group)
    return _RoundBF16.apply(y) if dt is BF16_VALUES and y is not x else y


def fp32_backward_block(self, x, dt, bn_group=None):
    """``ConvBlock.forward`` with ``_bn``."""
    for conv, bn in zip(self.convs, self.bns):
        x = F.relu(_bn(bn, model_mod._conv(conv, x, dt), dt, bn_group),
                   inplace=True)
    return x


def fp32_backward_side(self, x, dt, bn_group=None):
    """``SideLayer.forward`` with ``_bn`` and the resized output rounded
    at ``BF16_VALUES``."""
    x = F.relu(_bn(self.bn, model_mod._conv(self.conv, x, dt), dt,
                   bn_group), inplace=True)
    if self.upsample > 1:
        if self.deconv is not None:
            x = model_mod._conv(self.deconv, x, dt)
        else:
            x = F.interpolate(x, scale_factor=self.upsample,
                              mode="trilinear", align_corners=False)
            if dt is BF16_VALUES:
                x = _RoundBF16.apply(x)
    return x


def fp32_backward_forward(self, x, return_logits=False, bn_group=None):
    """``SurfaceNet.forward`` on ``BF16_VALUES`` in bf16 training."""
    dt = model_mod.DTYPES[self.cfg.dtype]
    h = x.to(dt).permute(0, 4, 1, 2, 3)
    if dt == BF16 and self.training and torch.is_grad_enabled():
        h, dt = h.float(), BF16_VALUES
    sides = []
    for block, side, do_pool in zip(self.blocks, self.sides,
                                    self.cfg.pool_after_block):
        h = block(h, dt, bn_group)
        sides.append(side(h, dt, bn_group))
        if do_pool:
            h = F.max_pool3d(h, 2, 2)
    logits = model_mod._conv(self.head, torch.cat(sides, dim=1),
                             dt)[:, 0].float()
    return logits if return_logits else torch.sigmoid(logits)


REAL_CONV = model_mod._conv
REAL_BATCHNORM = model_mod._batchnorm
# variant -> [(object, attribute, replacement)], patched while training runs
VARIANTS = {
    "logits32": [(model_mod.SurfaceNet, "forward", head_fp32_forward)],
    "mxu": [(model_mod, "_conv", mxu_conv)],
    "grad32": [(model_mod, "_conv", grad32_conv),
               (model_mod, "_batchnorm", grad32_batchnorm)],
    "wgrad32": [(model_mod, "_conv", wgrad32_conv)],
    "fp32_backward": [(model_mod, "_conv", fp32_backward_conv),
                      (model_mod.ConvBlock, "forward", fp32_backward_block),
                      (model_mod.SideLayer, "forward", fp32_backward_side),
                      (model_mod.SurfaceNet, "forward",
                       fp32_backward_forward)],
}


@contextlib.contextmanager
def patched(variant):
    """``variant``'s patches in place within the block (none for a name
    not in ``VARIANTS``)."""
    patches = VARIANTS.get(variant, [])
    real = [getattr(obj, name) for obj, name, _ in patches]
    for obj, name, fn in patches:
        setattr(obj, name, fn)
    try:
        yield
    finally:
        for (obj, name, _), fn in zip(patches, real):
            setattr(obj, name, fn)


def first_step_grads(dev, variant):
    """Phase 27's first step under ``variant`` (a key of ``VARIANTS``,
    "shipped", or "float32"): {name: float64 gradient on the host}, taken
    where the optimizer would step (it does not)."""
    import numpy as np

    import chip_smoke
    from surfacenet_tpu_torch.train import train_surface

    cfg = chip_smoke.train_parity_config(
        "float32" if variant == "float32" else "bfloat16")
    draws = dict(np.load(os.path.join(chip_smoke.RESULTS,
                                      "train_parity_draws.npz")))
    make, kw = chip_smoke.OCC_SCENES["clean"]
    scene = make(**kw)
    state = train_surface.state_from_weights(
        cfg, chip_smoke.TRAINED_PAPER.format(scene="sphere"), dev)
    sampler = train_surface.make_device_sampler(scene, cfg,
                                                seed=cfg.train.seed,
                                                device=dev)
    sampler = (torch.as_tensor(draws["cand_pts"], device=dev),
               torch.as_tensor(draws["cand_pairs"], device=dev),
               *sampler[2:])
    grads = {}

    def capture():
        for name, p in state.model.named_parameters():
            grads[name] = p.grad.detach().double().cpu()

    state.optimizer.step = capture
    tc = cfg.train
    with patched(variant), chip_smoke.fed(draws, dev, True):
        train_surface.train_steps_scan(
            state, train_surface.gather_copy(scene.images, cfg, dev),
            torch.as_tensor(scene.Ps, dtype=torch.float32, device=dev),
            sampler, torch.Generator(device=dev), K=1, batch=tc.batch_size,
            D=cfg.voxel.cube_size, s=cfg.voxel.voxel_size_mm,
            balanced=tc.class_balance, center_colors=cfg.voxel.center_colors,
            aug_sigma_px=tc.aug_calib_sigma_px,
            aug_anneal_steps=tc.aug_calib_anneal_steps)
    return grads


def grads_main(device):
    """``grads``: each run's first-step gradients against grad32's."""
    import chip_smoke
    from surfacenet_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        from surfacenet_tpu_torch.ops.cuda import _build

        chip_smoke.log(chip_smoke.card_line())
        chip_smoke.log(f"kernels built in {_build.build_all():.2f} s")
    runs = ("shipped", "shipped_again", "wgrad32", "mxu", "logits32",
            "float32")
    ref = first_step_grads(dev, "grad32")
    out = {}
    for label in runs:
        g = first_step_grads(dev, label.replace("_again", ""))
        rows = {name: {"diff": float((g[name] - r).norm() / r.norm()),
                       "norm_ratio": float(g[name].norm() / r.norm())}
                for name, r in ref.items() if r.norm() > 0}
        worst = sorted(rows, key=lambda n: -rows[n]["diff"])[:5]
        out[label] = {"max_diff": rows[worst[0]]["diff"],
                      "worst": {n: rows[n] for n in worst},
                      "tensors": rows}
        chip_smoke.log(f"grads {label}: the largest differences from "
                       f"grad32's {json.dumps(out[label]['worst'])}")
    print(json.dumps({"grads": {"device": str(dev), "against": "grad32",
                                "runs": out}}), flush=True)
    return 0


def step_times(variant, n_steps):
    """``steps``: {run: chunk_clock's readings and the peak memory} for
    the shipped step and ``variant`` in turns, ``n_steps`` steps each."""
    import chip_smoke
    from surfacenet_tpu_torch import cli
    from surfacenet_tpu_torch.config import Config
    from surfacenet_tpu_torch.ops.cuda import _build
    from surfacenet_tpu_torch.train import train_surface

    dev = torch.device("cuda", 0)
    chip_smoke.log(chip_smoke.card_line())
    chip_smoke.log(f"kernels built in {_build.build_all():.2f} s")
    lr, _, sigma = chip_smoke.FT_ARMS[chip_smoke.TRAIN_PARITY_ARM]
    cfg = cli._apply_overrides(Config(), [
        *chip_smoke.OCC_SETS, *chip_smoke.FT_TRAIN_SETS,
        f"train.seed={chip_smoke.FT_SEED}", f"train.lr={lr}",
        f"train.n_steps={n_steps}", f"train.aug_calib_sigma_px={sigma}",
        f"train.aug_calib_anneal_steps={n_steps}"])
    make, kw = chip_smoke.OCC_SCENES["clean"]
    scene = make(**kw)
    runs = {}
    for i, label in enumerate(("shipped", variant, variant, "shipped")):
        state = train_surface.state_from_weights(
            cfg, chip_smoke.TRAINED_PAPER.format(scene="sphere"), dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with patched(label), chip_smoke.chunk_clock() as clock:
            train_surface.train_surfacenet(scene, cfg, state=state,
                                           log_every=n_steps, device=dev)
        torch.cuda.synchronize()
        run = dict(clock.readings(), variant=label,
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        del run["chunk_ms"]
        runs[f"{i}_{label}"] = run
        chip_smoke.log(f"steps {label}: {json.dumps(run)}")
        del state
        torch.cuda.empty_cache()
    return runs


def patched_training(variant):
    """``train_surface.train_surfacenet`` with ``variant``'s patches in
    place while it runs (the sweeps after it run the model as shipped)."""
    from surfacenet_tpu_torch.train import train_surface

    real_train = train_surface.train_surfacenet

    def train(*a, **kw):
        with patched(variant):
            return real_train(*a, **kw)

    train_surface.train_surfacenet = train


def replay_main(args):
    """``replay``: ``torch_aug_replay.main`` with ``args.variant``'s
    patches while each arm trains."""
    import chip_smoke
    import torch_aug_replay

    patched_training(args.variant)
    real_print = print

    def tagged(*a, **kw):  # the replay's JSON line, with the variant
        if a and isinstance(a[0], str) and a[0].startswith(
                '{"training_replay"'):
            line = json.loads(a[0])
            line["variant"] = args.variant
            a = (json.dumps(line),) + a[1:]
        real_print(*a, **kw)

    torch_aug_replay.print = tagged
    chip_smoke.log(f"bf16 variant {args.variant}")
    return torch_aug_replay.main(args.inputs, arms=args.arms)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="mode", required=True)
    rp = sub.add_parser("replay")
    rp.add_argument("inputs")
    rp.add_argument("variant", choices=sorted(VARIANTS))
    rp.add_argument("--arms", default=None, type=lambda a: a.split(","))
    gp = sub.add_parser("grads")
    gp.add_argument("--device", default="cuda")
    sp = sub.add_parser("steps")
    sp.add_argument("variant", choices=sorted(VARIANTS))
    sp.add_argument("--steps", type=int, default=500)
    cp = sub.add_parser("chip")
    cp.add_argument("variant", choices=sorted(VARIANTS))
    cp.add_argument("alone", nargs=argparse.REMAINDER)
    args = ap.parse_args()
    if args.mode == "grads":
        return grads_main(args.device)
    if args.mode == "steps":
        print(json.dumps({"steps": {
            "card": torch.cuda.get_device_name(0), "steps": args.steps,
            "runs": step_times(args.variant, args.steps)}}), flush=True)
        return 0
    if args.mode == "chip":
        import chip_smoke

        patched_training(args.variant)
        chip_smoke.log(f"bf16 variant {args.variant}")
        sys.argv = ["chip_smoke.py", *args.alone]
        return chip_smoke.main()
    return replay_main(args)


if __name__ == "__main__":
    sys.exit(main())
