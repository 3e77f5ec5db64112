"""SurfaceNet 3D CNN: per-voxel surface-probability regressor.

Port of ``surfacenet_tpu/models/surfacenet.py``.  A fully-convolutional
network over a CVC pair (B, D, D, D, 6), channels last:

    per block: n x (conv3d 3^3 [dilated] -> BatchNorm -> relu)
               side layer: 1^3 conv -> BN -> relu -> upsample to D^3
               2^3 max-pool after the blocks that pool
    concat sides -> 1^3 conv -> sigmoid -> (B, D, D, D) probability

By default the reference runs this network as one XLA program, not a
Pallas kernel, so ``SurfaceNet`` runs it on PyTorch's convolutions (cuDNN
on the card), in the config's compute dtype, with activations in
``channels_last_3d`` layout: the (B, D, D, D, C) input is that layout
already, so no copy is made.  Training (``train/train_surface.py``) runs
the same module in ``train()`` mode on float32 master weights.

With ``ModelConfig.fused_inference`` the predictor runs
``fused_infer_apply`` instead, the reference's inference forward with
BatchNorm folded into each conv (``fold_bn``) and every 3^3 conv + bias +
ReLU through the implicit-GEMM conv kernel (``ops/cuda/conv3d.py``).

Data-parallel training passes its process group as ``bn_group``: the
training-mode BatchNorm then normalises by the statistics of the global
batch, as flax's do under a sharded ``jit`` (``SyncBatchNormFn``).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from surfacenet_tpu_torch.config import ModelConfig
from surfacenet_tpu_torch.parallel.distributed import all_reduce_
from surfacenet_tpu_torch.ops.conv3d import pack_conv_weight
from surfacenet_tpu_torch.ops.cuda.conv3d import CHANNEL_MULTIPLE, conv3d

# flax.linen.BatchNorm's default epsilon, which the reference uses
BN_EPS = 1e-5
# the weight of a batch in the running statistics: flax's momentum 0.99
BN_MOMENTUM = 0.01

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _conv(conv, x, dt):
    """``conv`` in the compute dtype ``dt``: its weights are cast where
    they are used (no copy when they are ``dt`` already), as flax's
    ``param_dtype=float32, dtype=dt`` layers do."""
    b = None if conv.bias is None else conv.bias.to(dt)
    if isinstance(conv, nn.ConvTranspose3d):
        return F.conv_transpose3d(x, conv.weight.to(dt), b, conv.stride,
                                  conv.padding, conv.output_padding,
                                  conv.groups, conv.dilation)
    return F.conv3d(x, conv.weight.to(dt), b, conv.stride, conv.padding,
                    conv.dilation, conv.groups)


_BN_DIMS = (0, 2, 3, 4)  # every axis of (B, C, D, D, D) but the channel


class SyncBatchNormFn(torch.autograd.Function):
    """Training-mode BatchNorm over the batch of every rank of ``group``.

    Forward: per-channel sums and sums of squares of this rank's float32
    input and its voxel count, all-reduced in one float64 tensor; mean =
    S1 / n and the biased variance S2 / n - mean^2 (flax's ``mean(x^2) -
    mean(x)^2``, clamped at 0); output ``xhat * weight + bias`` in the
    input's dtype.  Backward: ``sum(dy)`` and ``sum(dy * xhat)``
    all-reduced, dx = weight invstd (dy - sum(dy) / n - xhat sum(dy xhat)
    / n); the weight and bias gradients are this rank's sums, for the
    trainer's gradient all-reduce to add up.  Returns (y, mean, var),
    the statistics float32 and without gradient.
    """

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        C = x.shape[1]
        xf = x.float()
        n_local = torch.tensor([xf.numel() // C], dtype=torch.float64,
                               device=x.device)
        sums = torch.cat([xf.sum(_BN_DIMS).double(),
                          (xf * xf).sum(_BN_DIMS).double(), n_local])
        all_reduce_(sums, group)
        n = sums[2 * C:]
        mean = sums[:C] / n
        var = torch.clamp(sums[C:2 * C] / n - mean * mean, min=0.0)
        mean, var = mean.float(), var.float()
        invstd = torch.rsqrt(var + eps)
        view = (1, C, 1, 1, 1)
        y = ((xf - mean.view(view)) * (invstd * weight).view(view)
             + bias.view(view))
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.n, ctx.group = float(n), group
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, invstd = ctx.saved_tensors
        C = x.shape[1]
        view = (1, C, 1, 1, 1)
        xhat = (x.float() - mean.view(view)) * invstd.view(view)
        dyf = dy.float()
        local = torch.cat([dyf.sum(_BN_DIMS), (dyf * xhat).sum(_BN_DIMS)])
        tot = all_reduce_(local.clone(), ctx.group) / ctx.n
        dx = (weight * invstd).view(view) * (
            dyf - tot[:C].view(view) - xhat * tot[C:].view(view))
        return dx.to(x.dtype), local[C:], local[:C], None, None


def _batchnorm(bn, x, group=None):
    """BatchNorm as flax's ``nn.BatchNorm`` computes it.

    In eval mode: the running statistics (``bn`` itself).  In training
    mode: normalisation by the batch's statistics in float32 with the
    float32 scale and shift, output in ``x``'s dtype, and the running
    statistics updated as flax does, ``r = (1 - m) r + m batch`` with
    ``m = bn.momentum`` (0.01, flax's momentum 0.99) and the *biased*
    batch variance (``nn.BatchNorm3d``'s own update takes the unbiased
    one).  The batch statistics are the ones the normalisation computed,
    in float32: its mean and ``1 / sqrt(var + eps)``.  With a process
    ``group`` the batch is every rank's (``SyncBatchNormFn``), and every
    rank's running statistics take the same global values.
    """
    if isinstance(bn, nn.Identity) or not bn.training:
        return bn(x)
    if group is not None:
        y, mean, var = SyncBatchNormFn.apply(x, bn.weight, bn.bias, bn.eps,
                                             group)
    else:
        y, mean, invstd = torch.native_batch_norm(x, bn.weight, bn.bias,
                                                  None, None, True, 0.0,
                                                  bn.eps)
        var = invstd.detach().pow(-2) - bn.eps
    with torch.no_grad():
        for run, batch in ((bn.running_mean, mean), (bn.running_var, var)):
            run.mul_(1.0 - bn.momentum).add_(batch, alpha=bn.momentum)
    return y


def _bn_layer(features: int, use_bn: bool):
    return (nn.BatchNorm3d(features, eps=BN_EPS, momentum=BN_MOMENTUM)
            if use_bn else nn.Identity())


class ConvBlock(nn.Module):
    """n x (conv3d 3^3 -> [BN] -> relu), optionally dilated."""

    def __init__(self, in_ch: int, features: int, n_convs: int,
                 dilation: int = 1, use_bn: bool = True):
        super().__init__()
        self.convs = nn.ModuleList()
        self.bns = nn.ModuleList()
        for i in range(n_convs):
            self.convs.append(nn.Conv3d(
                in_ch if i == 0 else features, features, 3,
                padding=dilation, dilation=dilation, bias=not use_bn,
            ))
            self.bns.append(_bn_layer(features, use_bn))

    def forward(self, x, dt, bn_group=None):
        for conv, bn in zip(self.convs, self.bns):
            x = F.relu(_batchnorm(bn, _conv(conv, x, dt), bn_group),
                       inplace=True)
        return x


class SideLayer(nn.Module):
    """HED-style side output: 1^3 conv -> [BN] -> relu -> upsample.

    ``upsample_mode`` "resize" is trilinear with half-pixel centres (the
    reference's ``jax.image.resize``), "deconv" a learned transposed conv
    with kernel 2u and stride u, SAME-padded like flax's ``ConvTranspose``.
    """

    def __init__(self, in_ch: int, features: int, upsample: int,
                 use_bn: bool = True, upsample_mode: str = "resize"):
        super().__init__()
        self.upsample = upsample
        self.conv = nn.Conv3d(in_ch, features, 1, bias=not use_bn)
        self.bn = _bn_layer(features, use_bn)
        self.deconv = None
        if upsample > 1 and upsample_mode == "deconv":
            self.deconv = nn.ConvTranspose3d(
                features, features, 2 * upsample, stride=upsample,
                padding=upsample // 2,
            )
        elif upsample_mode not in ("resize", "deconv"):
            raise ValueError(f"unknown upsample_mode {upsample_mode!r}")

    def forward(self, x, dt, bn_group=None):
        x = F.relu(_batchnorm(self.bn, _conv(self.conv, x, dt), bn_group),
                   inplace=True)
        if self.upsample > 1:
            if self.deconv is not None:
                x = _conv(self.deconv, x, dt)
            else:
                x = F.interpolate(x, scale_factor=self.upsample,
                                  mode="trilinear", align_corners=False)
        return x


class SurfaceNet(nn.Module):
    """(B, D, D, D, in_channels) CVC pair -> (B, D, D, D) float32 probability.

    Computes in ``cfg.dtype``: parameters of another dtype are cast where
    they are used, so float32 master weights train as the reference's
    (``param_dtype=float32``), and ``make_predictor``'s copy, its convs
    cast to ``cfg.dtype`` once (BatchNorm stays float32, as flax's), runs
    without casts.  ``train()`` mode normalises
    by batch statistics and updates the running ones (``_batchnorm``;
    over every rank of ``bn_group`` when the forward is given one).
    The output is always float32.
    """

    def __init__(self, cfg: ModelConfig = ModelConfig()):
        super().__init__()
        self.cfg = cfg
        self.blocks = nn.ModuleList()
        self.sides = nn.ModuleList()
        in_ch = cfg.in_channels
        for ch, nconv, dil, scale in zip(
            cfg.block_channels, cfg.convs_per_block, cfg.dilations,
            self._scales(),
        ):
            self.blocks.append(
                ConvBlock(in_ch, ch, nconv, dil, cfg.use_batchnorm)
            )
            self.sides.append(SideLayer(
                ch, cfg.side_channels, scale, cfg.use_batchnorm,
                cfg.upsample_mode,
            ))
            in_ch = ch
        self.head = nn.Conv3d(
            cfg.side_channels * len(cfg.block_channels), 1, 1
        )

    def _scales(self):
        scales, scale = [], 1
        for do_pool in self.cfg.pool_after_block:
            scales.append(scale)
            if do_pool:
                scale *= 2
        return scales

    def forward(self, x: torch.Tensor, return_logits: bool = False,
                bn_group=None):
        dt = DTYPES[self.cfg.dtype]
        # NDHWC memory viewed as NCDHW is exactly channels_last_3d
        h = x.to(dt).permute(0, 4, 1, 2, 3)
        sides = []
        for block, side, do_pool in zip(
            self.blocks, self.sides, self.cfg.pool_after_block
        ):
            h = block(h, dt, bn_group)
            sides.append(side(h, dt, bn_group))
            if do_pool:
                h = F.max_pool3d(h, 2, 2)
        logits = _conv(self.head, torch.cat(sides, dim=1), dt)[:, 0].float()
        return logits if return_logits else torch.sigmoid(logits)


def forward_flops(cfg: ModelConfig, D: int) -> int:
    """Convolution FLOPs (2 per multiply-add) of one item at cube side D."""
    flops, c_in, d, scale = 0, cfg.in_channels, D, 1
    side = cfg.side_channels
    for ch, n_convs, do_pool in zip(
        cfg.block_channels, cfg.convs_per_block, cfg.pool_after_block
    ):
        for i in range(n_convs):
            flops += 2 * d**3 * 27 * (c_in if i == 0 else ch) * ch
        c_in = ch
        flops += 2 * d**3 * ch * side  # side layer 1^3 conv
        if scale > 1 and cfg.upsample_mode == "deconv":
            flops += 2 * d**3 * (2 * scale) ** 3 * side * side
        if do_pool:
            d //= 2
            scale *= 2
    return flops + 2 * D**3 * side * len(cfg.block_channels)  # head


def init_surfacenet(cfg: ModelConfig, generator: torch.Generator) -> SurfaceNet:
    """A SurfaceNet with seeded random weights, float32, on the CPU.

    Convolution kernels are drawn like flax's default, LeCun normal: a
    normal truncated at two of its deviations, scaled so that the kernel's
    deviation is 1/sqrt(fan_in) (``jax.nn.initializers.lecun_normal``),
    from ``generator``; biases are zero and BatchNorm starts at identity
    statistics, as in the reference's ``init``.  The values are not
    flax's; only the distribution is.
    """
    model = SurfaceNet(cfg)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv3d, nn.ConvTranspose3d)):
                fan_in = m.in_channels * math.prod(m.kernel_size)
                std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
    return model.eval()


def fold_bn(weight, gamma, beta, mean, var, eps: float = BN_EPS):
    """Fold inference BatchNorm into the preceding conv (float32).

    y = gamma * (conv(x) - mean) / sqrt(var + eps) + beta
      = conv(x; weight * inv) + (beta - mean * inv),  inv = gamma / sqrt(var + eps)

    ``weight`` is a torch (out, in, ...) kernel; returns (weight * inv
    over the output channels, beta - mean * inv).
    """
    inv = gamma / torch.sqrt(var + eps)
    shape = (-1,) + (1,) * (weight.dim() - 1)
    return weight * inv.reshape(shape), beta - mean * inv


def fused_params(state_dict, cfg: ModelConfig, device) -> dict:
    """``fused_infer_apply``'s parameters from a ``SurfaceNet`` state dict.

    BatchNorm is folded in float32, then each 3^3 kernel is packed into the
    conv kernel's (27 * Cin, Cout) layout in bf16 with a float32 bias, and
    the side and head 1^3 weights and biases are cast to ``cfg.dtype``:
    the values the reference computes on every call, computed once.

    Every conv's Cout is padded with zero channels to a multiple of
    ``CHANNEL_MULTIPLE`` (8; zero kernel columns, zero bias), which every
    route of the conv kernel needs, and the next conv's Cin and the block's side weight take zero
    rows to match (the paper width's 300 becomes 304, ``tiny``'s 12
    becomes 16; the first conv keeps ``in_channels``).  A padded channel is
    0 * w + 0 = 0, stays 0 through ReLU and max-pool and adds nothing to
    the next conv or the side matmul, so the function is unchanged, and
    widths already aligned come out as they were.
    """
    sd = {k: v.detach().to("cpu", torch.float32)
          for k, v in state_dict.items()}
    dt = DTYPES[cfg.dtype]

    def conv_params(conv, bn):
        w = sd[conv + "weight"]
        if cfg.use_batchnorm:
            return fold_bn(w, sd[bn + "weight"], sd[bn + "bias"],
                           sd[bn + "running_mean"], sd[bn + "running_var"])
        return w, sd.get(conv + "bias", torch.zeros(w.shape[0]))

    def put(t, dtype):
        return t.to(dtype).contiguous().to(device)

    blocks = []
    cin = cfg.in_channels  # the padded width of the running activation
    for b, (n_convs, dil) in enumerate(zip(cfg.convs_per_block,
                                           cfg.dilations)):
        convs = []
        for i in range(n_convs):
            w, bias = conv_params(f"blocks.{b}.convs.{i}.",
                                  f"blocks.{b}.bns.{i}.")
            cout = w.shape[0]
            pad = -cout % CHANNEL_MULTIPLE
            # (out, in, 3, 3, 3): zero input rows up to cin, zero outputs
            w = F.pad(w, (0, 0, 0, 0, 0, 0, 0, cin - w.shape[1], 0, pad))
            convs.append((put(pack_conv_weight(w), torch.bfloat16),
                          put(F.pad(bias, (0, pad)), torch.float32), dil))
            cin = cout + pad
        sw, sb = conv_params(f"sides.{b}.conv.", f"sides.{b}.bn.")
        sw = sw[:, :, 0, 0, 0].t()  # (ch, side)
        blocks.append({"convs": convs,
                       "side_w": put(F.pad(sw, (0, 0, 0, cin - sw.shape[0])),
                                     dt),
                       "side_b": put(sb, dt)})
    return {"blocks": blocks,
            "head_w": put(sd["head.weight"][:, :, 0, 0, 0].t(), dt),
            "head_b": put(sd["head.bias"], dt)}


def fused_infer_apply(cfg: ModelConfig, params: dict, x: torch.Tensor,
                      conv=conv3d) -> torch.Tensor:
    """Inference forward with conv + folded BN + ReLU fused into one conv.

    Port of the reference's ``fused_infer_apply``, cast for cast: each
    conv takes bf16 input and its bf16 output is cast to ``cfg.dtype``;
    side layers are a 1^3 matmul plus bias in ``cfg.dtype``, ReLU and a
    trilinear resize; max-pool 2^3; the head a matmul plus bias in
    ``cfg.dtype``, then float32 and sigmoid.  ``params`` come from
    ``fused_params``; ``conv`` is ``ops.cuda.conv3d.conv3d`` (the kernel
    on the card, its plain version on the CPU) unless a caller passes the
    plain version to compare with.

    x (B, D, D, D, in_channels) -> (B, D, D, D) float32 probability.
    """
    if cfg.upsample_mode == "deconv":
        raise NotImplementedError(
            "fused inference supports upsample_mode='resize'; use "
            "SurfaceNet for deconv side layers"
        )
    dt = DTYPES[cfg.dtype]
    x = x.to(dt)
    sides = []
    scale = 1
    for blk, do_pool in zip(params["blocks"], cfg.pool_after_block):
        for w, b, dil in blk["convs"]:
            x = conv(x.to(torch.bfloat16).contiguous(), w, b, dil=dil,
                     relu=True).to(dt)
        # side layer: 1^3 conv (a matmul) + folded BN + relu + resize
        side = torch.relu(x @ blk["side_w"] + blk["side_b"])
        if scale > 1:
            side = F.interpolate(
                side.permute(0, 4, 1, 2, 3), scale_factor=scale,
                mode="trilinear", align_corners=False,
            ).permute(0, 2, 3, 4, 1)
        sides.append(side)
        if do_pool:
            x = F.max_pool3d(x.permute(0, 4, 1, 2, 3), 2, 2).permute(
                0, 2, 3, 4, 1)
            scale *= 2
    h = torch.cat(sides, dim=-1)
    logits = (h @ params["head_w"] + params["head_b"])[..., 0].float()
    return torch.sigmoid(logits)


class FusedSurfaceNet(nn.Module):
    """``fused_infer_apply`` as a module: ``fused_params``' tensors held as
    buffers, so that ``torch.export`` can serialise the fused forward.

    Buffers are named by block and conv (``block{b}_conv{i}_w``, ``_b``;
    ``block{b}_side_w``, ``_b``; ``head_w``, ``head_b``); each conv's
    dilation is a plain attribute.  ``forward(x)`` is ``fused_infer_apply``
    (its convs through ``ops.cuda.conv3d.conv3d``, the registered conv op),
    so its result is bitwise that function's on the same parameters.
    """

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        self.dilations = []
        for b, blk in enumerate(params["blocks"]):
            dils = []
            for i, (w, bias, dil) in enumerate(blk["convs"]):
                self.register_buffer(f"block{b}_conv{i}_w", w)
                self.register_buffer(f"block{b}_conv{i}_b", bias)
                dils.append(dil)
            self.dilations.append(dils)
            self.register_buffer(f"block{b}_side_w", blk["side_w"])
            self.register_buffer(f"block{b}_side_b", blk["side_b"])
        self.register_buffer("head_w", params["head_w"])
        self.register_buffer("head_b", params["head_b"])

    def params(self) -> dict:
        """The buffers in ``fused_params``' layout."""
        get = self.get_buffer
        return {
            "blocks": [{
                "convs": [(get(f"block{b}_conv{i}_w"),
                           get(f"block{b}_conv{i}_b"), dil)
                          for i, dil in enumerate(dils)],
                "side_w": get(f"block{b}_side_w"),
                "side_b": get(f"block{b}_side_b"),
            } for b, dils in enumerate(self.dilations)],
            "head_w": self.head_w, "head_b": self.head_b,
        }

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_infer_apply(self.cfg, self.params(), x)


def make_predictor(model: SurfaceNet, cfg: ModelConfig, device):
    """Sweep predictor ``(x (B, D, D, D, 6), origins) -> (B, D, D, D)``.

    With ``cfg.fused_inference`` and resize side layers the predictor runs
    ``fused_infer_apply`` on ``fused_params(model.state_dict())``: every
    3^3 conv goes through the conv kernel on the card and through its
    plain version on the CPU.  (The reference takes this route only off
    the CPU, because its Pallas kernel cannot run there; the port takes it
    on the CPU too, which is the route its parity tests drive.)  That
    forward is a ``FusedSurfaceNet`` holding the parameters.  Otherwise
    the model moves to ``device`` in ``cfg.dtype`` with channels-last
    weights and runs ``SurfaceNet.forward``.  Either module is the
    callable's ``module`` (what ``cli export`` serialises).  The returned
    callable carries ``in_dtype`` so the sweep assembles its input batch
    directly in the model's dtype.
    """
    if cfg.fused_inference and cfg.upsample_mode == "resize":
        model = FusedSurfaceNet(cfg, fused_params(model.state_dict(), cfg,
                                                  device))
    else:
        model = model.to(device=device)
        # the convs' weights in cfg.dtype; BatchNorm keeps its float32
        # parameters and statistics, as flax's does (its output is in x's
        # dtype): rounded to bf16, they move each layer's output by more
        # than the output's own rounding does
        for m in model.modules():
            if isinstance(m, (nn.Conv3d, nn.ConvTranspose3d)):
                m.to(dtype=DTYPES[cfg.dtype])
        model = model.to(memory_format=torch.channels_last_3d).eval()

    def predictor(x, origins=None):
        with torch.inference_mode():
            return model(x)

    predictor.module = model
    predictor.in_dtype = cfg.dtype
    return predictor
