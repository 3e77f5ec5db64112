"""SurfaceNet 3D CNN: per-voxel surface-probability regressor.

Port of ``surfacenet_tpu/models/surfacenet.py``.  A fully-convolutional
network over a CVC pair (B, D, D, D, 6), channels last:

    per block: n x (conv3d 3^3 [dilated] -> BatchNorm -> relu)
               side layer: 1^3 conv -> BN -> relu -> upsample to D^3
               2^3 max-pool after the blocks that pool
    concat sides -> 1^3 conv -> sigmoid -> (B, D, D, D) probability

The reference runs this network as one XLA program, not a Pallas kernel,
so the port runs it on PyTorch's convolutions (cuDNN on the card), in the
config's compute dtype, with activations in ``channels_last_3d`` layout:
the (B, D, D, D, C) input is that layout already, so no copy is made.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from surfacenet_tpu_torch.config import ModelConfig

# flax.linen.BatchNorm's default epsilon, which the reference uses
BN_EPS = 1e-5

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


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
            self.bns.append(
                nn.BatchNorm3d(features, eps=BN_EPS) if use_bn
                else nn.Identity()
            )

    def forward(self, x):
        for conv, bn in zip(self.convs, self.bns):
            x = F.relu(bn(conv(x)), inplace=True)
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
        self.bn = (nn.BatchNorm3d(features, eps=BN_EPS) if use_bn
                   else nn.Identity())
        self.deconv = None
        if upsample > 1 and upsample_mode == "deconv":
            self.deconv = nn.ConvTranspose3d(
                features, features, 2 * upsample, stride=upsample,
                padding=upsample // 2,
            )
        elif upsample_mode not in ("resize", "deconv"):
            raise ValueError(f"unknown upsample_mode {upsample_mode!r}")

    def forward(self, x):
        x = F.relu(self.bn(self.conv(x)), inplace=True)
        if self.upsample > 1:
            if self.deconv is not None:
                x = self.deconv(x)
            else:
                x = F.interpolate(x, scale_factor=self.upsample,
                                  mode="trilinear", align_corners=False)
        return x


class SurfaceNet(nn.Module):
    """(B, D, D, D, in_channels) CVC pair -> (B, D, D, D) float32 probability.

    Runs in the dtype of its parameters (``make_predictor`` casts them to
    ``cfg.dtype``); the output is always float32.
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

    def forward(self, x: torch.Tensor, return_logits: bool = False):
        dt = self.head.weight.dtype
        # NDHWC memory viewed as NCDHW is exactly channels_last_3d
        h = x.to(dt).permute(0, 4, 1, 2, 3)
        sides = []
        for block, side, do_pool in zip(
            self.blocks, self.sides, self.cfg.pool_after_block
        ):
            h = block(h)
            sides.append(side(h))
            if do_pool:
                h = F.max_pool3d(h, 2, 2)
        logits = self.head(torch.cat(sides, dim=1))[:, 0].float()
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

    Convolution kernels are drawn like flax's default (LeCun normal:
    std 1/sqrt(fan_in)) from ``generator``; biases are zero and BatchNorm
    starts at identity statistics, as in the reference's ``init``.
    """
    model = SurfaceNet(cfg)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv3d, nn.ConvTranspose3d)):
                fan_in = m.in_channels * math.prod(m.kernel_size)
                m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in),
                                 generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
    return model.eval()


def make_predictor(model: SurfaceNet, cfg: ModelConfig, device):
    """Sweep predictor ``(x (B, D, D, D, 6), origins) -> (B, D, D, D)``.

    Moves the model to ``device`` in ``cfg.dtype`` with channels-last
    weights.  The returned callable carries ``in_dtype`` so the sweep
    assembles its input batch directly in the model's dtype.
    """
    model = model.to(device=device, dtype=DTYPES[cfg.dtype])
    model = model.to(memory_format=torch.channels_last_3d).eval()

    def predictor(x, origins=None):
        with torch.inference_mode():
            return model(x)

    predictor.in_dtype = cfg.dtype
    return predictor
