"""SAME 3x3x3 conv3d with bias and ReLU: the plain version of the conv kernel.

Port of the function that ``surfacenet_tpu/ops/pallas/conv3d.py``'s
``conv3d_pallas`` / ``conv3d_fused`` compute (their XLA oracle in
``tests/test_conv3d_pallas.py``).  The layouts are the reference's:

  * x (B, R, R, R, Cin) bf16, NDHWC;
  * w (27 * Cin, Cout) bf16, rows tap-major: tap (dz, dy, dx) in
    {-dil, 0, dil}^3 in C order, then cin; exactly ``w.reshape(27 * Cin,
    Cout)`` of a DHWIO kernel (``pack_conv_weight`` makes it from a torch
    (out, in, 3, 3, 3) kernel);
  * b (Cout,) float32.

The sum runs in float32 over the bf16 values (each product is exact),
then the bias is added in float32, ReLU applied and the result rounded to
bf16.  The CUDA kernel (``ops/cuda/conv3d.py``) computes the same function
with its sums in another order, so the two may differ by one bf16 rounding
step.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pack_conv_weight(weight: torch.Tensor) -> torch.Tensor:
    """torch (out, in, 3, 3, 3) kernel -> (27 * in, out), tap-major rows."""
    out_ch, in_ch = weight.shape[:2]
    return weight.permute(2, 3, 4, 1, 0).reshape(27 * in_ch, out_ch)


def conv3d_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 dil: int = 1, relu: bool = True) -> torch.Tensor:
    """(B, R, R, R, Cin) bf16 -> (B, R, R, R, Cout) bf16, contiguous NDHWC."""
    cin = x.shape[-1]
    cout = w.shape[-1]
    wt = w.float().reshape(3, 3, 3, cin, cout).permute(4, 3, 0, 1, 2)
    y = F.conv3d(x.float().permute(0, 4, 1, 2, 3), wt, padding=dil,
                 dilation=dil)
    y.add_(b.float()[:, None, None, None])  # in place: y is our own
    if relu:
        y.relu_()
    return y.to(torch.bfloat16).permute(0, 2, 3, 4, 1).contiguous()
