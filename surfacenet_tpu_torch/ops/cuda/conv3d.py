"""Wrapper of the implicit-GEMM conv3d CUDA kernel (``csrc/conv3d.cu``).

Replaces the Pallas TPU kernel ``surfacenet_tpu/ops/pallas/conv3d.py::
_conv3d_kernel``; ``conv3d`` is the counterpart of ``conv3d_fused`` and
computes what ``ops/conv3d.py::conv3d_plain`` computes.  The reference
sends a volume too large for VMEM (the 64^3 first block) to XLA's conv
instead; that is a TPU limit with the same semantics, so here every layer
goes through the kernel.  The source file's header states the kernel's
bound and design.  Its one C entry takes one of three routes by Cin
(``conv3d_route`` names them; the choice goes by shape only, and a route
that fails to launch raises, it never falls back to another):

- Cin a multiple of 8: ``wgmma``, an implicit GEMM fed by a ``cp.async``
  ring.  It reads the weights K-contiguous, so this wrapper passes a
  transposed copy of w, (Cout, 27 * Cin), made anew on every call (at most
  3.5 MB at the model's widths; it is not cached, and its time counts in
  the call's);
- Cin below 8 (the first layer's 6): ``halo_mma``, ``wgmma`` straight from
  an input halo staged once in shared memory, 8 zero-padded channels a
  voxel (at Cin 6 dilations up to 5: a wider halo does not fit, and the
  launch fails);
- any other Cin: ``wmma_scalar``, the first design, a ``wmma`` kernel
  with scalar loads.  No model layer takes it: ``fused_params`` pads
  every conv's channels to a multiple of 8 (the paper width's 300 to 304,
  ``tiny``'s 12 to 16).

The last two read w as it is.

The kernel's entry is a registered PyTorch op,
``torch.ops.surfacenet_tpu_torch.conv3d`` (``(Tensor x, Tensor w, Tensor
b, int dil, bool relu) -> Tensor``), so that ``torch.export`` can trace a
forward that calls it: its CUDA implementation launches the kernel, its
CPU implementation is the plain version, and its fake implementation
gives the output's shape without touching data.  An exported program
names the op; a process that loads one imports this module first, which
registers it.  ``conv3d`` checks its arguments and calls the op, so it
runs the plain version for tensors on the CPU and the kernel for tensors
on a CUDA device; there is no other route.  A failed build or launch
raises.  ``conv3d.launches`` counts kernel launches, and
``conv3d.route_launches`` the launches of each route, by
``conv3d_route``'s name.
"""

from __future__ import annotations

import ctypes

import torch

from surfacenet_tpu_torch.ops.conv3d import conv3d_plain
from surfacenet_tpu_torch.ops.cuda import _build

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
ROUTES = ("wgmma", "halo_mma", "wmma_scalar")
# every route's Cout, and the wgmma route's Cin, are multiples of this
CHANNEL_MULTIPLE = 8


def conv3d_route(cin: int) -> str:
    """The route the C entry ``conv3d`` takes for ``cin`` input channels."""
    if cin % CHANNEL_MULTIPLE == 0:
        return "wgmma"
    if cin < CHANNEL_MULTIPLE:
        return "halo_mma"
    return "wmma_scalar"


def _kernel_fn():
    fn = _build.load("conv3d").conv3d
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check(x, w, b, dil):
    if x.dim() != 5 or x.dtype != torch.bfloat16:
        raise ValueError(f"x must be bf16 (B, R, R, R, Cin), got {x.dtype} {tuple(x.shape)}")
    R, cin = x.shape[1], x.shape[4]
    if x.shape[2:4] != (R, R):
        raise ValueError(f"x volumes must be cubes, got {tuple(x.shape)}")
    if w.dim() != 2 or w.dtype != torch.bfloat16 or w.shape[0] != 27 * cin:
        raise ValueError(f"w must be bf16 ({27 * cin}, Cout), got {w.dtype} {tuple(w.shape)}")
    cout = w.shape[1]
    if b.shape != (cout,) or b.dtype != torch.float32:
        raise ValueError(f"b must be float32 ({cout},), got {b.dtype} {tuple(b.shape)}")
    if dil < 1:
        raise ValueError(f"dilation must be >= 1, got {dil}")
    for name, t in (("x", x), ("w", w), ("b", b)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_kernel(x, w):
    """What the kernel alone needs (the plain version takes any Cout)."""
    if w.shape[1] % CHANNEL_MULTIPLE:
        raise ValueError(f"Cout must be a multiple of {CHANNEL_MULTIPLE}, "
                         f"got {w.shape[1]}")
    for name, t in (("x", x), ("w", w)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _launch(x, w, b, dil, relu):
    """The kernel on CUDA tensors that ``_check`` accepted."""
    _check_kernel(x, w)
    B, R, cin, cout = x.shape[0], x.shape[1], x.shape[4], w.shape[1]
    out = torch.empty((B, R, R, R, cout), dtype=torch.bfloat16,
                      device=x.device)
    route = conv3d_route(cin)
    fn = _kernel_fn()
    with torch.cuda.device(x.device):
        # the wgmma route's K-contiguous weights (see the module docstring)
        wt = w.t().contiguous() if route == "wgmma" else None
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(),
                 wt.data_ptr() if wt is not None else None, b.data_ptr(),
                 out.data_ptr(), B, R, cin, cout, int(dil), int(bool(relu)),
                 stream)
    if err != 0:
        raise RuntimeError(f"conv3d kernel launch failed: CUDA error {err}")
    conv3d.launches += 1
    conv3d.route_launches[route] += 1
    return out


# The op is defined with ``torch.library.Library`` rather than
# ``torch.library.custom_op``: a custom_op wraps each implementation in a
# guard whose first call imports ``torch._dynamo``, seconds of host time
# that the first fused forward of every process would pay.
_LIB = torch.library.Library("surfacenet_tpu_torch", "DEF")
_LIB.define("conv3d(Tensor x, Tensor w, Tensor b, int dil, bool relu) "
            "-> Tensor")


def _conv3d_cuda(x, w, b, dil, relu):
    _check(x, w, b, dil)
    return _launch(x, w, b, dil, relu)


def _conv3d_cpu(x, w, b, dil, relu):
    _check(x, w, b, dil)
    return conv3d_plain(x, w, b, dil, relu)


def _conv3d_fake(x, w, b, dil, relu):
    _check(x, w, b, dil)
    R = x.shape[1]
    return x.new_empty((x.shape[0], R, R, R, w.shape[1]),
                       dtype=torch.bfloat16)


_LIB.impl("conv3d", _conv3d_cuda, "CUDA")
_LIB.impl("conv3d", _conv3d_cpu, "CPU")
torch.library.register_fake("surfacenet_tpu_torch::conv3d", _conv3d_fake,
                            lib=_LIB)
conv3d_op = torch.ops.surfacenet_tpu_torch.conv3d.default


def conv3d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, dil: int = 1,
           relu: bool = True) -> torch.Tensor:
    """SAME 3^3 conv (dilation ``dil``) + bias [+ ReLU]: (B, R, R, R, Cout) bf16.

    x (B, R, R, R, Cin) bf16; w (27 * Cin, Cout) bf16, tap-major rows
    (``ops.conv3d.pack_conv_weight``); b (Cout,) float32; all contiguous.
    The kernel also needs Cout a multiple of 8 and 16-byte aligned x, w.
    """
    _check(x, w, b, dil)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv3d: unsupported device {x.device}")
    return conv3d_op(x, w, b, int(dil), bool(relu))


conv3d.launches = 0
conv3d.route_launches = dict.fromkeys(ROUTES, 0)
