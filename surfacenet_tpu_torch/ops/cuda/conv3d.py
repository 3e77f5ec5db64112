"""Wrapper of the implicit-GEMM conv3d CUDA kernel (``csrc/conv3d.cu``).

Replaces the Pallas TPU kernel ``surfacenet_tpu/ops/pallas/conv3d.py::
_conv3d_kernel``; ``conv3d`` is the counterpart of ``conv3d_fused`` and
computes what ``ops/conv3d.py::conv3d_plain`` computes, at every Cin, Cout
and dilation the reference takes.  The reference sends a volume too large
for VMEM (the 64^3 first block) to XLA's conv instead; that is a TPU limit
with the same semantics, so here every layer goes through the kernel.  The
source file's header states the kernel's bound and design.  Each call
takes one of three routes, chosen by shape before any launch
(``conv3d_route`` names them; a launch that fails raises, and no route
gives way to another):

- Cin and Cout multiples of 8: ``wgmma``, an implicit GEMM fed by a
  ``cp.async`` ring.  It reads the weights K-contiguous, so this wrapper
  passes a transposed copy of w, (Cout, 27 * Cin), made anew on every call
  (at most 5 MB at the model's widths; it is not cached, and its time
  counts in the call's);
- Cin below 8 (the first layer's 6), Cout a multiple of 8 and a
  dilation up to ``HALO_MAX_DIL`` (5), where the halo fits in shared
  memory at every such Cin and Cout: ``halo_mma``, ``wgmma`` straight from an
  input halo staged once in shared memory, 8 zero-padded channels a voxel.
  It reads w as it is;
- any other shape (Cin above 8 and not a multiple of 8, Cout not a
  multiple of 8, Cin below 8 at a dilation above ``HALO_MAX_DIL``, or x
  not on a 16-byte boundary): ``wgmma_padded``.  ``pad_operands`` copies x
  into a new tensor with its channels zero-padded to Cin8 = ceil(Cin / 8)
  * 8 (unless it is aligned and Cin8 = Cin), and pads w to (27 * Cin8,
  Cout8) and b to Cout8 with zeros; the ``wgmma`` kernel runs on those,
  and its output is sliced back to Cout (a copy when Cout8 > Cout).  Zero
  channels add exact zeros to the float32 sums: the same function, for at
  most two passes over memory (x's copy and the slice).  No model layer
  takes it: ``fused_params`` pads every conv's channels once, at load time
  (the paper width's 300 to 304, ``tiny``'s 12 to 16).

The kernel's entry is a registered PyTorch op,
``torch.ops.surfacenet_tpu_torch.conv3d`` (``(Tensor x, Tensor w, Tensor
b, int dil, bool relu) -> Tensor``), so that ``torch.export`` can trace a
forward that calls it: its CUDA implementation launches the kernel, its
CPU implementation is the plain version, and its fake implementation
gives the output's shape without touching data.  Both take what ``_check``
accepts.  An exported program names the op; a process that loads one
imports this module first, which registers it.  ``conv3d`` checks its
arguments and calls the op, so it runs the plain version for tensors on
the CPU and the kernel for tensors on a CUDA device; there is no other
route.  A failed build or launch raises.  ``conv3d.launches`` counts
kernel launches, and ``conv3d.route_launches`` the launches of each
route, by ``conv3d_route``'s name.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from surfacenet_tpu_torch.ops.conv3d import conv3d_plain
from surfacenet_tpu_torch.ops.cuda import _build

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
ROUTES = ("wgmma", "halo_mma", "wgmma_padded")
# the kernel's Cout, and the wgmma route's Cin, are multiples of this
CHANNEL_MULTIPLE = 8

# the largest dilation the halo route takes: its halo fits in shared memory
# at every Cin below 8 and every Cout up to here (csrc/conv3d.cu, halo::
# MAX_DIL, which refuses a wider one)
HALO_MAX_DIL = 5


def conv3d_route(cin: int, cout: int, dil: int, aligned: bool = True) -> str:
    """The route a call on a card takes for ``cin`` -> ``cout`` channels at
    dilation ``dil``; ``aligned``: x starts on a 16-byte boundary."""
    if aligned and cout % CHANNEL_MULTIPLE == 0:
        if cin % CHANNEL_MULTIPLE == 0:
            return "wgmma"
        if cin < CHANNEL_MULTIPLE and dil <= HALO_MAX_DIL:
            return "halo_mma"
    return "wgmma_padded"


def _round_up(n: int) -> int:
    return -(-n // CHANNEL_MULTIPLE) * CHANNEL_MULTIPLE


def pad_operands(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """(x, w, b) zero-padded to the ``wgmma`` route's shape, with Cin8 and
    Cout8 the channel counts rounded up to multiples of 8: x (B, R, R, R,
    Cin8) in a new contiguous tensor (x itself where Cin8 = Cin and x lies
    on a 16-byte boundary), w (27 * Cin8, Cout8) with zero rows after each
    tap's Cin and zero columns after Cout, b (Cout8,).  Plain tensor code,
    the ``wgmma_padded`` route's first pass."""
    cin, cout = x.shape[4], w.shape[1]
    cin8, cout8 = _round_up(cin), _round_up(cout)
    # F.pad returns a new tensor even where it pads nothing
    xp = x if cin8 == cin and x.data_ptr() % 16 == 0 else F.pad(
        x, (0, cin8 - cin))
    wp = F.pad(w.view(27, cin, cout), (0, cout8 - cout, 0, cin8 - cin))
    return xp, wp.view(27 * cin8, cout8), F.pad(b, (0, cout8 - cout))


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


def _run(fn, x, w, b, dil, relu, route):
    """One launch of the C entry on ``route`` (``wgmma`` or ``halo_mma``),
    on operands that route takes as they are."""
    B, R, cin, cout = x.shape[0], x.shape[1], x.shape[4], w.shape[1]
    out = torch.empty((B, R, R, R, cout), dtype=torch.bfloat16,
                      device=x.device)
    # the wgmma route's K-contiguous weights (see the module docstring)
    wt = w.t().contiguous() if route == "wgmma" else None
    err = fn(x.data_ptr(), w.data_ptr(),
             wt.data_ptr() if wt is not None else None, b.data_ptr(),
             out.data_ptr(), B, R, cin, cout, int(dil), int(bool(relu)),
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3d kernel launch failed: CUDA error {err}")
    return out


def _launch(x, w, b, dil, relu):
    """The kernel on CUDA tensors that ``_check`` accepted."""
    cout = w.shape[1]
    route = conv3d_route(x.shape[4], cout, dil,
                         aligned=x.data_ptr() % 16 == 0)
    fn = _kernel_fn()
    with torch.cuda.device(x.device):
        if route != "wgmma_padded":
            out = _run(fn, x, w, b, dil, relu, route)
        else:
            out = _run(fn, *pad_operands(x, w, b), dil, relu, "wgmma")
            if out.shape[4] != cout:
                out = out[..., :cout].contiguous()
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
    Any Cin, Cout and dilation, on the CPU (the plain version) and on a card
    alike: on a card a shape the kernel does not take as it is goes through
    ``wgmma_padded`` (see the module docstring).
    """
    _check(x, w, b, dil)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv3d: unsupported device {x.device}")
    return conv3d_op(x, w, b, int(dil), bool(relu))


conv3d.launches = 0
conv3d.route_launches = dict.fromkeys(ROUTES, 0)
