"""Time variants of the port's conv kernel (``csrc/conv3d.cu``) on one card.

    python3 scripts/torch_conv3d_variants.py [--items 120]

Each variant is the shipped source with a few lines replaced (its ring
depth, the cache level of the im2col copies, where the ring is refilled),
built with the port's own ``nvcc`` flags into a temporary directory and
loaded through the same C entry.  Every variant is first held against
``conv3d_plain`` (within one bf16 ulp on >= 0.9999 of outputs, and bitwise
equal over two launches) on small volumes; then each of SurfaceNet's
seven fast64 layer shapes is timed with CUDA events, the variants and
cuDNN's bf16 ``F.conv3d`` in turns (forwards, then backwards), and the
six layers of the wgmma route (Cin a multiple of 8) are summed.  Prints
the card's name and power limit, ``ptxas`` register and spill counts, one
JSON line per layer and one line of sums.  Needs an NVIDIA Hopper card;
PyTorch only.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import cuda_ms, within_one_bf16_ulp  # noqa: E402
from surfacenet_tpu_torch.ops.conv3d import conv3d_plain  # noqa: E402
from surfacenet_tpu_torch.ops.cuda import _build  # noqa: E402

# SurfaceNet fast64 at 64^3: (R, Cin, Cout, dil) of the forward's convs
LAYERS = [(64, 6, 32, 1), (32, 32, 128, 1), (32, 128, 128, 1),
          (16, 128, 128, 1), (16, 128, 128, 1), (16, 128, 256, 2),
          (16, 256, 256, 2)]
CHECKS = [(6, 32, 1, 8, 2), (32, 8, 1, 8, 3), (16, 72, 2, 8, 3),
          (128, 128, 1, 16, 4), (128, 256, 2, 8, 3), (256, 256, 2, 8, 3),
          (16, 16, 1, 5, 2)]  # (Cin, Cout, dil, R, B)

_STAGES = ("constexpr int STAGES = 3;",)
_CG = ("cp.async.cg.shared.global [%0], [%1], 16, %2;",)
_REFILL_CODE = """    const int next = c + STAGES - 2;
    if (next < n_chunks) load(next, next % STAGES);
    cp_async_commit();
"""
_WAIT = "    wgmma_wait<1>();  // this warpgroup's wgmma c - 1 is done\n"
_EPILOGUE = "  // epilogue: bias, ReLU and the bf16 rounding on the accumulator\n"
_DIRECT_EPILOGUE = """  // epilogue from the accumulator fragments: register 4j + 2h + e holds
  // row 16 warp + lane / 4 + 8 h, column 8 j + 2 (lane % 4) + e
  const int lane = tid & 31;
  const long long row0 = m0 + wgi * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  const int col0 = n0 + (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = col0 + 8 * j;
    if (col >= Cout) continue;  // Cout % 8 == 0: the pair is whole
    const float b_lo = bias[col];
    const float b_hi = bias[col + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = row0 + 8 * h;
      if (row >= M) continue;
      float lo = acc[4 * j + 2 * h] + b_lo;
      float hi = acc[4 * j + 2 * h + 1] + b_hi;
      if (relu) {
        lo = fmaxf(lo, 0.0f);
        hi = fmaxf(hi, 0.0f);
      }
      __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
      *reinterpret_cast<uint32_t*>(out + row * Cout + col) =
          *reinterpret_cast<uint32_t*>(&p);
    }
  }"""


def direct_epilogue(text):
    """The wgmma kernel's epilogue (from its first comment line to the
    kernel's end) replaced by 4-byte bf16x2 stores straight from the
    accumulator fragments."""
    start = text.index(_EPILOGUE)
    return text[:start] + _DIRECT_EPILOGUE + text[text.index("\n}\n", start):]


# name -> steps applied to the shipped source in order: (old, new) to
# replace, or a function of the text
VARIANTS = {
    "shipped": [],
    # one block an SM, chunk c + 2 loading during wgmma c
    "stages4": [_STAGES + ("constexpr int STAGES = 4;",)],
    "l1_cached_a": [_CG + ("cp.async.ca.shared.global [%0], [%1], 16, %2;",)],
    # refill the free stage after the wait for wgmma c - 1, not before
    # wgmma c: the copies get about one wgmma less time in flight
    "late_refill": [(_REFILL_CODE, ""), (_WAIT, _WAIT + _REFILL_CODE)],
    # 4-byte bf16x2 stores straight from the accumulator fragments
    "direct_epilogue": [direct_epilogue],
}


def build(tmp):
    """{name: ctypes function} of every variant that builds; logs ptxas."""
    src = open(os.path.join(_build.SRC_DIR, "conv3d.cu")).read()
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for step in subs:
            if callable(step):
                text = step(text)
                continue
            old, new = step
            if old not in text:
                raise RuntimeError(f"variant {name}: source line not found")
            text = text.replace(old, new)
        path = os.path.join(tmp, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.FLAGS, "-o", path[:-3] + ".so", path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  ptxas {name}: {line.strip()}")
        if proc.returncode:
            raise RuntimeError(f"variant {name} did not build:\n{out}")
        fn = ctypes.CDLL(os.path.join(tmp, f"{name}.so")).conv3d
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def run(fn, x, w, b, dil):
    """The wrapper's call (ops/cuda/conv3d.py) on variant ``fn``."""
    B, R, cin, cout = x.shape[0], x.shape[1], x.shape[4], w.shape[1]
    out = torch.empty((B, R, R, R, cout), dtype=torch.bfloat16,
                      device=x.device)
    wt = w.t().contiguous() if cin % 8 == 0 else None
    err = fn(x.data_ptr(), w.data_ptr(), wt.data_ptr() if wt is not None
             else None, b.data_ptr(), out.data_ptr(), B, R, cin, cout, dil, 1,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return out


def inputs(dev, B, R, cin, cout, seed):
    g = torch.Generator(dev).manual_seed(seed)
    x = torch.randn((B, R, R, R, cin), generator=g, device=dev).to(
        torch.bfloat16)
    w = (torch.randn((27 * cin, cout), generator=g, device=dev)
         / (27 * cin) ** 0.5).to(torch.bfloat16)
    b = torch.randn((cout,), generator=g, device=dev) * 0.1
    return x, w, b


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--items", type=int, default=120,
                    help="volumes a layer call (120: one dtu9_full batch)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    with tempfile.TemporaryDirectory() as tmp:
        fns = build(tmp)
        for cin, cout, dil, R, B in CHECKS:
            x, w, b = inputs(dev, B, R, cin, cout, cin + cout)
            ref = conv3d_plain(x, w, b, dil, True)
            for name, fn in fns.items():
                got, again = run(fn, x, w, b, dil), run(fn, x, w, b, dil)
                share, _ = within_one_bf16_ulp(got, ref)
                if share < 0.9999 or not torch.equal(got, again):
                    raise RuntimeError(
                        f"variant {name} disagrees at Cin {cin}, Cout {cout}, "
                        f"dil {dil}, R {R}: {share:.6f} within one bf16 ulp")
        print(f"all {len(fns)} variants agree with conv3d_plain on "
              f"{len(CHECKS)} shapes")
        sums = dict.fromkeys([*fns, "cudnn"], 0.0)
        for R, cin, cout, dil in LAYERS:
            x, w, b = inputs(dev, args.items, R, cin, cout, 7)
            xc = x.permute(0, 4, 1, 2, 3)
            wc = w.reshape(3, 3, 3, cin, cout).permute(4, 3, 0, 1, 2)
            wc = wc.contiguous(memory_format=torch.channels_last_3d)
            bc = b.to(torch.bfloat16)
            calls = {name: (lambda fn=fn: run(fn, x, w, b, dil))
                     for name, fn in fns.items()}
            calls["cudnn"] = lambda: F.conv3d(xc, wc, bc, padding=dil,
                                              dilation=dil).relu_()
            times = {name: [] for name in calls}
            for name in [*calls, *reversed(calls)]:
                times[name].append(cuda_ms(calls[name], iters=3, warmup=1))
            ms = {name: sum(t) / len(t) for name, t in times.items()}
            tflop = 2 * args.items * R**3 * cout * 27 * cin / 1e12
            tflops = {n: tflop / (t * 1e-3) for n, t in ms.items()}
            print(json.dumps({"R": R, "cin": cin, "cout": cout, "dil": dil,
                              "ms": ms, "tflops": tflops}), flush=True)
            if cin % 8 == 0:
                for name, t in ms.items():
                    sums[name] += t
            del x, w, b, xc, wc, bc
            torch.cuda.empty_cache()
        print(json.dumps({"wgmma_route_layers_ms": sums}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
