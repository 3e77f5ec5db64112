"""Time variants of the port's conv kernel (``csrc/conv3d.cu``) on one card.

    python3 scripts/torch_conv3d_variants.py [--items 120]

Each variant is the shipped source with a few lines replaced, built with
the port's own ``nvcc`` flags into a temporary directory and loaded through
the same C entry.  The wgmma route's variants change its ring depth, the
cache level of the im2col copies, where the ring is refilled and its
epilogue; the halo route's (Cin < 8) its tile, its blocks an SM, its
persistent grid, its stores, and wgmma against mma.sync.  Every variant is first held against ``conv3d_plain`` (within one bf16 ulp
on >= 0.9999 of outputs, and bitwise equal over two launches) on small
volumes; then each of SurfaceNet's seven fast64 layer shapes is timed with
CUDA events, the shipped source, the variants of the layer's route and
cuDNN's bf16 ``F.conv3d`` in turns (forwards, then backwards), and each
route's layers are summed; at the first layer, diagnostics that each leave
out one part of the halo route's work are timed too (never checked: their
output is wrong).  Last, the ``wgmma_padded`` route at the paper width's
widest layer at the reference's own width (300 -> 300), through
``chip_smoke.conv_layer``: checked against the plain version, timed
beside it and cuDNN, with its pad pass, its kernel on the padded operands
and its slice timed apart.  Prints the card's name and power limit, ``ptxas``
register and spill counts, one JSON line per layer (with its bound) and one
line of sums.  Needs an NVIDIA Hopper card; PyTorch only.
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

from chip_smoke import (  # noqa: E402
    PEAK_BF16_S, bound, conv_layer, cuda_ms, within_one_bf16_ulp,
)
from surfacenet_tpu_torch.ops.conv3d import conv3d_plain  # noqa: E402
from surfacenet_tpu_torch.ops.cuda import _build  # noqa: E402
from surfacenet_tpu_torch.ops.cuda.conv3d import conv3d_route  # noqa: E402

# SurfaceNet fast64 at 64^3: (R, Cin, Cout, dil) of the forward's convs
LAYERS = [(64, 6, 32, 1), (32, 32, 128, 1), (32, 128, 128, 1),
          (16, 128, 128, 1), (16, 128, 128, 1), (16, 128, 256, 2),
          (16, 256, 256, 2)]
# the paper width's (block_channels (32, 80, 160, 300)) widest layer, 300
# -> 300 at dil 2, at the reference's own width: the op pads Cin and Cout
# to 304 (wgmma_padded)
PADDED_LAYERS = [(16, 300, 300, 2)]
CHECKS = [(6, 32, 1, 8, 2), (32, 8, 1, 8, 3), (16, 72, 2, 8, 3),
          (128, 128, 1, 16, 4), (128, 256, 2, 8, 3), (256, 256, 2, 8, 3),
          (16, 16, 1, 5, 2), (3, 16, 2, 9, 2), (6, 32, 2, 8, 3),
          (6, 72, 1, 13, 2)]  # (Cin, Cout, dil, R, B)

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


_TILE = ("constexpr int TILE_Y = 8;", "constexpr int TILE_Z = 5;")
_HALO_STORE = """#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = (lane >> 2) + 8 * h;
          const int piece = lane & 3;
          if (piece < nt && r0 + r < n_vox)
            *reinterpret_cast<uint4*>(
                out + (vox + r0 + r) * s.Cout + n0 + ng + piece * 8) =
                *reinterpret_cast<const uint4*>(stage +
                                                stage_offset(r, piece));
        }
"""
_BULK_STORE = """        if (s.Cout == 32 && r0 + 16 <= n_vox) {
          // the warp's 16 voxels' 1 KB is contiguous in out: one bulk copy
          asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
          __syncwarp();
          if (lane == 0) {
            asm volatile(
                "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], "
                "1024;\\n" ::"l"(out + (vox + r0) * 32),
                "r"(smem_addr(stage))
                : "memory");
            asm volatile("cp.async.bulk.commit_group;\\n" ::: "memory");
            asm volatile("cp.async.bulk.wait_group.read 0;\\n" :::
                             "memory");
          }
        } else {
""" + _HALO_STORE + """        }
"""
_STCS_STMT = """            __stcs(reinterpret_cast<uint4*>(
                       out + (vox + r0 + r) * s.Cout + n0 + ng + piece * 8),
                   *reinterpret_cast<const uint4*>(
                       stage + stage_offset(r, piece)));
"""
_STORE_STMT = """            *reinterpret_cast<uint4*>(
                out + (vox + r0 + r) * s.Cout + n0 + ng + piece * 8) =
                *reinterpret_cast<const uint4*>(stage +
                                                stage_offset(r, piece));
"""
_SWIZZLE = ("return r * 64 + ((p ^ ((r >> 1) & 3)) << 4);",
            "return r * 64 + (p << 4);")
_PERSISTENT = """  const long long grid = n_work < (long long)sms * per_sm
                             ? n_work
                             : (long long)sms * per_sm;
"""

_MMA_SYNC_PRODUCTS = """    // products (variant): mma.sync m16n8k16, both operands by ldmatrix
    // (A straight from the halo, B from the K-major core matrices); a warp
    // takes two m16 tiles (16 voxels along x) at a time
    auto ldsm4 = [](uint32_t (&r)[4], uint32_t addr) {
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\\n"
          : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
          : "r"(addr)
          : "memory");
    };
    auto mma = [](float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                  uint32_t b1) {
      asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    };
    const int n_vox = min(TX, R - t.x0);
    const int n_units = s.ty * s.tz * (TX / 16) / 2;
    for (int ng = 0; ng < nb; ng += 32) {
      const int nt = min(4, (nb - ng) / 8);
      float2 bias_r[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bias_r[j] = *reinterpret_cast<const float2*>(bias_s + ng + 8 * j +
                                                     2 * (lane & 3));
      for (int u = warp; u < n_units; u += WARPS) {
        uint32_t base[2];
        int nv[2];
        long long vox[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int mi = 2 * u + i;
          const int row = mi / (TX / 16);
          const int lx = mi % (TX / 16) * 16;
          const int ly = row % s.ty;
          const int lz = row / s.ty;
          const bool ok = t.y0 + ly < R && t.z0 + lz < R && lx < n_vox;
          nv[i] = ok ? min(16, n_vox - lx) : 0;
          base[i] = halo_a + (lz * s.hy + ly) * s.row_bytes +
                    (lx + (lane & 15)) * 16;
          vox[i] = (((long long)t.item * R + t.z0 + lz) * R + t.y0 + ly) * R +
                   t.x0 + lx;
        }
        float acc[2][4][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
#pragma unroll
        for (int k = 0; k < KSTEPS; ++k) {
          uint32_t b[4][2];
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            uint32_t r[4];
            ldsm4(r, b_a + ((2 * k + ((lane >> 3) & 1)) * nb8 + ng / 8 +
                            2 * p + (lane >> 4)) * 128 + (lane & 7) * 16);
            b[2 * p][0] = r[0];
            b[2 * p][1] = r[1];
            b[2 * p + 1][0] = r[2];
            b[2 * p + 1][1] = r[3];
          }
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if (!nv[i]) continue;
            uint32_t a[4];
            ldsm4(a, k == KSTEPS - 1 && lane >= 16
                         ? zero_a
                         : base[i] + tap_off(2 * k + (lane >> 4)) * 16);
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (j < nt) mma(acc[i][j], a, b[j][0], b[j][1]);
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (!nv[i]) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint32_t p[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              float lo = acc[i][j][2 * h] + bias_r[j].x;
              float hi = acc[i][j][2 * h + 1] + bias_r[j].y;
              if (s.relu) {
                lo = fmaxf(lo, 0.0f);
                hi = fmaxf(hi, 0.0f);
              }
              __nv_bfloat162 pr = __floats2bfloat162_rn(lo, hi);
              p[j] = *reinterpret_cast<uint32_t*>(&pr);
            }
            stsm_x4(st_a + h * 8 * 64, p);
          }
          __syncwarp();
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = (lane >> 2) + 8 * h;
            const int piece = lane & 3;
            if (piece < nt && r < nv[i])
              *reinterpret_cast<uint4*>(
                  out + (vox[i] + r) * s.Cout + n0 + ng + piece * 8) =
                  *reinterpret_cast<const uint4*>(stage +
                                                  stage_offset(r, piece));
          }
          __syncwarp();
        }
      }
    }
"""
_PRODUCTS = "    // products: warpgroup g takes the tile's rows g, g + 2, ..."


def mma_sync_products(text):
    """The halo kernel's products (from their first comment line to the end
    of the tile loop) replaced by mma.sync on ldmatrix fragments."""
    start = text.index(_PRODUCTS)
    end = text.index("  }\n}\n", start)
    return text[:start] + _MMA_SYNC_PRODUCTS + text[end:]


_HALO_EPILOGUE = "        // epilogue: bias, ReLU and the bf16 rounding on the fragments,\n"
_HALO_END = "      }\n    }\n  }\n}\n\ntemplate <int CIN>\nint launch_cin("
_DIRECT_HALO_EPILOGUE = """        // epilogue (variant): 4-byte bf16x2 stores straight from the
        // fragments
        const int r0 = 16 * (warp & 3);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + (lane >> 2) + 8 * h;
          if (r >= n_vox) continue;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (j >= nt) continue;
            float lo = acc[4 * j + 2 * h] + bias_r[j].x;
            float hi = acc[4 * j + 2 * h + 1] + bias_r[j].y;
            if (s.relu) {
              lo = fmaxf(lo, 0.0f);
              hi = fmaxf(hi, 0.0f);
            }
            __nv_bfloat162 pr = __floats2bfloat162_rn(lo, hi);
            *reinterpret_cast<uint32_t*>(out + (vox + r) * s.Cout + n0 + ng +
                                         8 * j + 2 * (lane & 3)) =
                *reinterpret_cast<uint32_t*>(&pr);
          }
        }
"""
_SHUFFLE_HALO_EPILOGUE = """        // epilogue (variant): the four lanes of a row swap their fragments
        // (a 4 x 4 transpose by shuffles) so that lane q holds channels
        // 8 q .. 8 q + 7 and stores them as 16 bytes, no shared memory
        const int r0 = 16 * (warp & 3);
        const int q = lane & 3;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t v[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float lo = acc[4 * j + 2 * h] + bias_r[j].x;
            float hi = acc[4 * j + 2 * h + 1] + bias_r[j].y;
            if (s.relu) {
              lo = fmaxf(lo, 0.0f);
              hi = fmaxf(hi, 0.0f);
            }
            __nv_bfloat162 pr = __floats2bfloat162_rn(lo, hi);
            v[j] = *reinterpret_cast<uint32_t*>(&pr);
          }
          auto pick = [&](int i) {
            return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
          };
          uint32_t wv[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const uint32_t got =
                x == 0 ? pick(q) : __shfl_xor_sync(0xffffffffu, pick(q ^ x), x);
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (i == (q ^ x)) wv[i] = got;
          }
          const int r = r0 + (lane >> 2) + 8 * h;
          if (q < nt && r < n_vox)
            *reinterpret_cast<uint4*>(out + (vox + r) * s.Cout + n0 + ng +
                                      8 * q) =
                make_uint4(wv[0], wv[1], wv[2], wv[3]);
        }
"""


def halo_epilogue(new):
    """A step replacing the halo kernel's epilogue (from its first comment
    line to the end of the row loop) with ``new``."""
    def step(text):
        start = text.index(_HALO_EPILOGUE)
        return text[:start] + new + text[text.index(_HALO_END, start):]
    return step


# name -> (the route it changes, steps applied to the shipped source in
# order: (old, new) to replace, or a function of the text)
VARIANTS = {
    "shipped": (None, []),
    # wgmma route: one block an SM, chunk c + 2 loading during wgmma c
    "stages4": ("wgmma", [_STAGES + ("constexpr int STAGES = 4;",)]),
    "l1_cached_a": ("wgmma", [
        _CG + ("cp.async.ca.shared.global [%0], [%1], 16, %2;",)]),
    # refill the free stage after the wait for wgmma c - 1, not before
    # wgmma c: the copies get about one wgmma less time in flight
    "late_refill": ("wgmma", [(_REFILL_CODE, ""),
                              (_WAIT, _WAIT + _REFILL_CODE)]),
    # 4-byte bf16x2 stores straight from the accumulator fragments
    "direct_epilogue": ("wgmma", [direct_epilogue]),
    # halo route: tiles of 4 x 4, 8 x 4 and 8 x 6 rows of 64 voxels (two
    # blocks an SM), and 8 x 8 (one)
    "halo_tile_4x4": ("halo_mma", [(_TILE[0], "constexpr int TILE_Y = 4;"),
                                   (_TILE[1], "constexpr int TILE_Z = 4;")]),
    "halo_tile_8x4": ("halo_mma", [(_TILE[1], "constexpr int TILE_Z = 4;")]),
    "halo_tile_8x6": ("halo_mma", [(_TILE[1], "constexpr int TILE_Z = 6;")]),
    "halo_tile_8x8": ("halo_mma", [(_TILE[1], "constexpr int TILE_Z = 8;")]),
    # 8 x 2 rows with registers capped for three blocks an SM
    "halo_tile_8x2_3_blocks": ("halo_mma", [
        (_TILE[1], "constexpr int TILE_Z = 2;"),
        ("__launch_bounds__(THREADS, 2)\n    conv3d_halo",
         "__launch_bounds__(THREADS, 3)\n    conv3d_halo")]),
    # one tile a block: the weights staged by every block
    "halo_one_tile_blocks": ("halo_mma", [
        (_PERSISTENT, "  const long long grid = n_work;\n")]),
    # a warp's 16 voxels of a row (1 KB at Cout 32) by one cp.async.bulk
    # from an unswizzled staging tile, instead of 16-byte stores by every
    # lane
    "halo_bulk_store": ("halo_mma", [(_HALO_STORE, _BULK_STORE), _SWIZZLE]),
    # mma.sync m16n8k16 from ldmatrix fragments (A from the same halo, B
    # from the same core matrices) instead of wgmma
    "halo_mma_sync": ("halo_mma", [mma_sync_products]),
    # the output stored without staging: 4-byte stores straight from the
    # fragments, or 16-byte stores after a transpose by shuffles
    "halo_direct_stores": ("halo_mma", [halo_epilogue(_DIRECT_HALO_EPILOGUE)]),
    "halo_shuffle_stores": ("halo_mma", [
        halo_epilogue(_SHUFFLE_HALO_EPILOGUE)]),
    # the output stored with st.global.cs (evict first from L2)
    "halo_streaming_stores": ("halo_mma", [(_STORE_STMT, _STCS_STMT)]),
}

# diagnostics of the halo route: each leaves out one part of the work, so
# its output is wrong and it is never checked; timed beside the shipped
# source at the first layer only, to split its time
DIAGNOSTICS = {
    # no global stores (the epilogue still stages the tile)
    "diag_no_store": ("halo_mma", [(
        "          if (piece < nt && r0 + r < n_vox)\n",
        "          if (piece < nt && r0 + r < n_vox && s.relu == 7)\n")]),
    # no tensor-core products: one add a K step instead
    "diag_no_mma": ("halo_mma", [(
        "          wgmma_n32(acc, ((uint64_t)(128 >> 4) << 32) | lo,\n",
        "          acc[k] += __uint_as_float(lo & 0x3f000000u);\n"
        "          if (0) wgmma_n32(acc, ((uint64_t)(128 >> 4) << 32) | lo,\n"
    )]),
    # no copies of the input (the halo is spread from stale bytes)
    "diag_no_copies": ("halo_mma", [(
        "    copy_rows(t);\n", "")]),
    # no spreading of the rows into the halo
    "diag_no_expand": ("halo_mma", [(
        "    expand_rows(t);\n", "")]),
}


def build(tmp):
    """{name: ctypes function} of every variant that builds; logs ptxas."""
    src = open(os.path.join(_build.SRC_DIR, "conv3d.cu")).read()
    procs = {}
    for name, (_, subs) in {**VARIANTS, **DIAGNOSTICS}.items():
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


def time_layer(fns, dev, items, R, cin, cout, dil):
    """Times ``fns`` and cuDNN at one layer shape, in turns; prints and
    returns the mean milliseconds by name."""
    x, w, b = inputs(dev, items, R, cin, cout, 7)
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
    flops = 2 * items * R**3 * cout * 27 * cin
    n_bytes = (x.numel() * 2 + w.numel() * 2 + b.numel() * 4
               + items * R**3 * cout * 2)
    b_ms, b_by = bound(n_bytes, flops, PEAK_BF16_S)
    record = {"R": R, "cin": cin, "cout": cout, "dil": dil,
              "route": conv3d_route(cin, cout, dil), "ms": ms,
              "tflops": {n: flops / (t * 1e-3) / 1e12 for n, t in ms.items()},
              "bound_ms": b_ms, "bound_by": b_by,
              "bound_share": {n: b_ms / t for n, t in ms.items()}}
    print(json.dumps(record), flush=True)
    del x, w, b, xc, wc, bc
    torch.cuda.empty_cache()
    return ms


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
        checked = {name: fns[name] for name in VARIANTS}
        for cin, cout, dil, R, B in CHECKS:
            x, w, b = inputs(dev, B, R, cin, cout, cin + cout)
            ref = conv3d_plain(x, w, b, dil, True)
            for name, fn in checked.items():
                got, again = run(fn, x, w, b, dil), run(fn, x, w, b, dil)
                share, _ = within_one_bf16_ulp(got, ref)
                if share < 0.9999 or not torch.equal(got, again):
                    raise RuntimeError(
                        f"variant {name} disagrees at Cin {cin}, Cout {cout}, "
                        f"dil {dil}, R {R}: {share:.6f} within one bf16 ulp")
        print(f"all {len(checked)} variants agree with conv3d_plain on "
              f"{len(CHECKS)} shapes")
        sums = {}
        for R, cin, cout, dil in LAYERS:
            route = conv3d_route(cin, cout, dil)
            on = {name: fn for name, fn in checked.items()
                  if VARIANTS[name][0] in (None, route)}
            if route == "halo_mma":
                on.update((name, fns[name]) for name in DIAGNOSTICS)
            ms = time_layer(on, dev, args.items, R, cin, cout, dil)
            for name, t in ms.items():
                sums.setdefault(route, {}).setdefault(name, 0.0)
                sums[route][name] += t
        print(json.dumps({"route_layers_ms": sums}), flush=True)
    gen = torch.Generator(dev).manual_seed(7)
    for R, cin, cout, dil in PADDED_LAYERS:
        print(json.dumps(conv_layer(R, cin, cout, dil, args.items, gen)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
