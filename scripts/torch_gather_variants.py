"""Time variants of the port's warp-gather kernel (``csrc/warp_gather.cu``).

    python3 scripts/torch_gather_variants.py [--items 168]

Each variant is the shipped source with a few lines replaced, built with
the port's own ``nvcc`` flags into a temporary directory and called
through the same C entries.  The variants change the voxels a thread
owns along k (``KR`` 1, 2, 4 or 8); how a warp's lanes spread over the
block (along one row's runs, as the first design had it, or over 4, 8 or
16 rows of the patch); the block's patch of rows (square, a 1 x 16 strip,
or long along the item's viewing direction) and its size (256 or 512
threads); the colour stores (staged per warp, stored by each lane, or
staged for the whole block behind a barrier, and evict-first); the tap
loads (evict-last in L2, one load for an aligned horizontal pixel pair,
branch-free, or from the block's image window staged in shared memory);
and the registers a thread may use (six or eight blocks an SM).  Each
reads the sweep's RGBx copy (a fourth, unread channel: one aligned load a
pixel), but ``rgb_images``: the shipped kernel reading three-channel
images, three loads a tap.

Every variant is first held against the plain version
(``ops/cvc.py::build_cvc_views``) for the bf16, float32 and int8 entries at
D 16, 17, 32 and 64 on a small scene: validity agreement >= 0.9999, colour |diff| <= 1e-3 where both are valid,
zero where invalid, the int8 entry bitwise equal, and two launches giving
equal bits.  Then each is timed with CUDA events on the items of the smoke
scene's first batch (``chip_smoke.py`` phase 6: 12 views of 600x800,
``dtu9_full``, 24 cubes x their distinct views of 64^3), in turns
(forwards, then backwards), beside ``F.grid_sample`` (float32 bilinear
sampling of the same projected points) and the plain version.
Diagnostics that each leave out or cheapen one part of the work (no
stores, no taps, all taps in one cache line, one tap a voxel, approximate
divisions) are timed too, never checked: their output is wrong.  Prints the card's name and power limit, ``ptxas`` register and
spill counts, one JSON line per entry, and the bound.  Needs an
NVIDIA Hopper card; PyTorch only.
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
    GATHER_INT8_OPS_VALID, GATHER_OPS_ALL, GATHER_OPS_VALID, bound, cuda_ms,
    footprint_pixels,
)
from surfacenet_tpu_torch.config import baseline_config  # noqa: E402
from surfacenet_tpu_torch.data.synthetic import make_sphere_scene  # noqa: E402
from surfacenet_tpu_torch.geometry.camera import project_rows  # noqa: E402
from surfacenet_tpu_torch.ops.cuda import _build  # noqa: E402
from surfacenet_tpu_torch.ops.cuda.warp_gather import _ARGTYPES, _ENTRY  # noqa: E402
from surfacenet_tpu_torch.ops.cvc import build_cvc_views  # noqa: E402
from surfacenet_tpu_torch.pipeline.sweep import gather_images, plan_sweep  # noqa: E402

_KR = "constexpr int KR = 4;"
_ROW_BITS = "constexpr int ROW_BITS = 4;"
_SAMPLE = "      if (ok[t]) sample<T>(img, H, W, u, v, rgb[t]);\n"
_DIV = ("      const float u = nu / d;\n      const float v = nv / d;\n")
_FETCHES = """  fetch<T>(img, v0i * W + u0i, c00);
  fetch<T>(img, v0i * W + u1i, c01);
  fetch<T>(img, v1i * W + u0i, c10);
  fetch<T>(img, v1i * W + u1i, c11);
"""
_SAMPLE_DOC = "// bilinear colour at (u, v), inside the image\n"
_FETCH_DOC = "// channels 0-2 of pixel `pix`"
_KERNEL_DOC = "// grid (tiles of an item, items); block: THREADS"
_BOUNDS = "__global__ void __launch_bounds__(THREADS)\n"
_PATCH = "  const int li = l_rows / 2, lj = l_rows - li;\n"
_GRID = "  dim3 grid(((D + (1 << li) - 1) >> li) * tiles_j, B);\n"
_DECODE = """  const int b = blockIdx.y;
  const int ti = blockIdx.x / tiles_j;
"""
_EXIT = "  if (i >= D || j >= D || k0 >= D) return;\n"
_IMG = "  const T* img = images + (size_t)view * H * W * C;\n"
_STAGE_STORE = ("        reinterpret_cast<float4*>(colors + 3 * oo)[c % NQ] = "
                "st[c];\n")
_WORD = "        reinterpret_cast<uint32_t*>(valid + o)[m] =\n"
_SCALAR_FOR = "  for (int t = 0; t < n; ++t) {\n"
_STAGING = _STAGE_STORE  # (the staged block is cut out from its start)
_STAGED_START = "      constexpr int NQ = 3 * KR / 4;  // 16-byte pieces a run\n"
_STAGED_END = "      }\n#pragma unroll\n      for (int m = 0; m < KR / 4; ++m)\n"


def cut(start, end, new):
    """A step replacing the text from ``start`` up to ``end`` (kept)."""
    def step(text):
        i = text.index(start)
        return text[:i] + new + text[text.index(end, i):]
    return step


# each run's three 16-byte pieces stored by its own lane (no staging)
_DIRECT = """      float4* dst = reinterpret_cast<float4*>(colors + 3 * o);
#pragma unroll
      for (int m = 0; m < 3 * KR / 4; ++m)
        dst[m] = make_float4(rgb[(4 * m) / 3][(4 * m) % 3],
                             rgb[(4 * m + 1) / 3][(4 * m + 1) % 3],
                             rgb[(4 * m + 2) / 3][(4 * m + 2) % 3],
                             rgb[(4 * m + 3) / 3][(4 * m + 3) % 3]);
"""
_DIRECT_STEP = cut(_STAGED_START, "#pragma unroll\n      for (int m = 0; m < KR / 4; ++m)\n",
                   _DIRECT)
# the block's whole output staged in shared memory and stored run after
# run in the output's order, after a barrier
_BLOCK = """      __shared__ float4 stage_c[THREADS * 3 * KR / 4];
      const int slot = (row << lr) + k0 / KR;  // the run's place in order
#pragma unroll
      for (int m = 0; m < 3 * KR / 4; ++m)
        stage_c[3 * KR / 4 * slot + m] = make_float4(
            rgb[(4 * m) / 3][(4 * m) % 3], rgb[(4 * m + 1) / 3][(4 * m + 1) % 3],
            rgb[(4 * m + 2) / 3][(4 * m + 2) % 3],
            rgb[(4 * m + 3) / 3][(4 * m + 3) % 3]);
      __syncthreads();
      for (int c = threadIdx.x; c < THREADS * 3 * KR / 4; c += THREADS) {
        const int run = c / (3 * KR / 4);
        const int r = run >> lr;
        const size_t ov = (size_t)b * D * D * D +
                          ((size_t)((ti << li) + (r >> lj)) * D + (tj << lj) +
                           (r & ((1 << lj) - 1))) * D +
                          (run & ((1 << lr) - 1)) * KR;
        reinterpret_cast<float4*>(colors + 3 * ov)[c % (3 * KR / 4)] =
            stage_c[c];
      }
"""
_BLOCK_STEP = cut(_STAGED_START, "#pragma unroll\n      for (int m = 0; m < KR / 4; ++m)\n",
                  _BLOCK)
_DEPTH_AXIS = """// (variant) the cube axis along which a voxel step moves the projection
// least, at the cube's centre: the axis closest to the viewing direction
__device__ __forceinline__ int depth_axis(const float* P, float ox, float oy,
                                          float oz, float half) {
  const float cx = ox + half, cy = oy + half, cz = oz + half;
  const float den = P[8] * cx + P[9] * cy + P[10] * cz + P[11];
  const float u = (P[0] * cx + P[1] * cy + P[2] * cz + P[3]) / den;
  const float v = (P[4] * cx + P[5] * cy + P[6] * cz + P[7]) / den;
  int axis = 2;
  float best = INFINITY;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float du = P[a] - u * P[8 + a];
    const float dv = P[4 + a] - v * P[8 + a];
    if (du * du + dv * dv < best) {
      best = du * du + dv * dv;
      axis = a;
    }
  }
  return axis;
}

"""
_DEPTH_DECODE = """  const int b = blockIdx.y;
  {
    // (variant) the patch turned along the item's depth axis where that
    // is i or j
    const float* Pb = Ps + 12 * view_idx[b];
    const int a = depth_axis(Pb, origins[3 * b], origins[3 * b + 1],
                             origins[3 * b + 2], 0.5f * s * D);
    const int l_rows = li + lj;
    int l_depth = 0;
    while ((1 << l_depth) < D && l_depth < l_rows) ++l_depth;
    if (a == 0) {
      li = l_depth;
      lj = l_rows - l_depth;
    } else if (a == 1) {
      li = l_rows - l_depth;
      lj = l_depth;
    }
    tiles_j = (D + (1 << lj) - 1) >> lj;
    if ((int)blockIdx.x >= ((D + (1 << li) - 1) >> li) * tiles_j) return;
  }
  const int ti = blockIdx.x / tiles_j;
"""
_DEPTH_GRID = """  int l_depth = 0;
  while ((1 << l_depth) < D && l_depth < l_rows) ++l_depth;
  const int sq = ((D + (1 << li) - 1) >> li) * tiles_j;
  const int tall = ((D + (1 << l_depth) - 1) >> l_depth) *
                   ((D + (1 << (l_rows - l_depth)) - 1) >> (l_rows - l_depth));
  dim3 grid(sq > tall ? sq : tall, B);
"""
_KEEP = """// (variant) tap loads that ask L2 to keep the image lines (evict last)
__device__ __forceinline__ uint64_t keep_policy() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  return p;
}
__device__ __forceinline__ float4 ld_keep(const float4* a) {
  float4 r;
  asm("ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
      : "=f"(r.x), "=f"(r.y), "=f"(r.z), "=f"(r.w)
      : "l"(a), "l"(keep_policy()));
  return r;
}
__device__ __forceinline__ uint2 ld_keep(const uint2* a) {
  uint2 r;
  asm("ld.global.nc.L2::cache_hint.v2.u32 {%0, %1}, [%2], %3;"
      : "=r"(r.x), "=r"(r.y)
      : "l"(a), "l"(keep_policy()));
  return r;
}
__device__ __forceinline__ int ld_keep(const int* a) {
  int r;
  asm("ld.global.nc.L2::cache_hint.u32 %0, [%1], %2;"
      : "=r"(r)
      : "l"(a), "l"(keep_policy()));
  return r;
}

"""
# an RGBx pixel of 2 or 1 bytes a channel: the two taps of an image row
# as one 16- or 8-byte load where the pair is aligned, else two loads
_PAIR_FUNC = """template <typename T>
__device__ __forceinline__ void fetch_pair(const T* __restrict__ img, int pix,
                                           int step, val_t<T> (&a)[3],
                                           val_t<T> (&b)[3]) {
  if (step == 1 && (pix & 1) == 0) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      const uint4 p = __ldg(reinterpret_cast<const uint4*>(img) + pix / 2);
      a[0] = __uint_as_float(p.x << 16);
      a[1] = __uint_as_float(p.x & 0xffff0000u);
      a[2] = __uint_as_float(p.y << 16);
      b[0] = __uint_as_float(p.z << 16);
      b[1] = __uint_as_float(p.z & 0xffff0000u);
      b[2] = __uint_as_float(p.w << 16);
    } else {
      const int2 p = __ldg(reinterpret_cast<const int2*>(img) + pix / 2);
      a[0] = (p.x << 24) >> 24;
      a[1] = (p.x << 16) >> 24;
      a[2] = (p.x << 8) >> 24;
      b[0] = (p.y << 24) >> 24;
      b[1] = (p.y << 16) >> 24;
      b[2] = (p.y << 8) >> 24;
    }
  } else {
    fetch<T>(img, pix, a);
    fetch<T>(img, pix + step, b);
  }
}

"""
_PAIRS = """  if constexpr (sizeof(T) <= 2) {
    fetch_pair<T>(img, v0i * W + u0i, u1i - u0i, c00, c01);
    fetch_pair<T>(img, v1i * W + u0i, u1i - u0i, c10, c11);
  } else {
""" + _FETCHES + "  }\n"
# the block's image window in shared memory: the taps read it where they
# fall inside it, the image elsewhere (so the output is exact whatever the
# window); the window is the bounding box of the block's eight corner
# voxels' projections with a margin of 2 pixels, and is left out where a
# corner lies behind the camera or the window is larger than FOOT bytes
_FOOT_FUNCS = """constexpr int FOOT = 32 * 1024;

template <typename T>
__device__ __forceinline__ void fetch_any(const T* img, int pix,
                                          val_t<T> (&c)[3]) {
  if constexpr (std::is_same<T, float>::value) {
    const float4 p = reinterpret_cast<const float4*>(img)[pix];
    c[0] = p.x;
    c[1] = p.y;
    c[2] = p.z;
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const uint2 p = reinterpret_cast<const uint2*>(img)[pix];
    c[0] = __uint_as_float(p.x << 16);
    c[1] = __uint_as_float(p.x & 0xffff0000u);
    c[2] = __uint_as_float(p.y << 16);
  } else {
    const int p = reinterpret_cast<const int*>(img)[pix];
    c[0] = (p << 24) >> 24;
    c[1] = (p << 16) >> 24;
    c[2] = (p << 8) >> 24;
  }
}

template <typename T>
__device__ __forceinline__ void sample_win(const T* __restrict__ img, int H,
                                           int W, float u, float v,
                                           float (&out)[3], const T* foot,
                                           bool use, int u_lo, int v_lo,
                                           int u_hi, int v_hi, int ww) {
  const float u0 = floorf(u);
  const float v0 = floorf(v);
  const float du = u - u0;
  const float dv = v - v0;
  const int u0i = (int)u0;
  const int v0i = (int)v0;
  const int u1i = min(u0i + 1, W - 1);
  const int v1i = min(v0i + 1, H - 1);
  auto px = [&](int vi, int ui, val_t<T> (&c)[3]) {
    if (use && ui >= u_lo && ui <= u_hi && vi >= v_lo && vi <= v_hi)
      fetch_any<T>(foot, (vi - v_lo) * ww + (ui - u_lo), c);
    else
      fetch_any<T>(img, vi * W + ui, c);
  };
  val_t<T> c00[3], c01[3], c10[3], c11[3];
  px(v0i, u0i, c00);
  px(v0i, u1i, c01);
  px(v1i, u0i, c10);
  px(v1i, u1i, c11);
  if constexpr (std::is_same<T, int8_t>::value) {
    const int hv0 = (int)rintf((1.f - dv) * 127.f);
    const int hv1 = (int)rintf(dv * 127.f);
    const float deq = (float)(1.0 / (127.0 * 127.0));
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float left = (float)(c00[ch] * hv0 + c10[ch] * hv1);
      const float right = (float)(c01[ch] * hv0 + c11[ch] * hv1);
      out[ch] = left * deq * (1.f - du) + right * deq * du;
    }
  } else {
    const float w00 = (1.f - dv) * (1.f - du);
    const float w01 = (1.f - dv) * du;
    const float w10 = dv * (1.f - du);
    const float w11 = dv * du;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      out[ch] = c00[ch] * w00 + c01[ch] * w01 + c10[ch] * w10 + c11[ch] * w11;
  }
}

"""
_FOOT_SETUP = """  __shared__ __align__(16) unsigned char foot_bytes[FOOT];
  __shared__ int win[5];
  if (threadIdx.x == 0) {
    win[0] = W;
    win[1] = H;
    win[2] = -1;
    win[3] = -1;
    win[4] = 0;
  }
  __syncthreads();
  if (threadIdx.x < 8) {
    // the block box's corner voxels
    const int c = threadIdx.x;
    const int ci = min((ti << li) + ((c & 1) ? (1 << li) - 1 : 0), D - 1);
    const int cj = min((tj << lj) + ((c & 2) ? (1 << lj) - 1 : 0), D - 1);
    const int ck = (c & 4) ? D - 1 : 0;
    const float cx = ox + ((float)ci + 0.5f) * s;
    const float cy = oy + ((float)cj + 0.5f) * s;
    const float cz = oz + ((float)ck + 0.5f) * s;
    const float cnu = P[0] * cx + P[1] * cy + P[2] * cz + P[3];
    const float cnv = P[4] * cx + P[5] * cy + P[6] * cz + P[7];
    const float cden = P[8] * cx + P[9] * cy + P[10] * cz + P[11];
    if (!(cden > 0.f)) {
      atomicOr(&win[4], 1);
    } else {
      const float cu = fminf(fmaxf(cnu / cden, -8.f), (float)W + 8.f);
      const float cv = fminf(fmaxf(cnv / cden, -8.f), (float)H + 8.f);
      atomicMin(&win[0], (int)floorf(cu) - 2);
      atomicMin(&win[1], (int)floorf(cv) - 2);
      atomicMax(&win[2], (int)floorf(cu) + 3);
      atomicMax(&win[3], (int)floorf(cv) + 3);
    }
  }
  __syncthreads();
  const int u_lo = max(win[0], 0), v_lo = max(win[1], 0);
  const int u_hi = min(win[2], W - 1), v_hi = min(win[3], H - 1);
  const int ww = u_hi - u_lo + 1, wh = v_hi - v_lo + 1;
  const bool use = !win[4] && ww > 0 && wh > 0 &&
                   ww * wh * C * (int)sizeof(T) <= FOOT;
  T* foot = reinterpret_cast<T*>(foot_bytes);
  if (use) {
    const int row_elems = ww * C;
    for (int r = threadIdx.x / 32; r < wh; r += blockDim.x / 32)
      for (int e = threadIdx.x % 32; e < row_elems; e += 32)
        foot[r * row_elems + e] = img[((size_t)(v_lo + r) * W + u_lo) * C + e];
  }
  __syncthreads();
  if (!active) return;
"""
_SAMPLE_WIN = ("      if (ok[t]) sample_win<T>(img, H, W, u, v, rgb[t], foot, "
               "use, u_lo, v_lo, u_hi, v_hi, ww);\n")
_NO_STORES = [
    (_STAGE_STORE, "        if (s == -7.f) " + _STAGE_STORE.lstrip()),
    (_WORD, "        if (s == -7.f) " + _WORD.lstrip()),
    (_SCALAR_FOR, "  for (int t = 0; t < n && s == -7.f; ++t) {\n")]


# the first design's three-channel images: three loads a tap
_FETCH_RGB = """// (variant) channels 0-2 of pixel `pix` of a three-channel image
template <typename T>
__device__ __forceinline__ void fetch(const T* __restrict__ img, int pix,
                                      val_t<T> (&c)[3]) {
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value)
      c[ch] = __bfloat162float(img[3 * pix + ch]);
    else
      c[ch] = img[3 * pix + ch];
  }
}

"""
_RGB = [("constexpr int C = 4; ", "constexpr int C = 3; "),
        cut(_FETCH_DOC, _SAMPLE_DOC, _FETCH_RGB)]


def row_bits(a):
    """A warp's lanes on 2^a rows of the patch (the shipped source: 16)."""
    return [(_ROW_BITS, f"constexpr int ROW_BITS = {a};")]


# name -> steps applied to the shipped source in order: (old, new), or a
# function of the text
VARIANTS = {
    "shipped": [],
    # three-channel images (V, H, W, 3)
    "rgb_images": _RGB,
    "kr1": [(_KR, "constexpr int KR = 1;")],
    "kr2": [(_KR, "constexpr int KR = 2;")],
    "kr8": [(_KR, "constexpr int KR = 8;")],
    # a warp's lanes along one row's runs (2 rows x 16 runs at D 64), with
    # the stores staged or by each lane (the first design), or on 4 or
    # 8 rows
    "lanes_on_k": row_bits(0),
    "lanes_on_k_direct_stores": row_bits(0) + [_DIRECT_STEP],
    "lanes_4_rows": row_bits(2),
    "lanes_8_rows": row_bits(3),
    # each lane stores its own run (16-byte stores that fill half sectors)
    "direct_stores": [_DIRECT_STEP],
    # the block's output staged whole and stored after a barrier
    "block_staged": [_BLOCK_STEP],
    # a strip of rows along j (1 x 16 at D 64) instead of a square patch
    "strip_1x16": [(_PATCH, "  const int li = 0, lj = l_rows;\n")],
    # the patch long along the item's depth axis (16 x 1 or 1 x 16 at D
    # 64) where that is i or j
    "depth_patches": [(_KERNEL_DOC, _DEPTH_AXIS + _KERNEL_DOC),
                      (_DECODE, _DEPTH_DECODE), (_GRID, _DEPTH_GRID)],
    # stores that L2 evicts first (st.global.cs)
    "evict_first_stores": [(_STAGE_STORE,
                            "        __stcs(reinterpret_cast<float4*>(colors "
                            "+ 3 * oo) + c % NQ, st[c]);\n")],
    # every voxel sampled at its coordinates clamped into the image, the
    # invalid ones zeroed after: no branch around the loads
    "branchless_taps": [(_SAMPLE, """\
      sample<T>(img, H, W, fminf(fmaxf(u, 0.f), (float)(W - 1)),
                   fminf(fmaxf(v, 0.f), (float)(H - 1)), rgb[t]);
      if (!ok[t]) rgb[t][0] = rgb[t][1] = rgb[t][2] = 0.f;
""")],
    # blocks of 512 threads (a 4 x 8 patch of rows at D 64)
    "threads_512": [("constexpr int THREADS = 256;",
                     "constexpr int THREADS = 512;")],
    "evict_last_taps": [
        (_FETCH_DOC, _KEEP + _FETCH_DOC),
        ("__ldg(reinterpret_cast<const float4*>(img) + pix)",
         "ld_keep(reinterpret_cast<const float4*>(img) + pix)"),
        ("__ldg(reinterpret_cast<const uint2*>(img) + pix)",
         "ld_keep(reinterpret_cast<const uint2*>(img) + pix)"),
        ("__ldg(reinterpret_cast<const int*>(img) + pix)",
         "ld_keep(reinterpret_cast<const int*>(img) + pix)")],
    "pair_loads": [(_SAMPLE_DOC, _PAIR_FUNC + _SAMPLE_DOC),
                   (_FETCHES, _PAIRS)],
    # registers capped for 6 or 8 blocks (1536 or 2048 threads) an SM
    "six_blocks": [(_BOUNDS, "__global__ void __launch_bounds__(THREADS, 6)\n")],
    "eight_blocks": [(_BOUNDS, "__global__ void __launch_bounds__(THREADS, 8)\n")],
    "smem_footprint": [(_KERNEL_DOC, _FOOT_FUNCS + _KERNEL_DOC),
                       (_EXIT, "  const bool active = i < D && j < D && "
                               "k0 < D;\n"),
                       (_IMG, _IMG + _FOOT_SETUP),
                       (_SAMPLE, _SAMPLE_WIN)],
}
# each leaves out one part of the work: timed only, never checked
DIAGNOSTICS = {
    "diag_no_stores": _NO_STORES,
    "diag_lanes_on_k_no_stores": row_bits(0) + _NO_STORES,
    "diag_no_taps": [(_SAMPLE, "      if (ok[t]) rgb[t][0] = u + v;\n")],
    # every tap in the first 8 pixels of its image row: one cache line a
    # warp instruction, the same number of loads
    "diag_one_line": [(_FETCHES, _FETCHES.replace("u0i, c", "(u0i & 7), c")
                       .replace("u1i, c", "(u1i & 7), c"))],
    # one tap a voxel instead of four
    "diag_one_tap": [(_FETCHES, _FETCHES.splitlines(True)[0] + """\
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) c01[ch] = c10[ch] = c11[ch] = c00[ch];
""")],
    "diag_fast_div": [(_DIV, "      const float u = __fdividef(nu, d);\n"
                             "      const float v = __fdividef(nv, d);\n")],
}
CHECK_D = (16, 17, 32, 64)


def build(tmp):
    """{name: library} of every variant that builds; logs ptxas; raises
    if the shipped source does not build."""
    src = open(os.path.join(_build.SRC_DIR, "warp_gather.cu")).read()
    procs = {}
    for name, steps in {**VARIANTS, **DIAGNOSTICS}.items():
        text = src
        for step in steps:
            if callable(step):
                text = step(text)
                continue
            old, new = step
            if old not in text:
                raise RuntimeError(f"variant {name}: source text not found")
            text = text.replace(old, new)
        path = os.path.join(tmp, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.FLAGS, "-o", path[:-3] + ".so", path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  ptxas {name}: {line.strip()}")
        if proc.returncode:
            if name == "shipped":
                raise RuntimeError(f"the shipped source did not build:\n{out}")
            print(f"variant {name} did not build: left out\n{out}")
            continue
        libs[name] = ctypes.CDLL(os.path.join(tmp, f"{name}.so"))
    return libs


def run(lib, images, Ps, views, origins, D, s):
    """The wrapper's call (ops/cuda/warp_gather.py) on a variant."""
    fn = getattr(lib, _ENTRY[images.dtype])
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    B = views.shape[0]
    H, W = images.shape[1:3]
    colors = torch.empty((B, D, D, D, 3), dtype=torch.float32,
                         device=images.device)
    valid = torch.empty((B, D, D, D), dtype=torch.bool, device=images.device)
    err = fn(images.data_ptr(), Ps.data_ptr(), views.data_ptr(),
             origins.data_ptr(), colors.data_ptr(), valid.data_ptr(), H, W, B,
             D, float(s), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return colors, valid


def layouts(base, dtype):
    """The gather's images in ``dtype``: the sweep's RGBx copy
    (``gather_images``) and its three channels."""
    rgbx = gather_images(base, dtype)
    return rgbx, rgbx[..., :3].contiguous()


def images_for(name, rgbx, rgb):
    """The layout variant ``name`` reads."""
    return rgb if name == "rgb_images" else rgbx


def check(libs, dev):
    scene = make_sphere_scene(n_views=4, hw=(96, 128))
    g = torch.Generator().manual_seed(0)
    Ps = torch.as_tensor(scene.Ps, dtype=torch.float32, device=dev)
    base = torch.as_tensor(scene.images, device=dev)
    for D in CHECK_D:
        views = torch.randint(0, 4, (5,), generator=g).to(dev, torch.int32)
        origins = (torch.rand((5, 3), generator=g) * 40 - 40).to(dev)
        s = 48.0 / D
        for dtype in (torch.bfloat16, torch.float32, torch.int8):
            rgbx, rgb = layouts(base, dtype)
            cp, vp = build_cvc_views(rgb, Ps, views, origins, D, s)
            for name, lib in libs.items():
                images = images_for(name, rgbx, rgb)
                ck, vk = run(lib, images, Ps, views, origins, D, s)
                ck2, vk2 = run(lib, images, Ps, views, origins, D, s)
                agree = (vk == vp).float().mean().item()
                both = vk & vp
                err = (ck - cp).abs()[both].max().item()
                ok = (agree >= 0.9999 and err <= 1e-3
                      and bool((ck[~vk] == 0).all())
                      and torch.equal(ck, ck2) and torch.equal(vk, vk2))
                if dtype == torch.int8:
                    ok = ok and torch.equal(ck, cp) and torch.equal(vk, vp)
                if not ok:
                    raise RuntimeError(
                        f"variant {name} disagrees at D {D}, {dtype}, "
                        f"{images.shape[-1]} channels: validity {agree}, "
                        f"colour {err}")


def smoke_items(dev, n_items):
    """The smoke scene's first batch of (cube, distinct view) items."""
    cfg = baseline_config("dtu9_full")
    D, s = cfg.voxel.cube_size, cfg.voxel.voxel_size_mm
    scene = make_sphere_scene(n_views=12, hw=(600, 800), radius=30.0,
                              focal=1000.0)
    plan = plan_sweep(scene.Ps, scene.bbox_min, scene.bbox_max,
                      scene.images.shape[1:3], cfg, dev)
    batch = plan.batch(slice(0, cfg.sweep.cube_batch), dev)
    origins, uniq = batch[0], batch[3]
    views = torch.where(uniq >= 0, uniq, uniq[:, :1].clamp(min=0))
    views = views.reshape(-1)[:n_items].contiguous()
    vorig = origins.repeat_interleave(uniq.shape[1], dim=0)[:n_items]
    Ps = torch.as_tensor(scene.Ps, dtype=torch.float32, device=dev)
    return scene, Ps, views, vorig.contiguous(), D, s


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--items", type=int, default=168,
                    help="(cube, view) items a call (168: the smoke scene's "
                         "first batch)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(tmp)
        check({name: lib for name, lib in libs.items() if name in VARIANTS},
              dev)
        print(f"all {sum(n in VARIANTS for n in libs)} variants built agree "
              f"with build_cvc_views at D {CHECK_D}, three entries",
              flush=True)
        scene, Ps, views, vorig, D, s = smoke_items(dev, args.items)
        n_items = views.shape[0]
        H, W = scene.images.shape[1:3]
        P = Ps[views.long()]
        r = (torch.arange(D, dtype=torch.float32, device=dev) + 0.5) * s
        nu, nv, den = project_rows(
            P.reshape(n_items, 1, 1, 3, 4),
            vorig[:, 0, None, None, None] + r[None, :, None, None],
            vorig[:, 1, None, None, None] + r[None, None, :, None],
            vorig[:, 2, None, None, None] + r[None, None, None, :])
        n_pixels = footprint_pixels(nu, nv, den, views, H, W)
        den = den + 1e-8
        grid = torch.stack([nu / den / (W - 1) * 2 - 1,
                            nv / den / (H - 1) * 2 - 1], dim=-1)
        grid = grid.reshape(n_items, -1, 1, 2)
        del nu, nv, den
        base = torch.as_tensor(scene.images, device=dev)
        for dtype in (torch.bfloat16, torch.int8, torch.float32):
            rgbx, three = layouts(base, dtype)
            calls = {}
            for name, lib in libs.items():
                calls[name] = (
                    lambda lib=lib, images=images_for(name, rgbx, three):
                    run(lib, images, Ps, views, vorig, D, s))
            if dtype == torch.float32:
                imgs_items = three.permute(0, 3, 1, 2)[views.long()]
                calls["grid_sample"] = lambda: F.grid_sample(
                    imgs_items, grid, mode="bilinear", padding_mode="zeros",
                    align_corners=True)
            times = {name: [] for name in calls}
            for name in [*calls, *reversed(calls)]:
                times[name].append(cuda_ms(calls[name], iters=10))
            ms = {name: sum(t) / len(t) for name, t in times.items()}
            _, valid = run(libs["shipped"], rgbx, Ps, views, vorig, D, s)
            n_valid = int(valid.sum().item())
            del valid
            out_bytes = n_items * D**3 * 13
            in_bytes = n_pixels * 3 * three.element_size()
            ops_valid = (GATHER_INT8_OPS_VALID if dtype == torch.int8
                         else GATHER_OPS_VALID)
            b_ms, b_by = bound(out_bytes + in_bytes,
                               n_items * D**3 * GATHER_OPS_ALL
                               + n_valid * ops_valid)
            plain = cuda_ms(lambda: build_cvc_views(three, Ps, views, vorig,
                                                    D, s), iters=2, warmup=1)
            print(json.dumps({
                "dtype": str(dtype).split(".")[-1], "items": n_items, "D": D,
                "ms": ms, "bound_ms": b_ms, "bound_by": b_by,
                "bound_share": {n: b_ms / t for n, t in ms.items()},
                "plain_ms": plain, "footprint_pixels": n_pixels,
                "valid_share": n_valid / (n_items * D**3)}), flush=True)
            if dtype == torch.float32:
                del imgs_items
            del rgbx, three, calls
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
