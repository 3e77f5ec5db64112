// Warp gather: colored-voxel-cube construction for (cube, view) items.
//
// Replaces the Pallas TPU kernel surfacenet_tpu/ops/pallas/warp_gather.py
// ::_warp_kernel, its int8 mode (:148-175) and its 1-D-grid twin
// _warp_kernel_fused, reached from pipeline/sweep.py through
// warp_gather_tiled.  Plain PyTorch version:
// surfacenet_tpu_torch/ops/cvc.py::build_cvc_views; wrapper:
// surfacenet_tpu_torch/ops/cuda/warp_gather.py.
//
// Computes, for item b and flat voxel q = (i*D + j)*D + k:
//   x = origins[b] + s * ([i, j, k] + 0.5)
//   (nu, nv, den) = P[view_idx[b]] @ [x, 1]      (rows summed left to right)
//   u = nu / (den + 1e-8),  v = nv / (den + 1e-8)  (true division)
//   valid = den > 0 && 0 <= u <= W-1 && 0 <= v <= H-1
//   colors = valid ? bilinear(images[view], u, v) : 0   (f32 interpolation)
//
// int8 entry (the reference kernel's int8 mode): images hold
// q = round_half_even(x * 127).  The vertical hat weights are rounded to 7
// bits, hv0 = rint((1 - dv) * 127), hv1 = rint(dv * 127); per column the
// int32 sum q[v0] * hv0 + q[v1] * hv1 is exact, is converted to float32 and
// scaled by (float)(1/127^2); the two columns are combined with the
// float32 weights 1 - du and du.  Same validity, same output.
//
// Images are RGBx (V, H, W, 4), the sweep's copy
// (pipeline/sweep.py::gather_images), whose fourth channel is never read,
// so that one aligned load (16, 8 or 4 bytes for float32, bf16, int8)
// fetches a pixel.  The wrapper copies three-channel images to RGBx.
//
// Bound on an H100: device-memory bytes.  Per voxel it writes 12 B of
// colour and 1 B of validity and does ~60 float32 operations, below the
// card's ~20 operations per byte break-even in float32; the bound is the
// output's 13 B a voxel plus three channels of the distinct pixels the
// taps read, over 3.35 TB/s (0.176 ms for 168 items of 64^3 on the smoke
// scene).  The images (one copy per sweep, 46 MB in bf16 for 12 views of
// 600x800) are read through L2.
//
// Design for Hopper:
// - A thread owns a run of KR = 4 consecutive voxels along k, the fastest
//   axis.  i, j and each projection row's partial sum P[r,0]*fx + P[r,1]*fy
//   are formed once a run (the same float the per-voxel expression forms
//   first, so each row stays bitwise equal); no integer division per
//   voxel, and four independent chains of tap loads in flight.
// - A block covers all of k times a square patch of (i, j) rows (4 x 4 at
//   D = 64).  A warp's lanes spread over 16 rows of the patch (2 runs each
//   at D = 64) rather than along one row: at a step of the run their taps
//   lie within a few pixels of each other in the image, where a row's runs
//   lie a run's projection apart.
// - Stores: each warp stages its runs' colours in shared memory in the
//   output's order (a row's two runs, 96 bytes, side by side) and writes
//   them 16 bytes a lane, so every store fills whole 32-byte sectors; the
//   validity of a run is one 4-byte word.  Where D is not 4 times a power
//   of two, voxel by voxel.
// - One load a tap from the RGBx copy: 4 a voxel instead of 12.
// - Exact IEEE division and --fmad=false (the build's flags): validity at
//   the image border and the int8 entry's bitwise match depend on them.
// What bounds it (scripts/torch_gather_variants.py on an H100, 168 items
// of 64^3, bf16): no single part.  The kernel takes ~0.365 ms (bound
// 0.176); without its stores ~0.31, without its taps ~0.23, with every
// tap in one cache line ~0.34, with one tap a voxel ~0.33, with
// approximate divisions ~0.35.  Lanes along a row's runs (the first
// design, ~0.44), per-lane stores, a block-wide staging barrier, cache
// hints, pixel-pair loads, branch-free taps, other patches, KR 1, 2 or 8,
// other occupancies and the block's image window in shared memory all
// ran no faster.
// The TPU kernel's workarounds are not carried over: no hat-matrix matmul
// (the card gathers the four neighbours directly), no crop or chunk
// windows (validity has no window term, which is the XLA oracle's rule),
// no sub-cube tiling, and no reciprocal-plus-Newton step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

constexpr int THREADS = 256;
constexpr int KR = 4;        // voxels a thread, consecutive along k
constexpr int ROW_BITS = 4;  // a warp's lanes: 2^ROW_BITS rows x runs
constexpr int C = 4;         // channels a pixel: RGBx
static_assert(ROW_BITS <= 5, "a warp spans at most 32 rows");

// a tap's value type: exact integers for int8, float32 otherwise
template <typename T>
using val_t = typename std::conditional<std::is_same<T, int8_t>::value, int,
                                        float>::type;

// channels 0-2 of pixel `pix` (row-major within one view's image)
template <typename T>
__device__ __forceinline__ void fetch(const T* __restrict__ img, int pix,
                                      val_t<T> (&c)[3]) {
  if constexpr (std::is_same<T, float>::value) {
    const float4 p = __ldg(reinterpret_cast<const float4*>(img) + pix);
    c[0] = p.x;
    c[1] = p.y;
    c[2] = p.z;
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const uint2 p = __ldg(reinterpret_cast<const uint2*>(img) + pix);
    c[0] = __uint_as_float(p.x << 16);
    c[1] = __uint_as_float(p.x & 0xffff0000u);
    c[2] = __uint_as_float(p.y << 16);
  } else {  // int8
    const int p = __ldg(reinterpret_cast<const int*>(img) + pix);
    c[0] = (p << 24) >> 24;
    c[1] = (p << 16) >> 24;
    c[2] = (p << 8) >> 24;
  }
}

// bilinear colour at (u, v), inside the image
template <typename T>
__device__ __forceinline__ void sample(const T* __restrict__ img, int H,
                                       int W, float u, float v,
                                       float (&out)[3]) {
  const float u0 = floorf(u);
  const float v0 = floorf(v);
  const float du = u - u0;
  const float dv = v - v0;
  const int u0i = (int)u0;
  const int v0i = (int)v0;
  const int u1i = min(u0i + 1, W - 1);
  const int v1i = min(v0i + 1, H - 1);
  val_t<T> c00[3], c01[3], c10[3], c11[3];
  fetch<T>(img, v0i * W + u0i, c00);
  fetch<T>(img, v0i * W + u1i, c01);
  fetch<T>(img, v1i * W + u0i, c10);
  fetch<T>(img, v1i * W + u1i, c11);
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

// grid (tiles of an item, items); block: THREADS threads covering all of
// k (2^lr runs of KR voxels) times a patch of 2^li x 2^lj rows (i, j), in
// row-major order.  The low a = min(ROW_BITS, li + lj) bits of a thread's
// index pick its row, the next lr bits its run: a warp's lanes spread over
// the patch (16 rows x 2 runs at D = 64), whose taps lie closer together
// in the image than a row's runs do.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    warp_gather_kernel(const T* __restrict__ images,
                       const float* __restrict__ Ps,
                       const int32_t* __restrict__ view_idx,
                       const float* __restrict__ origins,
                       float* __restrict__ colors,
                       uint8_t* __restrict__ valid, int H, int W, int D,
                       float s, int lr, int li, int lj, int tiles_j) {
  const int b = blockIdx.y;
  const int ti = blockIdx.x / tiles_j;
  const int tj = blockIdx.x - ti * tiles_j;
  const int a = min(ROW_BITS, li + lj);
  const int row =
      ((threadIdx.x >> (a + lr)) << a) | (threadIdx.x & ((1 << a) - 1));
  const int i = (ti << li) + (row >> lj);
  const int j = (tj << lj) + (row & ((1 << lj) - 1));
  const int k0 = ((threadIdx.x >> a) & ((1 << lr) - 1)) * KR;
  if (i >= D || j >= D || k0 >= D) return;

  const int view = view_idx[b];
  const float* P = Ps + 12 * view;
  const float ox = origins[3 * b + 0];
  const float oy = origins[3 * b + 1];
  const float oz = origins[3 * b + 2];
  const T* img = images + (size_t)view * H * W * C;
  const float fx = ox + ((float)i + 0.5f) * s;
  const float fy = oy + ((float)j + 0.5f) * s;
  // each row's first two products and their sum, shared by the run
  const float pu = P[0] * fx + P[1] * fy;
  const float pv = P[4] * fx + P[5] * fy;
  const float pd = P[8] * fx + P[9] * fy;
  const int n = min(KR, D - k0);

  float rgb[KR][3];
  bool ok[KR];
#pragma unroll
  for (int t = 0; t < KR; ++t) {
    rgb[t][0] = rgb[t][1] = rgb[t][2] = 0.f;
    ok[t] = false;
    if (t < n) {
      const float fz = oz + ((float)(k0 + t) + 0.5f) * s;
      const float nu = pu + P[2] * fz + P[3];
      const float nv = pv + P[6] * fz + P[7];
      const float den = pd + P[10] * fz + P[11];
      const float d = den + 1e-8f;
      const float u = nu / d;
      const float v = nv / d;
      ok[t] = (u >= 0.f) && (u <= (float)(W - 1)) && (v >= 0.f) &&
              (v <= (float)(H - 1)) && (den > 0.f);
      if (ok[t]) sample<T>(img, H, W, u, v, rgb[t]);
    }
  }

  const size_t o = (size_t)b * D * D * D + ((size_t)i * D + j) * D + k0;
  if constexpr (KR % 4 == 0) {
    if ((1 << lr) * KR == D && D % (1 << li) == 0 && D % (1 << lj) == 0) {
      // every thread of the launch is in the volume and its run whole and
      // 16-byte aligned: the warp stages its runs' colours in shared
      // memory in the output's order (a row's runs side by side), then
      // stores them 16 bytes a lane, each run's address shuffled from its
      // lane, so that the stores fill whole 32-byte sectors
      constexpr int NQ = 3 * KR / 4;  // 16-byte pieces a run
      __shared__ float4 stage[THREADS / 32][32 * NQ];
      const int lane = threadIdx.x & 31;
      const int rw = 32 >> a;  // runs of a row in a warp
      float4* st = stage[threadIdx.x >> 5];
      const int slot = (lane & ((1 << a) - 1)) * rw + (lane >> a);
#pragma unroll
      for (int m = 0; m < NQ; ++m)
        st[slot * NQ + m] = make_float4(rgb[(4 * m) / 3][(4 * m) % 3],
                                        rgb[(4 * m + 1) / 3][(4 * m + 1) % 3],
                                        rgb[(4 * m + 2) / 3][(4 * m + 2) % 3],
                                        rgb[(4 * m + 3) / 3][(4 * m + 3) % 3]);
      __syncwarp();
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int c = q * 32 + lane;
        const int sl = c / NQ;
        const int owner = ((sl % rw) << a) | (sl / rw);
        const unsigned long long oo =
            __shfl_sync(0xffffffffu, (unsigned long long)o, owner);
        reinterpret_cast<float4*>(colors + 3 * oo)[c % NQ] = st[c];
      }
#pragma unroll
      for (int m = 0; m < KR / 4; ++m)
        reinterpret_cast<uint32_t*>(valid + o)[m] =
            (uint32_t)ok[4 * m] | (uint32_t)ok[4 * m + 1] << 8 |
            (uint32_t)ok[4 * m + 2] << 16 | (uint32_t)ok[4 * m + 3] << 24;
      return;
    }
  }
  for (int t = 0; t < n; ++t) {
    colors[3 * (o + t) + 0] = rgb[t][0];
    colors[3 * (o + t) + 1] = rgb[t][1];
    colors[3 * (o + t) + 2] = rgb[t][2];
    valid[o + t] = ok[t] ? 1 : 0;
  }
}

static int log2_ceil(int x) {
  int l = 0;
  while ((1 << l) < x) ++l;
  return l;
}

template <typename T>
static int launch(const void* images, const void* Ps, const void* view_idx,
                  const void* origins, void* colors, void* valid, int H,
                  int W, int B, int D, float s, void* stream) {
  if (B <= 0) return 0;
  const int lr = log2_ceil((D + KR - 1) / KR);
  const int l_rows = log2_ceil(THREADS) - lr;  // 2^l_rows rows a block
  if (l_rows < 0) return (int)cudaErrorInvalidValue;  // D above 256 * KR
  const int li = l_rows / 2, lj = l_rows - li;
  const int tiles_j = (D + (1 << lj) - 1) >> lj;
  dim3 grid(((D + (1 << li) - 1) >> li) * tiles_j, B);
  warp_gather_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)images, (const float*)Ps, (const int32_t*)view_idx,
      (const float*)origins, (float*)colors, (uint8_t*)valid, H, W, D, s,
      lr, li, lj, tiles_j);
  return (int)cudaGetLastError();
}

extern "C" int warp_gather_bf16(const void* images, const void* Ps,
                                const void* view_idx, const void* origins,
                                void* colors, void* valid, int H, int W,
                                int B, int D, float s, void* stream) {
  return launch<__nv_bfloat16>(images, Ps, view_idx, origins, colors, valid,
                               H, W, B, D, s, stream);
}

extern "C" int warp_gather_f32(const void* images, const void* Ps,
                               const void* view_idx, const void* origins,
                               void* colors, void* valid, int H, int W,
                               int B, int D, float s, void* stream) {
  return launch<float>(images, Ps, view_idx, origins, colors, valid, H, W, B,
                       D, s, stream);
}

extern "C" int warp_gather_int8(const void* images, const void* Ps,
                                const void* view_idx, const void* origins,
                                void* colors, void* valid, int H, int W,
                                int B, int D, float s, void* stream) {
  return launch<int8_t>(images, Ps, view_idx, origins, colors, valid, H, W,
                        B, D, s, stream);
}
