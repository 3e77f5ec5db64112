// SAME 3x3x3 conv3d (dilation dil) + float32 bias + optional ReLU, bf16 in
// and out, float32 sums: SurfaceNet's conv + folded BatchNorm + relu as
// one implicit GEMM.
//
// Replaces the Pallas TPU kernel surfacenet_tpu/ops/pallas/conv3d.py::
// _conv3d_kernel (driven by conv3d_pallas / conv3d_fused from
// models/surfacenet.py::fused_infer_apply).  Plain PyTorch version:
// surfacenet_tpu_torch/ops/conv3d.py::conv3d_plain; wrapper:
// surfacenet_tpu_torch/ops/cuda/conv3d.py.
//
// Layouts (the reference's): x (B, R, R, R, Cin) bf16 NDHWC; w (27*Cin,
// Cout) bf16 with rows tap-major, tap (dz, dy, dx) in {-dil, 0, dil}^3 in C
// order, then cin (DHWIO reshaped); bias (Cout,) f32; out (B, R, R, R,
// Cout) bf16.  Cout is a multiple of 8.
//
// The GEMM: M = B*R^3 output voxels, N = Cout, K = 27*Cin.  At the
// dtu9_full point (fast64 widths, 120 items of 64^3 a forward) its seven
// layers are bounded on an H100 (989 TFLOP/s bf16, 3.35 TB/s) by:
//   R 64,   6 ->  32, dil 1:  326 GFLOP, 2.39 GB  0.71 ms (bytes)
//   R 32,  32 -> 128, dil 1:  870 GFLOP, 1.26 GB  0.88 ms (operations)
//   R 32, 128 -> 128, dil 1: 3479 GFLOP, 2.01 GB  3.52 ms (operations)
//   R 16, 128 -> 128, dil 1:  435 GFLOP, 0.25 GB  0.44 ms (operations) x2
//   R 16, 128 -> 256, dil 2:  870 GFLOP, 0.38 GB  0.88 ms (operations)
//   R 16, 256 -> 256, dil 2: 1739 GFLOP, 0.50 GB  1.76 ms (operations)
// so all but the first layer are tensor-core bound.
//
// Design (simple first; wgmma, TMA and a deeper pipeline are later work):
// one block of 256 threads computes a tile of 128 voxels x BN (32, 64 or
// 128) output channels, looping over K in chunks of 32.  For each chunk
// the threads build the im2col A tile (128 x 32) in shared memory straight
// from x: every k decodes into (tap, cin) and the tap into a neighbour
// offset, and a neighbour outside the volume (SAME padding) or k >= K
// reads as zero.  With Cin a multiple of 8 a thread moves 8 channels of
// one tap in one 16-byte load; otherwise (the first layer's Cin = 6) it
// loads scalars.  The B tile (32 x BN) comes from w with 16-byte loads.
// Two shared-memory stages: the next chunk's loads are issued into
// registers before the current chunk's products, so global latency
// overlaps the tensor-core work, with one barrier per chunk.  Eight warps
// (4 along M x 2 along N) multiply with nvcuda::wmma 16x16x16 (bf16 in,
// f32 accumulate).  The epilogue stages each 16x16 accumulator through
// shared memory, adds the bias in f32, applies ReLU, rounds to bf16 (to
// nearest even) and stores 8 channels per 16-byte store, NDHWC.  Blocks
// of neighbouring index take the N tiles of one M tile, so the im2col
// reads of a voxel tile are shared through L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 128;       // output voxels per block
constexpr int BK = 32;        // K chunk
constexpr int THREADS = 256;  // 8 warps: 4 along M x 2 along N
constexpr int LDA = BK + 8;   // A row pitch in bf16 (80 B: 16 B aligned)

struct Geometry {
  const uint16_t* x;  // bf16 bits
  long long M;        // B * R^3
  int R, Cin, K, dil;
};

// 8 consecutive channels (k .. k+7, one tap) of voxel (b, z, y, xx)'s
// neighbour; zero outside the volume or past K.
__device__ __forceinline__ uint4 fetch8(const Geometry& g, const uint16_t* xb,
                                        int z, int y, int xx, int k) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (k >= g.K) return v;
  const int tap = k / g.Cin;
  const int cin = k - tap * g.Cin;
  const int zz = z + (tap / 9 - 1) * g.dil;
  const int yy = y + ((tap / 3) % 3 - 1) * g.dil;
  const int xq = xx + (tap % 3 - 1) * g.dil;
  if (zz < 0 || zz >= g.R || yy < 0 || yy >= g.R || xq < 0 || xq >= g.R)
    return v;
  const size_t off = (((size_t)zz * g.R + yy) * g.R + xq) * g.Cin + cin;
  return *reinterpret_cast<const uint4*>(xb + off);
}

// One channel (k) of the neighbour, as bf16 bits; zero outside or past K.
__device__ __forceinline__ uint32_t fetch1(const Geometry& g,
                                           const uint16_t* xb, int z, int y,
                                           int xx, int k) {
  if (k >= g.K) return 0u;
  const int tap = k / g.Cin;
  const int cin = k - tap * g.Cin;
  const int zz = z + (tap / 9 - 1) * g.dil;
  const int yy = y + ((tap / 3) % 3 - 1) * g.dil;
  const int xq = xx + (tap % 3 - 1) * g.dil;
  if (zz < 0 || zz >= g.R || yy < 0 || yy >= g.R || xq < 0 || xq >= g.R)
    return 0u;
  return xb[(((size_t)zz * g.R + yy) * g.R + xq) * g.Cin + cin];
}

template <int BN, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
    conv3d_kernel(Geometry g, const uint16_t* __restrict__ w,
                  const float* __restrict__ bias, uint16_t* __restrict__ out,
                  int Cout, int relu, int n_tiles) {
  constexpr int LDB = BN + 8;             // B row pitch in bf16
  constexpr int A_ELEMS = BM * LDA;
  constexpr int STAGE = A_ELEMS + BK * LDB;
  constexpr int WN = BN / 2;              // warp tile: 32 x WN
  constexpr int FN = WN / 16;
  constexpr int B_VECS = BK * BN / 8;     // 16-byte vectors per B tile
  constexpr int B_PER_THREAD = (B_VECS + THREADS - 1) / THREADS;
  __shared__ __align__(128) unsigned char smem_raw[2 * STAGE * 2];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int tid = threadIdx.x;
  const int n_tile = blockIdx.x % n_tiles;
  const long long m0 = (long long)(blockIdx.x / n_tiles) * BM;
  const int n0 = n_tile * BN;

  // this thread's im2col row and its 16 k positions [half*16, half*16+16)
  const int row = tid >> 1;
  const int half = tid & 1;
  const long long v = m0 + row;
  const bool row_ok = v < g.M;
  const long long R3 = (long long)g.R * g.R * g.R;
  const long long item = row_ok ? v / R3 : 0;
  const int q = row_ok ? (int)(v - item * R3) : 0;
  const int z = q / (g.R * g.R);
  const int y = (q / g.R) % g.R;
  const int xx = q % g.R;
  const uint16_t* xb = g.x + (size_t)item * R3 * g.Cin;

  uint4 a_reg[2];
  uint4 b_reg[B_PER_THREAD];

  auto load = [&](int k0) {
    const int kb = k0 + half * 16;
    if (!row_ok) {
      a_reg[0] = a_reg[1] = make_uint4(0u, 0u, 0u, 0u);
    } else if (VEC) {
      a_reg[0] = fetch8(g, xb, z, y, xx, kb);
      a_reg[1] = fetch8(g, xb, z, y, xx, kb + 8);
    } else {
      uint32_t p[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        p[e] = fetch1(g, xb, z, y, xx, kb + 2 * e) |
               (fetch1(g, xb, z, y, xx, kb + 2 * e + 1) << 16);
      }
      a_reg[0] = make_uint4(p[0], p[1], p[2], p[3]);
      a_reg[1] = make_uint4(p[4], p[5], p[6], p[7]);
    }
#pragma unroll
    for (int i = 0; i < B_PER_THREAD; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / (BN / 8);
      const int n = n0 + (idx % (BN / 8)) * 8;
      const int k = k0 + r;
      b_reg[i] = (idx < B_VECS && k < g.K && n < Cout)
                     ? *reinterpret_cast<const uint4*>(w + (size_t)k * Cout + n)
                     : make_uint4(0u, 0u, 0u, 0u);
    }
  };

  auto store = [&](int stage) {
    __nv_bfloat16* sA = smem + stage * STAGE;
    __nv_bfloat16* sB = sA + A_ELEMS;
    uint4* a_dst = reinterpret_cast<uint4*>(sA + row * LDA + half * 16);
    a_dst[0] = a_reg[0];
    a_dst[1] = a_reg[1];
#pragma unroll
    for (int i = 0; i < B_PER_THREAD; ++i) {
      const int idx = tid + i * THREADS;
      if (idx < B_VECS) {
        const int r = idx / (BN / 8);
        const int c = (idx % (BN / 8)) * 8;
        *reinterpret_cast<uint4*>(sB + r * LDB + c) = b_reg[i];
      }
    }
  };

  const int warp = tid >> 5;
  const int wm = warp & 3;   // rows wm*32 .. +32 of the block tile
  const int wn = warp >> 2;  // cols wn*WN .. +WN
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][FN];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int n_chunks = (g.K + BK - 1) / BK;
  load(0);
  store(0);
  __syncthreads();
  for (int c = 0; c < n_chunks; ++c) {
    const bool more = c + 1 < n_chunks;
    if (more) load((c + 1) * BK);
    const __nv_bfloat16* sA = smem + (c & 1) * STAGE;
    const __nv_bfloat16* sB = sA + A_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fb[FN];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], sA + (wm * 32 + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(fb[j], sB + kk * LDB + wn * WN + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    if (more) store((c + 1) & 1);
    __syncthreads();
  }

  // epilogue: each warp stages one 16x16 accumulator at a time in its own
  // 1 KB of the (now free) shared memory; lane -> row lane/2, 8 columns
  float* scratch = reinterpret_cast<float*>(smem_raw) + warp * 256;
  const int lane = tid & 31;
  const int er = lane >> 1;
  const int ec = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const long long orow = m0 + wm * 32 + i * 16 + er;
      const int col = n0 + wn * WN + j * 16 + ec;
      if (orow < g.M && col < Cout) {
        uint32_t p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float lo = scratch[er * 16 + ec + 2 * e] + bias[col + 2 * e];
          float hi = scratch[er * 16 + ec + 2 * e + 1] + bias[col + 2 * e + 1];
          if (relu) {
            lo = fmaxf(lo, 0.0f);
            hi = fmaxf(hi, 0.0f);
          }
          __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
          p[e] = *reinterpret_cast<uint32_t*>(&h);
        }
        *reinterpret_cast<uint4*>(out + (size_t)orow * Cout + col) =
            make_uint4(p[0], p[1], p[2], p[3]);
      }
      __syncwarp();
    }
  }
}

template <int BN, bool VEC>
void launch(const Geometry& g, const void* w, const void* bias, void* out,
            int Cout, int relu, cudaStream_t stream) {
  const int n_tiles = (Cout + BN - 1) / BN;
  const long long m_tiles = (g.M + BM - 1) / BM;
  conv3d_kernel<BN, VEC><<<(unsigned)(m_tiles * n_tiles), THREADS, 0,
                           stream>>>(
      g, (const uint16_t*)w, (const float*)bias, (uint16_t*)out, Cout, relu,
      n_tiles);
}

template <int BN>
void launch_bn(const Geometry& g, const void* w, const void* bias, void* out,
               int Cout, int relu, cudaStream_t stream) {
  if (g.Cin % 8 == 0)
    launch<BN, true>(g, w, bias, out, Cout, relu, stream);
  else
    launch<BN, false>(g, w, bias, out, Cout, relu, stream);
}

}  // namespace

extern "C" int conv3d(const void* x, const void* w, const void* bias,
                      void* out, int B, int R, int Cin, int Cout, int dil,
                      int relu, void* stream) {
  Geometry g;
  g.x = (const uint16_t*)x;
  g.M = (long long)B * R * R * R;
  g.R = R;
  g.Cin = Cin;
  g.K = 27 * Cin;
  g.dil = dil;
  if (g.M <= 0 || Cout <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (Cout >= 128)
    launch_bn<128>(g, w, bias, out, Cout, relu, s);
  else if (Cout > 32)
    launch_bn<64>(g, w, bias, out, Cout, relu, s);
  else
    launch_bn<32>(g, w, bias, out, Cout, relu, s);
  return (int)cudaGetLastError();
}
