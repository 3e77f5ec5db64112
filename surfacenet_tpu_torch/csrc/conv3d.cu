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
// Cout) bf16.  Cout is a multiple of 8 and x is 16-byte aligned; the entry
// refuses other shapes (cudaErrorInvalidValue), which the wrapper pads to
// these with zero channels (its route wgmma_padded, below).  The wgmma
// route also takes wt, the wrapper's K-contiguous copy of w, (Cout,
// 27*Cin), 16-byte aligned.
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
// so all but the first layer are tensor-core bound.  So is the widest
// layer at the reference's own paper width (block 3, 120 items of 16^3):
//   R 16, 300 -> 300, dil 2: 2389 GFLOP, 0.60 GB  2.42 ms (operations)
// which the wrapper runs on route 1 at 304 -> 304 (2.48 ms of operations,
// 2.7% more) after padding.  The entry conv3d() dispatches by shape alone
// to one of two routes (a route that fails to launch returns the error;
// nothing falls back to another route):
//   Cin % 8 == 0: route 1, wgmma;
//   1 <= Cin < 8 at dil <= 5, where the halo fits in shared memory: route
//   2, halo_mma.
// The wrapper (ops/cuda/conv3d.py::conv3d_route) sends every other shape
// (Cin > 8 not a multiple of 8, Cout not a multiple of 8, Cin < 8 above
// dil 5, x not 16-byte aligned) to route 1 as
// wgmma_padded: x's channels zero-padded to Cin8 = ceil(Cin / 8) * 8 in a
// new tensor, w to (27 * Cin8, Cout8) and b to Cout8 with zeros, the
// output sliced back to Cout.  Zero channels add exact zeros to the f32
// sums, so the function is the same.  The padding costs two passes over
// memory outside the kernel (x in, the output out); route 1's A pieces are
// 16-byte cp.async copies of 8 channels of one voxel, which a row of Cin
// 300 (600 bytes) or of an odd Cin (2-byte aligned) cannot give.
//
// Route 1, Cin % 8 == 0 (the six tensor-bound layers): wgmma.  One block
// of two warpgroups (256 threads) computes 128 voxels x BN channels,
// looping over K in chunks of 64 (one 128-byte row per voxel or channel);
// warpgroup g owns rows 64g..64g+63.  Ragged M and N are masked in the
// epilogue, ragged K is zero-filled.  Both operands sit in shared memory in
// the 128-byte swizzle (16-byte piece p of row r at p ^ (r & 7)) and feed
// wgmma.mma_async m64nBNk16 (bf16 in, f32 sums in registers) through
// descriptors: K-major, SBO 1024 B per 8 rows, start +32 B per k16 step,
// stages on 1024-byte boundaries.  The tiles are filled with cp.async.cg
// 16-byte copies: a piece of A is 8 channels of one tap of one voxel
// (Cin % 8 == 0), found through a shared-memory table of (neighbour
// offset, tap) per 8-wide k built once a block; each thread keeps a 27-bit
// mask of its voxels' in-volume taps, so SAME padding and the K tail are a
// src_size of 0 (zero fill), not a branch.  Eight threads fill one
// 128-byte row, so a warp reads four whole rows.  B comes from wt,
// K-contiguous so that both operands are K-major: the wrapper transposes w
// per call (at most 3.5 MB, timed with the kernel).  The ring: each chunk
// starts with one barrier, after cp.async.wait_group and fence.proxy.async
// (cp.async writes through the generic proxy, wgmma reads through the
// async proxy); then the stage that chunk c - 2's wgmma read is refilled
// with chunk c + 1, and wgmma runs on chunk c while chunk c - 1's group
// may still be in flight (wgmma.wait_group 1 before the next barrier frees
// its stage).  The epilogue adds the bias in f32, applies ReLU and rounds
// to bf16 (to nearest even) on the accumulator fragments, stages the tile
// in the ring and stores it 16 bytes a thread, whole rows a warp.  Blocks
// of neighbouring index take the N tiles of one M tile, so the im2col
// reads of a voxel tile are shared through L2.
//
// Tile sizes and why (scripts/torch_conv3d_variants.py times the
// alternatives on the card; PERF.md has its numbers):
//   BN 128 for Cout >= 128 (64 accumulators a thread), BN 64 below (narrow
//     layers, the tests' ragged N): the largest tile that leaves two
//     blocks an SM;
//   3 stages, 97 KB of shared memory at BN 128 (116 registers a thread):
//     two blocks share an SM, so one block's barrier waits, prologue and
//     epilogue overlap the other's products.  4 stages (one block an SM)
//     were slower, and a 256-wide N tile for Cout 256 was no faster;
//   the refill issued right after the barrier, before the wgmma: issued
//     after wgmma.wait_group instead, the copies have one wgmma less to
//     land in, and the kernel is slower;
//   cp.async.cg (L2 only) for A: caching the im2col reads in L1 (.ca) was
//     slower;
//   the epilogue staged through shared memory: 4-byte bf16x2 stores
//     straight from the fragments were slower.
//
// Route 2, 1 <= Cin < 8 (the first layer, Cin 6): halo_mma.  The layer is
// bound by bytes, and 2.01 of its 2.39 GB are the output, so the design
// reads each input voxel from device memory about once and stores whole
// rows.  A block (persistent: as many as fit on the card, each walking the
// tiles) owns a tile of 64 voxels along x by 8 x 5 rows (y, z) of one item.
//   - Input: the tile's halo rows, (8 + 2 dil) x (5 + 2 dil) rows of
//     64 + 2 dil voxels, lie contiguous in NDHWC and are copied as they are,
//     16 bytes a lane (cp.async.cg), each into its row's space in the halo;
//     then spread in place, one 16-byte slot a voxel with channels past Cin
//     zero and voxels outside the volume zero, so SAME padding costs no
//     branch later.  A warp spreads 32 voxels a pass, reading before it
//     writes; the raw bytes start far enough into the row's space (raw_at)
//     that no pass overwrites what a later pass reads.  At Cin 6, dil 1: 70
//     rows of 1088 bytes, 74 KB.
//   - Weights: staged once a block (a new chunk of 64 channels when the walk
//     crosses one) as K-major core matrices of 28 taps x 8 channels, tap 27
//     and channels past Cin zero (K = 224 for the real 27 * Cin).
//   - Products: wgmma.mma_async m64n32k16 straight from the halo, no im2col.
//     A tile row's 64 voxels are 8 consecutive no-swizzle core matrices
//     (SBO 128 B); K step k's descriptor starts at tap 2 k's slot offset
//     and reaches tap 2 k + 1 through the LBO (tap 27: 64 zero rows placed
//     after the halo).  Two warpgroups take alternate rows, N 32 a pass.
//   - Epilogue: bias, ReLU and round-to-nearest-even bf16 on the fragments,
//     stmatrix into a warp's swizzled 1 KB staging tile, 16-byte stores: a
//     warp writes 8 whole voxels (512 contiguous bytes at Cout 32) an
//     instruction.
// 98 KB of shared memory and at most 128 registers a thread at Cin 6, Cout
// 32: two blocks an SM, so one block's copies and spreading overlap the
// other's products.  A wider dilation grows the halo; the tile's rows are
// halved until it fits in 227 KB; it fits at every Cin and Cout up to dil
// 5 (MAX_DIL), and a wider dilation is refused (the wrapper sends such a
// shape to wgmma_padded instead).  Choices against their alternatives
// (scripts/torch_conv3d_variants.py, numbers in PERF.md): wgmma over
// mma.sync on ldmatrix fragments of the same halo; 8 x 5 rows over 4 x 4
// and 8 x 4 (more halo a voxel), 8 x 8 (one block an SM) and 8 x 2 with
// three blocks an SM; a persistent grid over one tile a block (every block
// stages the weights); staged 16-byte stores over one cp.async.bulk a warp
// and a transpose by shuffles (both slower; 4-byte stores straight from
// the fragments and evict-first stores were no faster); spreading in
// place, which halves the shared memory that a separate raw buffer takes
// and so fits the larger tile at two blocks an SM.  What
// bounds it now: the wgmma operands come from shared memory (2 KB of A and
// 1 KB of B for each 64 x 32 x 16 product), and a block's copies and
// spreading wait between barriers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// Route 1: Cin % 8 == 0, wgmma fed by a cp.async ring.

namespace wg {

constexpr int BM = 128;          // output voxels per block: 2 warpgroups x 64
constexpr int BK = 64;           // K chunk: one 128-byte swizzle row
constexpr int THREADS = 256;
constexpr int STAGES = 3;        // ring depth (see the header)
constexpr int ROW_BYTES = BK * 2;
constexpr int A_BYTES = BM * ROW_BYTES;
constexpr int ROWS_PER_PASS = THREADS / 8;  // 8 threads fill one row

template <int BN>
__host__ __device__ constexpr int stage_bytes() {
  return A_BYTES + BN * ROW_BYTES;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; reads src_bytes (16 or 0) and zero-fills the rest
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// make this thread's completed generic-proxy writes to shared memory
// visible to the async proxy (wgmma's operand reads)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma's issue and wait
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// shared-memory matrix descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart (SBO); LBO is unused in this mode
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// D (64 x N, f32 in registers) += A (64 x 16) * B (16 x N), both from
// shared memory through descriptors, bf16 in
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
    conv3d_wgmma(const uint16_t* __restrict__ x,
                 const uint16_t* __restrict__ wt,
                 const float* __restrict__ bias, uint16_t* __restrict__ out,
                 long long M, int R, int Cin, int Cout, int dil, int relu,
                 int n_tiles, int n_chunks) {
  constexpr int STAGE = stage_bytes<BN>();
  constexpr int NACC = BN / 2;  // f32 accumulators a thread
  constexpr int A_ROWS = BM / ROWS_PER_PASS;
  constexpr int B_ROWS = BN / ROWS_PER_PASS;
  extern __shared__ unsigned char smem_dyn[];
  // the ring starts on a 1024-byte boundary (the swizzle's period)
  const uint32_t raw = smem_addr(smem_dyn);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  int* table = reinterpret_cast<int*>(smem_dyn + (ring - raw) +
                                      STAGES * STAGE);

  const int tid = threadIdx.x;
  const int K = 27 * Cin;

  // im2col table, one entry per 8-wide k piece: (offset of the neighbour's
  // channel cin relative to the voxel's own channel 0) * 32 + tap; tap 31,
  // which no voxel has, marks the pieces past K
  for (int e = tid; e < n_chunks * 8; e += THREADS) {
    const int k = e * 8;
    int entry = 31;
    if (k < K) {
      const int tap = k / Cin;
      const int cin = k - tap * Cin;
      const int dz = (tap / 9 - 1) * dil;
      const int dy = ((tap / 3) % 3 - 1) * dil;
      const int dx = (tap % 3 - 1) * dil;
      entry = (((dz * R + dy) * R + dx) * Cin + cin) * 32 + tap;
    }
    table[e] = entry;
  }

  const int n_tile = blockIdx.x % n_tiles;
  const long long m0 = (long long)(blockIdx.x / n_tiles) * BM;
  const int n0 = n_tile * BN;

  // this thread fills piece `piece` of rows rbase + 32 i of both tiles
  const int piece = tid & 7;
  const int rbase = tid >> 3;
  const uint32_t swz = (uint32_t)(((piece ^ (rbase & 7)) << 4) +
                                  rbase * ROW_BYTES);

  const uint16_t* a_src[A_ROWS];
  uint32_t a_mask[A_ROWS];  // bit tap: the neighbour lies in the volume
  const long long R3 = (long long)R * R * R;
#pragma unroll
  for (int i = 0; i < A_ROWS; ++i) {
    const long long v = m0 + rbase + i * ROWS_PER_PASS;
    a_mask[i] = 0u;
    a_src[i] = x;
    if (v < M) {
      const long long item = v / R3;
      const int q = (int)(v - item * R3);
      const int z = q / (R * R);
      const int y = (q / R) % R;
      const int xx = q % R;
      // per axis, bit d: the offset (d - 1) * dil stays in the volume
      const uint32_t zm = (z >= dil) | 2u | ((uint32_t)(z + dil < R) << 2);
      const uint32_t ym = (y >= dil) | 2u | ((uint32_t)(y + dil < R) << 2);
      const uint32_t xm = (xx >= dil) | 2u | ((uint32_t)(xx + dil < R) << 2);
      uint32_t m = 0u;
#pragma unroll
      for (int t = 0; t < 27; ++t)
        m |= ((zm >> (t / 9)) & (ym >> ((t / 3) % 3)) & (xm >> (t % 3)) & 1u)
             << t;
      a_mask[i] = m;
      a_src[i] = x + v * Cin;
    }
  }
  const uint16_t* b_src[B_ROWS];
  bool b_ok[B_ROWS];
#pragma unroll
  for (int j = 0; j < B_ROWS; ++j) {
    const int n = n0 + rbase + j * ROWS_PER_PASS;
    b_ok[j] = n < Cout;
    b_src[j] = wt + (size_t)(b_ok[j] ? n : 0) * K + piece * 8;
  }

  auto load = [&](int chunk, int stage) {
    const uint32_t sA = ring + stage * STAGE + swz;
    const uint32_t sB = sA + A_BYTES;
    const int e = table[chunk * 8 + piece];
    const int off = e >> 5;
    const int tap = e & 31;
#pragma unroll
    for (int i = 0; i < A_ROWS; ++i) {
      const bool ok = (a_mask[i] >> tap) & 1u;
      cp_async16(sA + i * ROWS_PER_PASS * ROW_BYTES, ok ? a_src[i] + off : x,
                 ok ? 16 : 0);
    }
    const bool k_ok = chunk * BK + piece * 8 < K;
#pragma unroll
    for (int j = 0; j < B_ROWS; ++j) {
      const bool ok = k_ok && b_ok[j];
      cp_async16(sB + j * ROWS_PER_PASS * ROW_BYTES,
                 ok ? b_src[j] + chunk * BK : wt, ok ? 16 : 0);
    }
  };

  __syncthreads();  // the table
#pragma unroll
  for (int s = 0; s < STAGES - 2; ++s) {
    if (s < n_chunks) load(s, s);
    cp_async_commit();
  }

  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.0f;
  const int wgi = tid >> 7;  // warpgroup: rows 64 wgi .. 64 wgi + 63

  for (int c = 0; c < n_chunks; ++c) {
    // chunk c has landed (this thread's copies), is made visible to the
    // async proxy, and every thread's copies are in (the barrier).  The
    // barrier also orders every warpgroup's wait for wgmma c - 2 before
    // the refill of that stage, which starts right away.
    cp_async_wait<STAGES - 3>();
    fence_proxy_async();
    __syncthreads();
    const int next = c + STAGES - 2;
    if (next < n_chunks) load(next, next % STAGES);
    cp_async_commit();
    const uint32_t sA = ring + (c % STAGES) * STAGE;
    const uint32_t a0 = sA + wgi * 64 * ROW_BYTES;
    const uint32_t b0 = sA + A_BYTES;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      Wgmma<BN>::mma(acc, make_desc(a0 + kk * 32), make_desc(b0 + kk * 32));
    wgmma_commit();
    wgmma_wait<1>();  // this warpgroup's wgmma c - 1 is done
    fence_acc(acc);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  cp_async_wait<0>();

  // epilogue: bias, ReLU and the bf16 rounding on the accumulator
  // fragments (register 4j + 2h + e holds row 16 warp + lane / 4 + 8 h,
  // column 8 j + 2 (lane % 4) + e of the warpgroup's 64 x BN tile), staged
  // through the ring so that each thread stores 16 bytes and a warp whole
  // rows of out
  constexpr int PITCH = BN * 2 + 16;  // bytes a staged row; the pad spreads
                                      // a warp's 4-byte writes over 32 banks
  __syncthreads();  // both warpgroups' wgmma are done with the ring
  unsigned char* staged = smem_dyn + (ring - raw) + wgi * 64 * PITCH;
  const int lane = tid & 31;
  const int r0 = ((tid >> 5) & 3) * 16 + (lane >> 2);
  const int c0 = (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + c0 + 8 * j;
    if (col >= Cout) continue;  // Cout % 8 == 0: the pair is whole
    const float b_lo = bias[col];
    const float b_hi = bias[col + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float lo = acc[4 * j + 2 * h] + b_lo;
      float hi = acc[4 * j + 2 * h + 1] + b_hi;
      if (relu) {
        lo = fmaxf(lo, 0.0f);
        hi = fmaxf(hi, 0.0f);
      }
      __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
      *reinterpret_cast<uint32_t*>(staged + (r0 + 8 * h) * PITCH +
                                   (c0 + 8 * j) * 2) =
          *reinterpret_cast<uint32_t*>(&p);
    }
  }
  __syncthreads();
  constexpr int PIECES = BN / 8;  // 16-byte pieces a row
  const int t = tid & 127;
  const int col = n0 + (t % PIECES) * 8;
#pragma unroll
  for (int r = t / PIECES; r < 64; r += 128 / PIECES) {
    const long long row = m0 + wgi * 64 + r;
    if (row < M && col < Cout)
      *reinterpret_cast<uint4*>(out + row * Cout + col) =
          *reinterpret_cast<const uint4*>(staged + r * PITCH +
                                          (t % PIECES) * 16);
  }
}

template <int BN>
int launch(const void* x, const void* wt, const void* bias, void* out,
           long long M, int R, int Cin, int Cout, int dil, int relu,
           cudaStream_t stream) {
  // the table packs a neighbour's offset, a signed 27-bit number, with the
  // tap into one int
  if ((dil * ((long long)R * R + R + 1) + 1) * Cin >= (1 << 26))
    return (int)cudaErrorInvalidValue;
  const int n_chunks = (27 * Cin + BK - 1) / BK;
  const size_t smem = 1024 + (size_t)STAGES * stage_bytes<BN>() +
                      (size_t)n_chunks * 8 * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      conv3d_wgmma<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (Cout + BN - 1) / BN;
  const long long m_tiles = (M + BM - 1) / BM;
  conv3d_wgmma<BN><<<(unsigned)(m_tiles * n_tiles), THREADS, smem, stream>>>(
      (const uint16_t*)x, (const uint16_t*)wt, (const float*)bias,
      (uint16_t*)out, M, R, Cin, Cout, dil, relu, n_tiles, n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace wg

// ---------------------------------------------------------------------------
// Route 2: 1 <= Cin < 8, wgmma on a halo staged once in shared memory.

namespace halo {

using wg::cp_async_commit;
using wg::cp_async_wait;
using wg::fence_acc;
using wg::fence_proxy_async;
using wg::smem_addr;
using wg::wgmma_commit;
using wg::wgmma_fence;
using wg::wgmma_wait;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TX = 64;          // output voxels of a tile along x: one
                                // wgmma's 64 rows
constexpr int TILE_Y = 8;       // output rows of a tile along y and z (see
constexpr int TILE_Z = 5;       // the header)
constexpr int NB = 64;          // output channels a block's weights hold
constexpr int TAPS = 28;        // 27 taps and a zero one: 14 k16 steps
constexpr int KSTEPS = TAPS / 2;
constexpr int STAGE_BYTES = 16 * 64;  // a warp's 16 voxels x 32 channels
constexpr int ZERO_BYTES = TX * 16;   // 64 zero rows: tap 27's A
constexpr int MAX_SMEM = 232448;      // 227 KB, the most a block may have
// the widest dilation taken: at every Cin < 8 and every Cout the halo
// fits in shared memory up to here, and the wrapper (ops/cuda/conv3d.py::
// HALO_MAX_DIL) pads a wider one to Cin 8 for route 1 instead
constexpr int MAX_DIL = 5;

struct Shape {
  int R, Cout, dil, relu;
  int ty, tz;         // output tile: TX x ty x tz voxels
  int hx, hy, hz;     // its halo: the tile and dil voxels on every side
  int ntx, nty, ntz;  // tiles of a volume along x, y, z
  int m_tiles;        // B * ntx * nty * ntz
  int nb;             // channels of a weight chunk: min(Cout, NB)
  int raw_at;         // where a halo row's raw bytes (its voxels as they
                      // lie in x) land in its space
  int row_bytes;      // a halo row's space: its slots, and before they are
                      // spread, its raw bytes
};

// the halo (16 bytes a voxel), the zero rows, the warps' staging tiles,
// the weight chunk (TAPS * 8 x nb bf16, and three core matrices past its
// end that a 32-wide product over a narrower chunk reads and discards) and
// its bias
inline size_t smem_bytes(const Shape& s) {
  return (size_t)s.hz * s.hy * s.row_bytes + ZERO_BYTES +
         WARPS * STAGE_BYTES + (size_t)(TAPS * s.nb / 8 + 3) * 128 +
         NB * sizeof(float);
}

__device__ __forceinline__ void stsm_x4(uint32_t addr,
                                        const uint32_t (&r)[4]) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::
          "r"(addr),
      "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
      : "memory");
}

// shared-memory matrix descriptor, no swizzle: core matrices of 8 rows x
// 16 bytes (each 128 contiguous bytes), lbo bytes apart along K and sbo
// bytes apart along M or N
__device__ __forceinline__ uint64_t desc(uint32_t start, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((start & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// D (64 x 32, f32 in registers) += A (64 x 16) * B (16 x 32), both from
// shared memory through descriptors, bf16 in; register 4 j + 2 h + e holds
// row 16 (warp % 4) + lane / 4 + 8 h, column 8 j + 2 (lane % 4) + e
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

// one voxel's CIN channels from a raw row (at byte p, 2-byte aligned) as
// a 16-byte slot, zero past CIN.  Read in aligned 4-byte words: with CIN
// odd they straddle voxels and each pair is shifted into place (the last
// word never leaves the 16-byte pieces that hold the voxel)
template <int CIN>
__device__ __forceinline__ uint4 read_voxel(const unsigned char* p) {
  uint32_t o[4] = {0u, 0u, 0u, 0u};
  if constexpr (CIN % 2 == 0) {
    const uint32_t* q = reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int i = 0; i < CIN / 2; ++i) o[i] = q[i];
  } else {
    constexpr int NW = CIN / 2 + 1;
    const uint32_t* q = reinterpret_cast<const uint32_t*>(
        reinterpret_cast<uintptr_t>(p) & ~(uintptr_t)3);
    const uint32_t shift = (uint32_t)(reinterpret_cast<uintptr_t>(p) & 2) * 8u;
    uint32_t wd[NW];
#pragma unroll
    for (int i = 0; i < NW; ++i) wd[i] = q[i];
#pragma unroll
    for (int i = 0; i < NW; ++i)
      o[i] = __funnelshift_r(wd[i], i + 1 < NW ? wd[i + 1] : 0u, shift);
    o[NW - 1] &= 0xFFFFu;
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// byte offset of 16-byte piece p of row r in a warp's staging tile (64
// bytes a row; the piece index is XORed with (r / 2) % 4 so that both the
// stmatrix writes and the 16-byte reads are free of bank conflicts)
__device__ __forceinline__ int stage_offset(int r, int p) {
  return r * 64 + ((p ^ ((r >> 1) & 3)) << 4);
}

// the output tile of work item wi: its first voxel, its item and its
// weight chunk
struct TileOrigin {
  int x0, y0, z0, item, chunk;
};

__device__ __forceinline__ TileOrigin tile_origin(const Shape& s, int wi) {
  TileOrigin t;
  t.chunk = wi / s.m_tiles;
  int m = wi - t.chunk * s.m_tiles;
  t.x0 = m % s.ntx * TX;
  m /= s.ntx;
  t.y0 = m % s.nty * s.ty;
  m /= s.nty;
  t.z0 = m % s.ntz * s.tz;
  t.item = m / s.ntz;
  return t;
}

template <int CIN>
__global__ void __launch_bounds__(THREADS, 2)
    conv3d_halo(const uint16_t* __restrict__ x,
                const uint16_t* __restrict__ w,
                const float* __restrict__ bias, uint16_t* __restrict__ out,
                Shape s, int n_work) {
  extern __shared__ uint4 smem_h[];
  const int n_rows = s.hz * s.hy;
  unsigned char* halo = reinterpret_cast<unsigned char*>(smem_h);
  uint4* zero = reinterpret_cast<uint4*>(halo + (size_t)n_rows * s.row_bytes);
  unsigned char* stages = reinterpret_cast<unsigned char*>(zero) + ZERO_BYTES;
  // the weights K-major in core matrices: k (TAPS * 8) x n (nb), core
  // matrix (k / 8, n / 8) at byte (k / 8 * nb / 8 + n / 8) * 128, row n % 8
  // of it 8 k (16 bytes)
  unsigned char* bsm = stages + WARPS * STAGE_BYTES;
  const int nb8 = s.nb / 8;
  float* bias_s =
      reinterpret_cast<float*>(bsm + (size_t)(TAPS * nb8 + 3) * 128);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int R = s.R;
  const int d = s.dil;
  for (int i = tid; i < ZERO_BYTES / 16; i += THREADS)
    zero[i] = make_uint4(0u, 0u, 0u, 0u);

  // halo row `row` (hz, hy) of a tile holds voxels (z0, y0, x0) - dil +
  // (hz, hy, 0 .. hx - 1).  Its voxels inside the volume, [xa, xb) along
  // x, lie contiguous in x; lo is the 16-byte boundary at or below their
  // first byte, and `at` the offset of voxel x = 0's bytes from lo
  struct Span {
    bool in;
    int xa, xb;
    long long lo, at;
  };
  auto span = [&](const TileOrigin& t, int row) {
    Span sp;
    const int hz = row / s.hy;
    const int gy = t.y0 - d + (row - hz * s.hy);
    const int gz = t.z0 - d + hz;
    sp.xa = max(0, t.x0 - d);
    sp.xb = min(R, t.x0 - d + s.hx);
    sp.in = gy >= 0 && gy < R && gz >= 0 && gz < R && sp.xa < sp.xb;
    const long long row0 =
        (((long long)t.item * R + gz) * R + gy) * R * CIN * 2;
    sp.lo = (row0 + (long long)sp.xa * CIN * 2) & ~15ll;
    sp.at = row0 - sp.lo;
    return sp;
  };
  // the tile's halo rows as they lie in x, into their spaces raw_at bytes
  // on, one warp a row, 16 bytes a lane (cp.async)
  const unsigned char* xb8 = reinterpret_cast<const unsigned char*>(x);
  auto copy_rows = [&](const TileOrigin& t) {
    for (int row = warp; row < n_rows; row += WARPS) {
      const Span sp = span(t, row);
      if (!sp.in) continue;
      const long long hi = (sp.lo + sp.at + (long long)sp.xb * CIN * 2 + 15) &
                           ~15ll;
      const int pieces = (int)(hi - sp.lo) >> 4;
      const uint32_t dst =
          smem_addr(halo + (size_t)row * s.row_bytes + s.raw_at);
      for (int c = lane; c < pieces; c += 32)
        wg::cp_async16(dst + c * 16, xb8 + sp.lo + c * 16, 16);
    }
  };
  // the raw rows spread in place to one zero-padded 16-byte slot a voxel,
  // zero outside the volume: a warp reads 32 voxels, then writes their
  // slots; raw_at keeps each pass's writes below the later passes' reads
  auto expand_rows = [&](const TileOrigin& t) {
    for (int row = warp; row < n_rows; row += WARPS) {
      const Span sp = span(t, row);
      unsigned char* space = halo + (size_t)row * s.row_bytes;
      const unsigned char* src = space + s.raw_at + sp.at;
      for (int h0 = 0; h0 < s.hx; h0 += 32) {
        const int hxi = h0 + lane;
        const int gx = t.x0 - d + hxi;
        const uint4 v = sp.in && hxi < s.hx && gx >= sp.xa && gx < sp.xb
                            ? read_voxel<CIN>(src + (long long)gx * CIN * 2)
                            : make_uint4(0u, 0u, 0u, 0u);
        __syncwarp();
        if (hxi < s.hx) reinterpret_cast<uint4*>(space)[hxi] = v;
        __syncwarp();
      }
    }
  };

  // A of K step k (taps 2 k and 2 k + 1) for a tile row whose first voxel
  // sits at shared address a0: descriptor bits 0-31 are (a0 >> 4) +
  // a_lo[k], the start field moved by tap 2 k's slot offset and the lbo
  // field (bits 16-29) the slots on to tap 2 k + 1; the last step's second
  // tap is the zero rows
  const int c_y = d * s.row_bytes / 16;
  const int c_z = c_y * s.hy;
  auto tap_off = [&](int t) {
    return (t / 9) * c_z + ((t / 3) % 3) * c_y + (t % 3) * d;
  };
  uint32_t a_lo[KSTEPS];
#pragma unroll
  for (int k = 0; k < KSTEPS - 1; ++k)
    a_lo[k] = tap_off(2 * k) + ((tap_off(2 * k + 1) - tap_off(2 * k)) << 16);
  a_lo[KSTEPS - 1] = tap_off(2 * KSTEPS - 2);
  const uint32_t zero_a = smem_addr(zero);
  const uint32_t b_a = smem_addr(bsm);
  unsigned char* stage = stages + warp * STAGE_BYTES;
  // stmatrix: the lane gives the address of row lane % 8 of matrix lane / 8
  // (8 channels); + 8 rows * 64 B for the tile's lower half
  const uint32_t st_a = smem_addr(stage) + stage_offset(lane & 7, lane >> 3);

  int cur_chunk = -1;
  for (int wi = blockIdx.x; wi < n_work; wi += gridDim.x) {
    const TileOrigin t = tile_origin(s, wi);
    const int n0 = t.chunk * s.nb;
    const int nb = min(s.nb, s.Cout - n0);
    __syncthreads();  // the last tile's products are done with the halo
                      // and the weights
    copy_rows(t);
    cp_async_commit();
    if (t.chunk != cur_chunk) {
      // weight k = 8 tap + c, column n: w's row tap * CIN + c, zero for
      // c >= CIN and for tap 27; each thread one (tap, n): its 8 k
      for (int e = tid; e < TAPS * nb; e += THREADS) {
        const int tap = e / nb;
        const int n = e - tap * nb;
        uint32_t v[4] = {0u, 0u, 0u, 0u};
        if (tap < 27) {
#pragma unroll
          for (int c = 0; c < CIN; ++c)
            v[c / 2] |= (uint32_t)w[(size_t)(tap * CIN + c) * s.Cout + n0 + n]
                        << (16 * (c % 2));
        }
        *reinterpret_cast<uint4*>(bsm + (tap * nb8 + n / 8) * 128 +
                                  (n % 8) * 16) =
            make_uint4(v[0], v[1], v[2], v[3]);
      }
      for (int e = tid; e < nb; e += THREADS) bias_s[e] = bias[n0 + e];
      cur_chunk = t.chunk;
    }
    cp_async_wait<0>();   // this thread's copies of the tile's rows
    __syncthreads();      // every thread's
    expand_rows(t);
    fence_proxy_async();  // the halo and the weights, written by this
                          // thread, are read by wgmma (the async proxy)
    __syncthreads();      // everyone's
    const uint32_t halo_a = smem_addr(halo);

    // products: warpgroup g takes the tile's rows g, g + 2, ... (64 voxels
    // along x, one wgmma's M) and the chunk's channels 32 at a time
    // (four n8 tiles, one wgmma's N), K in 14 steps of two taps
    const int n_vox = min(TX, R - t.x0);  // the row's voxels in the volume
    for (int ng = 0; ng < nb; ng += 32) {
      const int nt = min(4, (nb - ng) / 8);  // n8 tiles of this group
      float2 bias_r[4];  // the lane's channels 8 j + 2 (lane % 4) + {0, 1}
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bias_r[j] = *reinterpret_cast<const float2*>(bias_s + ng + 8 * j +
                                                     2 * (lane & 3));
      for (int row = warp >> 2; row < s.ty * s.tz; row += 2) {
        const int ly = row % s.ty;
        const int lz = row / s.ty;
        if (t.y0 + ly >= R || t.z0 + lz >= R) continue;
        const uint32_t a0 = halo_a + (lz * s.hy + ly) * s.row_bytes;
        const long long vox =
            (((long long)t.item * R + t.z0 + lz) * R + t.y0 + ly) * R + t.x0;
        float acc[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[i] = 0.0f;
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < KSTEPS; ++k) {
          uint32_t lo = (a0 >> 4) + a_lo[k];
          if (k == KSTEPS - 1)  // the zero rows, lbo bytes past tap 26's
            lo += (((zero_a - a0) >> 4) - tap_off(2 * k)) << 16;
          // B: core matrices (2 k, ng / 8) on, the second tap nb8 * 128
          // bytes on, n8 tiles 128 bytes apart
          wgmma_n32(acc, ((uint64_t)(128 >> 4) << 32) | lo,
                    desc(b_a + (2 * k * nb8 + ng / 8) * 128, nb8 * 128, 128));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(acc);
        // epilogue: bias, ReLU and the bf16 rounding on the fragments,
        // staged by stmatrix so that each lane stores 16 bytes and a warp 8
        // whole voxels of 32 channels an instruction
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t p[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float lo = acc[4 * j + 2 * h] + bias_r[j].x;
            float hi = acc[4 * j + 2 * h + 1] + bias_r[j].y;
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
        const int r0 = 16 * (warp & 3);  // the warp's first voxel of the row
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = (lane >> 2) + 8 * h;
          const int piece = lane & 3;
          if (piece < nt && r0 + r < n_vox)
            *reinterpret_cast<uint4*>(
                out + (vox + r0 + r) * s.Cout + n0 + ng + piece * 8) =
                *reinterpret_cast<const uint4*>(stage +
                                                stage_offset(r, piece));
        }
        __syncwarp();
      }
    }
  }
}

template <int CIN>
int launch_cin(const void* x, const void* w, const void* bias, void* out,
               int B, int R, int Cout, int dil, int relu,
               cudaStream_t stream) {
  Shape s;
  s.R = R;
  s.Cout = Cout;
  s.dil = dil;
  s.relu = relu;
  s.nb = Cout < NB ? Cout : NB;
  s.ty = TILE_Y;
  s.tz = TILE_Z;
  if (dil > MAX_DIL) return (int)cudaErrorInvalidValue;
  // a wide dilation grows the halo: halve the tile's rows until it fits
  for (;;) {
    s.hx = TX + 2 * dil;
    s.hy = s.ty + 2 * dil;
    s.hz = s.tz + 2 * dil;
    // the raw bytes, from and to 16-byte boundaries
    const int raw_row = ((s.hx * CIN * 2 + 15) / 16 + 1) * 16;
    // spreading pass p writes bytes [512 p, 512 p + 512) of the space,
    // and pass p + 1 reads its first voxel, halo voxel 32 (p + 1), at or
    // after raw_at + 2 CIN (32 (p + 1) - dil) (dil: a row clipped at x = 0
    // starts dil voxels late), so raw_at keeps the last pair apart
    s.raw_at = ((512 - 64 * CIN) * ((s.hx + 31) / 32 - 1) + 2 * CIN * dil +
                15) / 16 * 16;
    s.row_bytes =
        s.hx * 16 > s.raw_at + raw_row ? s.hx * 16 : s.raw_at + raw_row;
    if (smem_bytes(s) <= (size_t)MAX_SMEM) break;
    if (s.ty == 1 && s.tz == 1) return (int)cudaErrorInvalidValue;
    s.ty = s.ty > 1 ? s.ty / 2 : 1;
    s.tz = s.tz > 1 ? s.tz / 2 : 1;
  }
  s.ntx = (R + TX - 1) / TX;
  s.nty = (R + s.ty - 1) / s.ty;
  s.ntz = (R + s.tz - 1) / s.tz;
  const long long m_tiles = (long long)B * s.ntx * s.nty * s.ntz;
  const long long n_work = m_tiles * ((Cout + s.nb - 1) / s.nb);
  if (n_work >= (1LL << 30))  // work indices (and one grid past) are ints
    return (int)cudaErrorInvalidValue;
  s.m_tiles = (int)m_tiles;
  const size_t smem = smem_bytes(s);
  cudaError_t err = cudaFuncSetAttribute(
      conv3d_halo<CIN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  // a persistent grid: as many blocks as fit on the card at once, each
  // walking the tiles (and staging the weights once)
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, conv3d_halo<CIN>, THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long grid = n_work < (long long)sms * per_sm
                             ? n_work
                             : (long long)sms * per_sm;
  conv3d_halo<CIN><<<(unsigned)grid, THREADS, smem, stream>>>(
      (const uint16_t*)x, (const uint16_t*)w, (const float*)bias,
      (uint16_t*)out, s, (int)n_work);
  return (int)cudaGetLastError();
}

int launch(const void* x, const void* w, const void* bias, void* out, int B,
           int R, int Cin, int Cout, int dil, int relu, cudaStream_t stream) {
  switch (Cin) {
    case 1: return launch_cin<1>(x, w, bias, out, B, R, Cout, dil, relu, stream);
    case 2: return launch_cin<2>(x, w, bias, out, B, R, Cout, dil, relu, stream);
    case 3: return launch_cin<3>(x, w, bias, out, B, R, Cout, dil, relu, stream);
    case 4: return launch_cin<4>(x, w, bias, out, B, R, Cout, dil, relu, stream);
    case 5: return launch_cin<5>(x, w, bias, out, B, R, Cout, dil, relu, stream);
    case 6: return launch_cin<6>(x, w, bias, out, B, R, Cout, dil, relu, stream);
    case 7: return launch_cin<7>(x, w, bias, out, B, R, Cout, dil, relu, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace halo

}  // namespace

extern "C" int conv3d(const void* x, const void* w, const void* wt,
                      const void* bias, void* out, int B, int R, int Cin,
                      int Cout, int dil, int relu, void* stream) {
  const long long M = (long long)B * R * R * R;
  if (M <= 0 || Cout <= 0) return 0;
  // both routes copy x and store the output 16 bytes (8 channels) at a
  // time; the wrapper pads any other shape (wgmma_padded)
  if (Cout % 8 != 0 || (uintptr_t)x % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (Cin % 8 == 0) {
    if ((uintptr_t)wt % 16 != 0) return (int)cudaErrorInvalidValue;
    if (Cout >= 128)
      return wg::launch<128>(x, wt, bias, out, M, R, Cin, Cout, dil, relu, s);
    return wg::launch<64>(x, wt, bias, out, M, R, Cin, Cout, dil, relu, s);
  }
  if (Cin < 8)
    return halo::launch(x, w, bias, out, B, R, Cin, Cout, dil, relu, s);
  // any other Cin: the wrapper pads it to a multiple of 8 (wgmma_padded)
  return (int)cudaErrorInvalidValue;
}
