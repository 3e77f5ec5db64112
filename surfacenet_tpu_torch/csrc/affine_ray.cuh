// The affine ray-max test and the kernels shared by the affine-vote and
// affine-pool entries (csrc/affine_vote.cu, csrc/affine_pool.cu).
//
// For a view with dominant axis a in {0, 1, 2} (permutation (o1, o2, a) =
// (1,2,0), (0,2,1), (0,1,2) for a = 0, 1, 2) and slopes (s0, s1), a voxel
// with coordinates (x0, x1, t) along (o1, o2, a) has shear offsets
// oi(t) = rint(s0 * (t - D/2)), oj(t) = rint(s1 * (t - D/2)) (round half to
// even, as jnp.round).  With (A, B) = (x0 + oi(t), x1 + oj(t)), its ray
// maximum is
//   NEG                         if (A, B) leaves the cube,
//   max over tt of vol[A - oi(tt), B - oj(tt), tt]
//                               otherwise, over in-cube positions only, with
//                               tt over [t - w, t + w] (window w > 0) or the
//                               whole segment [0, D) (w = 0);
// and the voxel is a ray maximum when vol[x0, x1, t] >= raymax - 1e-6.
// A view whose axis is none of 0, 1, 2 finds no maximum (it does not vote).
//
// The vote (K views a cube, int32 counts) and the mask (one view an item,
// bytes) are one computation: the mask is the vote with K = 1, stored as
// count > 0.  Three routes, chosen by the wrapper from the shapes alone
// (ops/cuda/affine_vote.py::affine_route):
//
//   tile     1 <= w <= TILE_MAX_WINDOW (the sweep's window 2): a block owns
//            a TILE_Z x TILE_Y x TILE_X tile of one cube and stages it in
//            shared memory with a halo of w + 1 voxels on every side, NEG
//            where the halo leaves the cube.  |slope| <= 1 puts every tap of
//            a tile voxel inside that halo (|oi(t) - oi(tt)| <= w + 1 for
//            |t - tt| <= w), and a NEG tap never wins (the centre tap is the
//            voxel itself), so the taps need no bounds test and no branch.
//            Each view's shear offsets are tabled once a block: a row per
//            slab t holds oi(t), oj(t) and the 2w tap displacements in the
//            staged tile; the tap loop has no rintf.  The tile arrives by
//            cp.async, all of a thread's copies in flight at once.  A
//            thread owns a column of TILE_Z voxels along axis 0 and keeps
//            their counts for all K views in registers, a byte a count,
//            stored once: a warp stores a run of 32 voxels along axis 2
//            (the mask a byte a lane, which the warp's store coalesces;
//            packing a warp's bits by a ballot into 16 bytes a lane
//            measured slower, scripts/torch_affine_variants.py).
//   segment  w = 0, or w >= D - 1 (the same set of taps): two launches.
//            Pass 1 forms, per (item, view), the plane
//            M[A, B] = max_tt vol[A - oi(tt), B - oj(tt), tt] (D x D floats,
//            L2-resident scratch that the wrapper allocates); pass 2 compares
//            each voxel with M[A, B] (NEG where (A, B) leaves the cube), a
//            block a slab of a cube.  A cube costs O(D^3) a view, not O(D^4).
//   direct   any other window (wider than a tile's halo affords): the first
//            design, one thread a voxel with a bounds test and two rintf a
//            tap (affine_ray_max below).
//
// Every route refuses slopes outside [-1, 1] (or NaN; vote_params clamps
// them): the kernel traps, which the caller sees as a CUDA error on its
// next synchronisation, never as output.  The offsets are the plain
// version's float32 product rounded half to even (rintf; the package builds
// with --fmad=false), and the compare is the same float32 expression, so
// every route is bitwise equal to ops/ray_pooling.py's plain versions.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define AFFINE_RAY_NEG (-1e30f)

// Internal linkage: the launchers' function-local statics (allow_smem's
// per-device record) would otherwise be unique symbols that the dynamic
// linker shares between every library built from this header in one
// process, and a second library's kernel would never get its attribute.
namespace {

// the tile route's output tile (z, y, x); its block has TILE_Y * TILE_X
// threads, one per column of TILE_Z voxels
constexpr int TILE_Z = 16, TILE_Y = 8, TILE_X = 32;
constexpr int TILE_THREADS = TILE_Y * TILE_X;
constexpr int TILE_MAX_WINDOW = 4;
// views a cube the tile route takes: its counts are bytes, and the offset
// tables of all views sit in shared memory
constexpr int TILE_MAX_VIEWS = 64;
// the segment route's blocks, and the plane elements a pass-1 warp forms at
// once along axis 2
constexpr int SEG_THREADS = 256;
constexpr int SEG_ELEMS = 4;

enum AffineRoute { ROUTE_TILE = 0, ROUTE_SEGMENT = 1, ROUTE_DIRECT = 2 };

// Allow `kernel` `bytes` of dynamic shared memory on the current device.
// `allowed` holds the largest size set so far on each device (a static of
// the caller's, one per kernel), so the attribute is set once a size, not
// on every launch.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t (&allowed)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (bytes > allowed[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    allowed[dev] = bytes;
  }
  return cudaSuccess;
}

__device__ __forceinline__ int shear_offset(float s, int t, int half) {
  return (int)rintf(s * (float)(t - half));
}

__device__ __forceinline__ bool in_cube(int v, int D) {
  return (unsigned)v < (unsigned)D;
}

// traps on a slope that the tile route's halo (and the plain version's
// bound, vote_params' clamp) does not allow
__device__ __forceinline__ void check_slopes(float s0, float s1) {
  if (!(fabsf(s0) <= 1.0f) || !(fabsf(s1) <= 1.0f)) __trap();
}

// ---------------------------------------------------------------------------
// direct route: one voxel, one view
//
// p: one (D, D, D) float32 volume, C order; c: the voxel's coordinates;
// pv = p at c.
__device__ __forceinline__ bool affine_ray_max(const float* __restrict__ p,
                                               const int c[3], float pv,
                                               int a, float s0, float s1,
                                               int D, int window) {
  const int stride[3] = {D * D, D, 1};
  const int half = D / 2;
  const int d0 = (a == 0) ? 1 : 0;
  const int d1 = (a == 2) ? 1 : 2;
  const int t = c[a];
  const int A = c[d0] + (int)rintf(s0 * (float)(t - half));
  const int B = c[d1] + (int)rintf(s1 * (float)(t - half));
  if (A < 0 || A >= D || B < 0 || B >= D) return true;  // raymax is NEG
  const int lo = window > 0 ? max(t - window, 0) : 0;
  const int hi = window > 0 ? min(t + window, D - 1) : D - 1;
  float m = AFFINE_RAY_NEG;
  for (int tt = lo; tt <= hi; ++tt) {
    const int ai = A - (int)rintf(s0 * (float)(tt - half));
    const int bi = B - (int)rintf(s1 * (float)(tt - half));
    if (ai >= 0 && ai < D && bi >= 0 && bi < D) {
      m = fmaxf(m, p[ai * stride[d0] + bi * stride[d1] + tt * stride[a]]);
    }
  }
  return pv >= m - 1e-6f;
}

// ---------------------------------------------------------------------------
// tile route

template <int W>
struct TileGeom {
  static constexpr int H = W + 1;                 // halo, every axis
  static constexpr int HX = (H + 3) / 4 * 4;      // x halo: whole 16-byte quads
  static constexpr int SX = TILE_X + 2 * HX;      // row pitch, floats
  static constexpr int SY = TILE_Y + 2 * H;
  static constexpr int SZ = TILE_Z + 2 * H;
  static constexpr int PLANE = SY * SX;
  static constexpr int FLOATS = SZ * PLANE;
  // a table row: oi, oj, the displacements of taps -W..-1, 1..W; padded
  // to 16 bytes
  static constexpr int ROW = (2 + 2 * W + 3) / 4 * 4;
  static constexpr int TMAX = TILE_Z > TILE_Y ? (TILE_Z > TILE_X ? TILE_Z : TILE_X)
                                              : (TILE_Y > TILE_X ? TILE_Y : TILE_X);
  static size_t smem_bytes(int K) {
    return sizeof(float) * (size_t)FLOATS + sizeof(int) * (size_t)K * TMAX * ROW;
  }
};

// 16 bytes from device memory to shared memory, asynchronously (cached in
// L2 only); complete after cp_async_wait_all
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Stage the tile at (oz, oy, ox) of volume p with its halo; NEG outside the
// cube.  vec: D % 4 == 0 and p 16-byte aligned, so each 16-byte quad of a
// row lies wholly inside or wholly outside the cube, and every quad is one
// asynchronous copy: a thread issues all of its copies before it waits,
// instead of one load round trip each.  The caller waits
// (cp_async_wait_all) and synchronises the block.  (Staging only the halo
// that the block's views read, from their slopes, moves fewer bytes but
// measured slower: scripts/torch_affine_variants.py, trimmed_halo.)
template <int W>
__device__ __forceinline__ void stage_tile(float* __restrict__ tile,
                                           const float* __restrict__ p, int D,
                                           int oz, int oy, int ox, bool vec) {
  using G = TileGeom<W>;
  const int z0 = oz - G::H, y0 = oy - G::H, x0 = ox - G::HX;
  if (vec) {
    constexpr int QX = G::SX / 4;
    float4* t4 = reinterpret_cast<float4*>(tile);
    for (int q = threadIdx.x; q < G::SZ * G::SY * QX; q += TILE_THREADS) {
      const int xq = q % QX, r = q / QX;
      const int z = z0 + r / G::SY, y = y0 + r % G::SY, x = x0 + 4 * xq;
      float4* dst = t4 + q;
      if (in_cube(z, D) && in_cube(y, D) && in_cube(x, D))
        cp_async16(dst, p + ((size_t)z * D + y) * D + x);
      else
        *dst = make_float4(AFFINE_RAY_NEG, AFFINE_RAY_NEG, AFFINE_RAY_NEG,
                           AFFINE_RAY_NEG);
    }
  } else {
    for (int q = threadIdx.x; q < G::FLOATS; q += TILE_THREADS) {
      const int xx = q % G::SX, r = q / G::SX;
      const int z = z0 + r / G::SY, y = y0 + r % G::SY, x = x0 + xx;
      tile[q] = (in_cube(z, D) && in_cube(y, D) && in_cube(x, D))
                    ? __ldg(p + ((size_t)z * D + y) * D + x)
                    : AFFINE_RAY_NEG;
    }
  }
}

// Table rows of the block's K views: for view k with axis a, row r is slab
// t = (tile origin along a) + r.  Inactive views get no rows.
template <int W>
__device__ __forceinline__ void build_table(int* __restrict__ table,
                                            const int32_t* __restrict__ axis,
                                            const float* __restrict__ slopes,
                                            int K, int D, int oz, int oy,
                                            int ox) {
  using G = TileGeom<W>;
  const int half = D / 2;
  for (int e = threadIdx.x; e < K * G::TMAX; e += TILE_THREADS) {
    const int k = e / G::TMAX, r = e % G::TMAX;
    const int a = __ldg(axis + k);
    if (a < 0 || a > 2) continue;
    const float s0 = __ldg(slopes + 2 * k), s1 = __ldg(slopes + 2 * k + 1);
    check_slopes(s0, s1);
    // the staged tile's strides along o1, o2 and a (selects, not an array
    // indexed by a: that would sit in local memory)
    const int so1 = a == 0 ? G::SX : G::PLANE, so2 = a == 2 ? G::SX : 1;
    const int sa = a == 0 ? G::PLANE : (a == 1 ? G::SX : 1);
    const int t = r + (a == 0 ? oz : (a == 1 ? oy : ox));
    const int oi = shear_offset(s0, t, half), oj = shear_offset(s1, t, half);
    int* row = table + e * G::ROW;
    row[0] = oi;
    row[1] = oj;
    int i = 2;
#pragma unroll
    for (int d = -W; d <= W; ++d) {
      if (d == 0) continue;
      row[i++] = (oi - shear_offset(s0, t + d, half)) * so1 +
                 (oj - shear_offset(s1, t + d, half)) * so2 + d * sa;
    }
  }
}

// a table row into registers, 16 bytes a load
template <int ROW>
__device__ __forceinline__ void load_row(const int* __restrict__ row,
                                         int (&v)[ROW]) {
#pragma unroll
  for (int q = 0; q < ROW / 4; ++q) {
    const int4 x = reinterpret_cast<const int4*>(row)[q];
    v[4 * q] = x.x;
    v[4 * q + 1] = x.y;
    v[4 * q + 2] = x.z;
    v[4 * q + 3] = x.w;
  }
}

// The column's counts, a byte a voxel (K <= TILE_MAX_VIEWS < 256): voxel j
// in byte j % 4 of word j / 4, so that 16 counts take 4 registers, not 16.
constexpr int COUNT_WORDS = TILE_Z / 4;

__device__ __forceinline__ void count_hit(uint32_t (&cnt)[COUNT_WORDS], int j,
                                          bool hit) {
  cnt[j >> 2] += (uint32_t)hit << (8 * (j & 3));
}

// One view over the thread's column of TILE_Z voxels: voxel j's count
// grows by its ray max.  The thread's voxel j sits at tile-local (j, ly,
// lx), cube (oz + j, gy, gx), and at tile[centre + j * PLANE].
template <int W, int AX>
__device__ __forceinline__ void tile_view(const float* __restrict__ tile,
                                          const int* __restrict__ rows,
                                          const float (&pv)[TILE_Z],
                                          uint32_t (&cnt)[COUNT_WORDS],
                                          int centre,
                                          int oz, int gy, int gx, int ly,
                                          int lx, int D) {
  using G = TileGeom<W>;
  if (AX == 0) {
    // t = z: a row a voxel (the same for the whole warp: a broadcast)
#pragma unroll
    for (int j = 0; j < TILE_Z; ++j) {
      int row[G::ROW];
      load_row<G::ROW>(rows + j * G::ROW, row);
      const int A = gy + row[0], B = gx + row[1];
      const float* c = tile + centre + j * G::PLANE;
      float m = pv[j];
#pragma unroll
      for (int d = 0; d < 2 * W; ++d) m = fmaxf(m, c[row[2 + d]]);
      if (!(in_cube(A, D) && in_cube(B, D))) m = AFFINE_RAY_NEG;
      count_hit(cnt, j, pv[j] >= m - 1e-6f);
    }
  } else {
    // t = y or x: one row for the whole column
    int row[G::ROW];
    load_row<G::ROW>(rows + (AX == 1 ? ly : lx) * G::ROW, row);
    int dsp[2 * W];
#pragma unroll
    for (int d = 0; d < 2 * W; ++d) dsp[d] = centre + row[2 + d];
    const int oi = row[0], oj = row[1];
    // AX 1: (o1, o2) = (z, x); AX 2: (z, y)
    const bool okB = in_cube((AX == 1 ? gx : gy) + oj, D);
#pragma unroll
    for (int j = 0; j < TILE_Z; ++j) {
      float m = pv[j];
#pragma unroll
      for (int d = 0; d < 2 * W; ++d) m = fmaxf(m, tile[dsp[d] + j * G::PLANE]);
      if (!(okB && in_cube(oz + j + oi, D))) m = AFFINE_RAY_NEG;
      count_hit(cnt, j, pv[j] >= m - 1e-6f);
    }
  }
}

// grid: N items x tiles a cube (1-D); block TILE_THREADS; dynamic shared
// memory TileGeom<W>::smem_bytes(K).  MASK: K == 1, out is bytes (count >
// 0); else out is int32 counts.
template <bool MASK, int W>
__global__ void __launch_bounds__(TILE_THREADS)
affine_tile_kernel(const float* __restrict__ vol,
                   const int32_t* __restrict__ axis,
                   const float* __restrict__ slopes, void* __restrict__ out,
                   int K, int D, int tiles_z, int tiles_y, int tiles_x,
                   bool vec) {
  using G = TileGeom<W>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* tile = reinterpret_cast<float*>(smem);
  int* table = reinterpret_cast<int*>(smem + sizeof(float) * G::FLOATS);

  const int per_item = tiles_z * tiles_y * tiles_x;
  const int n = blockIdx.x / per_item, b = blockIdx.x % per_item;
  const int org[3] = {(b / (tiles_y * tiles_x)) * TILE_Z,
                      ((b / tiles_x) % tiles_y) * TILE_Y,
                      (b % tiles_x) * TILE_X};
  const size_t n_vox = (size_t)D * D * D;
  const int32_t* ax = axis + (size_t)n * K;
  const float* sl = slopes + (size_t)n * K * 2;

  // the table is built while the tile's copies are in flight
  stage_tile<W>(tile, vol + n * n_vox, D, org[0], org[1], org[2], vec);
  build_table<W>(table, ax, sl, K, D, org[0], org[1], org[2]);
  cp_async_wait_all();
  __syncthreads();

  const int ly = threadIdx.x / TILE_X, lx = threadIdx.x % TILE_X;
  const int gy = org[1] + ly, gx = org[2] + lx;
  const int centre = (G::H * G::SY + ly + G::H) * G::SX + lx + G::HX;
  float pv[TILE_Z];
  uint32_t cnt[COUNT_WORDS] = {};
#pragma unroll
  for (int j = 0; j < TILE_Z; ++j) pv[j] = tile[centre + j * G::PLANE];
  for (int k = 0; k < K; ++k) {
    const int* rows = table + k * G::TMAX * G::ROW;
    switch (__ldg(ax + k)) {
      case 0:
        tile_view<W, 0>(tile, rows, pv, cnt, centre, org[0], gy, gx, ly, lx, D);
        break;
      case 1:
        tile_view<W, 1>(tile, rows, pv, cnt, centre, org[0], gy, gx, ly, lx, D);
        break;
      case 2:
        tile_view<W, 2>(tile, rows, pv, cnt, centre, org[0], gy, gx, ly, lx, D);
        break;
      default:
        break;  // inactive: no vote
    }
  }

  // a warp's stores are one run of 32 counts (or bytes) along x
  const bool in_yx = gy < D && gx < D;
  const size_t base = n * n_vox + (size_t)gy * D + gx;
#pragma unroll
  for (int j = 0; j < TILE_Z; ++j) {
    const int gz = org[0] + j;
    if (!in_yx || gz >= D) continue;
    const uint32_t c = (cnt[j >> 2] >> (8 * (j & 3))) & 0xffu;
    if (MASK)
      reinterpret_cast<uint8_t*>(out)[base + (size_t)gz * D * D] = c > 0;
    else
      reinterpret_cast<int32_t*>(out)[base + (size_t)gz * D * D] = c;
  }
}

template <bool MASK, int W>
cudaError_t launch_tile_w(const float* vol, const int32_t* axis,
                          const float* slopes, void* out, int N, int K, int D,
                          bool vec, cudaStream_t stream) {
  const size_t smem = TileGeom<W>::smem_bytes(K);
  static size_t allowed[64] = {};
  const cudaError_t err = allow_smem(affine_tile_kernel<MASK, W>, smem, allowed);
  if (err != cudaSuccess) return err;
  const int tz = (D + TILE_Z - 1) / TILE_Z, ty = (D + TILE_Y - 1) / TILE_Y,
            tx = (D + TILE_X - 1) / TILE_X;
  const long long blocks = (long long)N * tz * ty * tx;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  affine_tile_kernel<MASK, W><<<(unsigned)blocks, TILE_THREADS, smem, stream>>>(
      vol, axis, slopes, out, K, D, tz, ty, tx, vec);
  return cudaGetLastError();
}

template <bool MASK>
cudaError_t launch_tile(const float* vol, const int32_t* axis,
                        const float* slopes, void* out, int N, int K, int D,
                        int window, cudaStream_t stream) {
  if (K > TILE_MAX_VIEWS) return cudaErrorInvalidValue;
  const bool vec = D % 4 == 0 && ((uintptr_t)vol & 15) == 0;
  switch (window) {
    case 1: return launch_tile_w<MASK, 1>(vol, axis, slopes, out, N, K, D, vec, stream);
    case 2: return launch_tile_w<MASK, 2>(vol, axis, slopes, out, N, K, D, vec, stream);
    case 3: return launch_tile_w<MASK, 3>(vol, axis, slopes, out, N, K, D, vec, stream);
    case 4: return launch_tile_w<MASK, 4>(vol, axis, slopes, out, N, K, D, vec, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// segment route

// Shear offsets (oi, oj) of slabs 0..D-1 of `views` views into `tab`
// (views x D int2); inactive views get none.
__device__ __forceinline__ void build_offsets(int2* __restrict__ tab,
                                              const int32_t* __restrict__ axis,
                                              const float* __restrict__ slopes,
                                              int views, int D) {
  const int half = D / 2;
  for (int e = threadIdx.x; e < views * D; e += blockDim.x) {
    const int k = e / D, t = e % D;
    const int a = __ldg(axis + k);
    if (a < 0 || a > 2) continue;
    const float s0 = __ldg(slopes + 2 * k), s1 = __ldg(slopes + 2 * k + 1);
    check_slopes(s0, s1);
    tab[e] = make_int2(shear_offset(s0, t, half), shear_offset(s1, t, half));
  }
}

// Pass 1.  grid: N * K planes x blocks_per_plane (1-D); block SEG_THREADS;
// dynamic shared memory D int2.  planes: (N * K, D, D) float32.
// Axes 0 and 1: a thread a plane element, lanes along B (the volume's
// contiguous axis).  Axis 2 (tt contiguous): a warp a plane element, lanes
// along tt, reduced by shuffles.
__global__ void __launch_bounds__(SEG_THREADS)
affine_segment_planes(const float* __restrict__ vol,
                      const int32_t* __restrict__ axis,
                      const float* __restrict__ slopes,
                      float* __restrict__ planes, int K, int D,
                      int blocks_per_plane) {
  extern __shared__ int2 offs[];
  const int plane = blockIdx.x / blocks_per_plane;
  const int b = blockIdx.x % blocks_per_plane;
  const int n = plane / K;
  const int a = __ldg(axis + plane);
  if (a < 0 || a > 2) return;  // inactive view: its plane is never read
  build_offsets(offs, axis + plane, slopes + 2 * (size_t)plane, 1, D);
  __syncthreads();
  const size_t DD = (size_t)D * D;
  const float* p = vol + n * DD * D;
  float* M = planes + plane * DD;
  if (a != 2) {
    // vol index of (o1, o2, tt): a = 0: [tt][o1][o2]; a = 1: [o1][tt][o2]
    const int s_o1 = a == 0 ? D : D * D, s_tt = a == 0 ? D * D : D;
    for (int e = b * SEG_THREADS + threadIdx.x; e < D * D;
         e += blocks_per_plane * SEG_THREADS) {
      const int A = e / D, B = e % D;
      float m = AFFINE_RAY_NEG;
#pragma unroll 16
      for (int tt = 0; tt < D; ++tt) {
        const int2 o = offs[tt];
        const int ai = A - o.x, bi = B - o.y;
        if (in_cube(ai, D) && in_cube(bi, D))
          m = fmaxf(m, __ldg(p + (size_t)ai * s_o1 + (size_t)tt * s_tt + bi));
      }
      M[e] = m;
    }
  } else {
    // SEG_ELEMS plane elements a warp at a time, their loads interleaved
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    constexpr int WARPS = SEG_THREADS / 32;
    const int stride = blocks_per_plane * WARPS;
    for (int e0 = b * WARPS + warp; e0 < D * D; e0 += SEG_ELEMS * stride) {
      float m[SEG_ELEMS];
      int A[SEG_ELEMS], B[SEG_ELEMS];
#pragma unroll
      for (int i = 0; i < SEG_ELEMS; ++i) {
        m[i] = AFFINE_RAY_NEG;
        const int e = e0 + i * stride;
        // an element past the plane gets an A that no tap finds in the cube
        A[i] = e < D * D ? e / D : 2 * D;
        B[i] = e % D;
      }
      for (int tt = lane; tt < D; tt += 32) {
        const int2 o = offs[tt];
#pragma unroll
        for (int i = 0; i < SEG_ELEMS; ++i) {
          const int ai = A[i] - o.x, bi = B[i] - o.y;
          if (in_cube(ai, D) && in_cube(bi, D))
            m[i] = fmaxf(m[i], __ldg(p + ((size_t)ai * D + bi) * D + tt));
        }
      }
#pragma unroll
      for (int i = 0; i < SEG_ELEMS; ++i) {
#pragma unroll
        for (int sh = 16; sh > 0; sh >>= 1)
          m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], sh));
        if (lane == 0 && e0 + i * stride < D * D) M[e0 + i * stride] = m[i];
      }
    }
  }
}

// the quads (4 consecutive voxels along axis 2) a pass-2 thread holds at once
constexpr int SEG_QUADS = 4;

// Pass 2.  grid: N items x D slabs c0 (1-D); block SEG_THREADS; dynamic
// shared memory K * D int2 + K int.  Where D % 4 == 0 and vol is 16-byte
// aligned, a thread owns the quads q = tid + SEG_THREADS * i of its slab
// (one 16-byte load, one int4 or uchar4 store each), SEG_QUADS at a time:
// it issues their loads before the block builds its offset table, and each
// view's plane reads of all its 16 voxels are independent loads.  Other D
// (odd sizes): a thread a voxel.
// A voxel whose (A, B) leaves the cube compares with NEG, as the plain
// version does.
template <bool MASK>
__global__ void __launch_bounds__(SEG_THREADS)
affine_segment_compare(const float* __restrict__ vol,
                       const int32_t* __restrict__ axis,
                       const float* __restrict__ slopes,
                       const float* __restrict__ planes,
                       void* __restrict__ out, int K, int D) {
  extern __shared__ int2 offs[];
  int* ax = reinterpret_cast<int*>(offs + K * D);
  // items in the reverse of pass 1's order: the first ones read here are
  // the last that pass 1 read, still in L2
  const int n = gridDim.x / D - 1 - blockIdx.x / D, c0 = blockIdx.x % D;
  const size_t DD = (size_t)D * D;
  const size_t slab = ((size_t)n * D + c0) * DD;  // the slab's first voxel
  const float* p = vol + slab;
  const float* P = planes + (size_t)n * K * DD;
  const bool quads = D % 4 == 0 && ((uintptr_t)vol & 15) == 0;
  const int QR = D / 4, QS = D * QR;  // quads a row, a slab
  float4 v[SEG_QUADS];
  if (quads) {
#pragma unroll
    for (int i = 0; i < SEG_QUADS; ++i) {
      const int q = threadIdx.x + SEG_THREADS * i;
      if (q < QS) v[i] = __ldg(reinterpret_cast<const float4*>(p) + q);
    }
  }
  for (int k = threadIdx.x; k < K; k += SEG_THREADS)
    ax[k] = __ldg(axis + (size_t)n * K + k);
  build_offsets(offs, axis + (size_t)n * K, slopes + 2 * (size_t)n * K, K, D);
  __syncthreads();

  if (!quads) {
    for (int q = threadIdx.x; q < (int)DD; q += SEG_THREADS) {
      const int c[3] = {c0, q / D, q % D};
      const float pv = __ldg(p + q);
      int cnt = 0;
      for (int k = 0; k < K; ++k) {
        const int a = ax[k];
        if (a < 0 || a > 2) continue;
        const int2 o = offs[k * D + c[a]];
        const int A = c[a == 0 ? 1 : 0] + o.x, B = c[a == 2 ? 1 : 2] + o.y;
        const float m = in_cube(A, D) && in_cube(B, D)
                            ? __ldg(P + k * DD + (size_t)A * D + B)
                            : AFFINE_RAY_NEG;
        cnt += pv >= m - 1e-6f;
      }
      if (MASK)
        reinterpret_cast<uint8_t*>(out)[slab + q] = cnt > 0;
      else
        reinterpret_cast<int32_t*>(out)[slab + q] = cnt;
    }
    return;
  }
  for (int first = 0; first < QS; first += SEG_QUADS * SEG_THREADS) {
    int c1[SEG_QUADS], c2[SEG_QUADS];
    int cnt[SEG_QUADS][4] = {};
#pragma unroll
    for (int i = 0; i < SEG_QUADS; ++i) {
      const int q = first + threadIdx.x + SEG_THREADS * i;
      c1[i] = q / QR;
      c2[i] = 4 * (q - c1[i] * QR);
    }
    for (int k = 0; k < K; ++k) {
      const int a = ax[k];
      if (a < 0 || a > 2) continue;
      const int2* ok = offs + k * D;
      const float* Pk = P + k * DD;
#pragma unroll
      for (int i = 0; i < SEG_QUADS; ++i) {
        const float pv[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
        const bool live = first + threadIdx.x + SEG_THREADS * i < QS;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = a == 0 ? c0 : (a == 1 ? c1[i] : c2[i] + e);
          const int2 o = live ? ok[t] : make_int2(0, 0);
          const int A = (a == 0 ? c1[i] : c0) + o.x;
          const int B = (a == 2 ? c1[i] : c2[i] + e) + o.y;
          const float m = live && in_cube(A, D) && in_cube(B, D)
                              ? __ldg(Pk + (size_t)A * D + B)
                              : AFFINE_RAY_NEG;
          cnt[i][e] += pv[e] >= m - 1e-6f;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < SEG_QUADS; ++i) {
      const int q = first + threadIdx.x + SEG_THREADS * i;
      if (q >= QS) continue;
      if (MASK)
        reinterpret_cast<uchar4*>(out)[slab / 4 + q] =
            make_uchar4(cnt[i][0] > 0, cnt[i][1] > 0, cnt[i][2] > 0,
                        cnt[i][3] > 0);
      else
        reinterpret_cast<int4*>(out)[slab / 4 + q] =
            make_int4(cnt[i][0], cnt[i][1], cnt[i][2], cnt[i][3]);
    }
    // the next quads (D > 64), loaded as this chunk's are
    const int next = first + SEG_QUADS * SEG_THREADS;
#pragma unroll
    for (int i = 0; i < SEG_QUADS; ++i) {
      const int q = next + threadIdx.x + SEG_THREADS * i;
      if (q < QS) v[i] = __ldg(reinterpret_cast<const float4*>(p) + q);
    }
  }
}

template <bool MASK>
cudaError_t launch_segment(const float* vol, const int32_t* axis,
                           const float* slopes, float* planes, void* out,
                           int N, int K, int D, cudaStream_t stream) {
  if (planes == nullptr) return cudaErrorInvalidValue;
  const long long DD = (long long)D * D;
  // pass 1: a block for every SEG_THREADS plane elements, so that the
  // sweep's 24 x 6 planes of 64^2 make 2304 blocks; pass 2: a block a slab
  const int per_plane = (int)((DD + SEG_THREADS - 1) / SEG_THREADS);
  const long long blocks1 = (long long)N * K * per_plane;
  const long long blocks2 = (long long)N * D;
  if (blocks1 > 0x7fffffffLL || blocks2 > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  const size_t smem2 = sizeof(int2) * (size_t)K * D + sizeof(int) * K;
  static size_t allowed[64] = {};
  cudaError_t err = allow_smem(affine_segment_compare<MASK>, smem2, allowed);
  if (err != cudaSuccess) return err;
  if (blocks1 > 0) {
    affine_segment_planes<<<(unsigned)blocks1, SEG_THREADS,
                            sizeof(int2) * D, stream>>>(
        vol, axis, slopes, planes, K, D, per_plane);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  // ordered after pass 1 on the same stream
  affine_segment_compare<MASK><<<(unsigned)blocks2, SEG_THREADS, smem2,
                                 stream>>>(vol, axis, slopes, planes, out, K,
                                           D);
  return cudaGetLastError();
}

}  // namespace
