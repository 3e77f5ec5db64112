// Affine ray-pooling vote: per cube, how many of its pooling views find
// each voxel a maximum along the view's (sheared, affine) viewing ray.
//
// Replaces the Pallas TPU kernel surfacenet_tpu/ops/pallas/affine_pool.py
// ::_affine_vote_kernel (driven by _vote_one_axis / ray_vote_affine_pallas,
// called from pipeline/sweep.py).  Plain PyTorch version:
// surfacenet_tpu_torch/ops/ray_pooling.py::ray_vote_affine_plain; wrapper:
// surfacenet_tpu_torch/ops/cuda/affine_vote.py.
//
// For cube n, votes[n] counts the active pooling views k (axis[n][k] in
// {0, 1, 2}, slopes[n][k]) for which each voxel is a ray maximum
// (csrc/affine_ray.cuh states the test and the three routes).
//
// Bound on an H100: device-memory bytes, N * D^3 * 4 B read plus the same
// written (0.015 ms for the sweep's 24 cubes of 64^3 at 3.35 TB/s); the
// compares (2w+1 per active view and voxel) are far below the card's
// float32 rate.  The first design (the direct route below: one thread a
// voxel, each tap re-rounding two offsets and testing its bounds) was bound
// by instructions, not bytes.  The tile route (the sweep's window 2) reads
// each cube once into shared memory, tile by tile, and spends a load and a
// max a tap over the K views of its cube; the segment route (window 0)
// forms each view's ray-maximum plane once and compares every voxel with
// it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "affine_ray.cuh"

__global__ void affine_vote_kernel(const float* __restrict__ vol,
                                   const int32_t* __restrict__ axis,
                                   const float* __restrict__ slopes,
                                   int32_t* __restrict__ votes, int N, int K,
                                   int D, int window) {
  const long long n_vox = (long long)D * D * D;
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= (long long)N * n_vox) return;
  const int n = (int)(g / n_vox);
  const int q = (int)(g % n_vox);
  const int c[3] = {q / (D * D), (q / D) % D, q % D};
  const float* p = vol + (size_t)n * n_vox;
  const float pv = p[q];

  int count = 0;
  for (int kk = 0; kk < K; ++kk) {
    const int a = axis[n * K + kk];
    if (a < 0 || a > 2) continue;
    const float s0 = slopes[2 * (n * K + kk) + 0];
    const float s1 = slopes[2 * (n * K + kk) + 1];
    check_slopes(s0, s1);
    count += affine_ray_max(p, c, pv, a, s0, s1, D, window);
  }
  votes[g] = count;
}

// route: AffineRoute, chosen by the wrapper; planes: (N * K, D, D) float32
// scratch for the segment route, else unused.  Returns a CUDA error code
// (cudaErrorInvalidValue for a route that does not take this window).
extern "C" int affine_vote(const void* vol, const void* axis,
                           const void* slopes, void* votes, void* planes,
                           int N, int K, int D, int window, int route,
                           void* stream) {
  const long long total = (long long)N * D * D * D;
  if (total <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const float* v = (const float*)vol;
  const int32_t* ax = (const int32_t*)axis;
  const float* sl = (const float*)slopes;
  if (route == ROUTE_TILE)
    return (int)launch_tile<false>(v, ax, sl, votes, N, K, D, window, st);
  if (route == ROUTE_SEGMENT) {
    if (window > 0 && window < D - 1) return (int)cudaErrorInvalidValue;
    return (int)launch_segment<false>(v, ax, sl, (float*)planes, votes, N, K,
                                      D, st);
  }
  if (route != ROUTE_DIRECT) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  affine_vote_kernel<<<(unsigned)blocks, threads, 0, st>>>(
      v, ax, sl, (int32_t*)votes, N, K, D, window);
  return (int)cudaGetLastError();
}
