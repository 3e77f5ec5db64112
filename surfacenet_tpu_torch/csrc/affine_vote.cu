// Affine ray-pooling vote: per cube, how many of its pooling views find
// each voxel a maximum along the view's (sheared, affine) viewing ray.
//
// Replaces the Pallas TPU kernel surfacenet_tpu/ops/pallas/affine_pool.py
// ::_affine_vote_kernel (driven by _vote_one_axis / ray_vote_affine_pallas,
// called from pipeline/sweep.py).  Plain PyTorch version:
// surfacenet_tpu_torch/ops/ray_pooling.py::ray_vote_affine_plain; wrapper:
// surfacenet_tpu_torch/ops/cuda/affine_vote.py.
//
// For cube n, votes[n] counts the active pooling views k (axis[n][k] >= 0,
// slopes[n][k]) for which each voxel is a ray maximum; the ray-max test
// (csrc/affine_ray.cuh) is the same as the affine-pool kernel's.
//
// Bound on an H100: device-memory bytes, N * D^3 * 4 B read plus the same
// written; the compares (2w+1 per active view and voxel) are far below the
// card's float32 rate.  Design: one thread per output voxel, looping over
// the K views in registers and writing its int32 count once; no transposes
// (the thread maps itself into each view's permuted frame), no atomics, no
// shared memory.  The neighbours a thread reads lie in the same 1 MB cube
// (64^3 float32) that its block's neighbours read, so they come from L1/L2
// and device memory sees each volume about once.

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
    if (a < 0) continue;
    count += affine_ray_max(p, c, pv, a, slopes[2 * (n * K + kk) + 0],
                            slopes[2 * (n * K + kk) + 1], D, window);
  }
  votes[g] = count;
}

extern "C" int affine_vote(const void* vol, const void* axis,
                           const void* slopes, void* votes, int N, int K,
                           int D, int window, void* stream) {
  const long long total = (long long)N * D * D * D;
  if (total <= 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  affine_vote_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)vol, (const int32_t*)axis, (const float*)slopes,
      (int32_t*)votes, N, K, D, window);
  return (int)cudaGetLastError();
}
