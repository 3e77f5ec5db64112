// Affine ray-pool mask: per (cube, view) item, which voxels are a maximum
// along the view's (sheared, affine) viewing ray.
//
// Replaces the Pallas TPU kernel surfacenet_tpu/ops/pallas/affine_pool.py
// ::_affine_pool_kernel (driven by _pool_one_axis / ray_max_mask_affine_pallas).
// Plain PyTorch version: surfacenet_tpu_torch/ops/ray_pooling.py::
// ray_max_mask_affine_plain; wrapper: surfacenet_tpu_torch/ops/cuda/
// affine_pool.py.
//
// Item n has one view: dominant axis axis[n] in {0, 1, 2} and slopes
// slopes[n] (ray_pooling.vote_params with K = 1); mask[n] is 1 where the
// voxel is a ray maximum (the test in csrc/affine_ray.cuh: window 0 = the
// whole sheared segment, window > 0 = the +-window band; positions sheared
// out of the cube are NEG both ways).
//
// Bound on an H100: device-memory bytes, N * D^3 * (4 + 1) B (the float32
// volume read once, the bool mask written once): 0.056 ms for 144 items of
// 64^3 at 3.35 TB/s.  The max over the ray (2w, or one (D-1)-way max per
// ray shared by its D voxels) and the compare are far below the card's
// float32 rate.  Design: the affine-vote kernel's mapping for a single view
// per item: one thread per (item, voxel), which maps itself into its
// item's permuted frame, reads its sheared neighbours from the item's
// volume (L1/L2 resident: 1 MB at 64^3) and writes one byte.  The
// reference runs one pass per axis permutation over transposed volumes and
// selects per item; here there are no transposes and no per-axis passes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "affine_ray.cuh"

__global__ void affine_pool_kernel(const float* __restrict__ vol,
                                   const int32_t* __restrict__ axis,
                                   const float* __restrict__ slopes,
                                   uint8_t* __restrict__ mask, int N, int D,
                                   int window) {
  const long long n_vox = (long long)D * D * D;
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= (long long)N * n_vox) return;
  const int n = (int)(g / n_vox);
  const int q = (int)(g % n_vox);
  const int c[3] = {q / (D * D), (q / D) % D, q % D};
  const float* p = vol + (size_t)n * n_vox;
  const int a = axis[n];  // an item without a dominant axis stays 0
  mask[g] = a >= 0 && a <= 2 &&
            affine_ray_max(p, c, p[q], a, slopes[2 * n + 0],
                           slopes[2 * n + 1], D, window);
}

extern "C" int affine_pool(const void* vol, const void* axis,
                           const void* slopes, void* mask, int N, int D,
                           int window, void* stream) {
  const long long total = (long long)N * D * D * D;
  if (total <= 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  affine_pool_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)vol, (const int32_t*)axis, (const float*)slopes,
      (uint8_t*)mask, N, D, window);
  return (int)cudaGetLastError();
}
