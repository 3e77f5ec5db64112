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
// voxel is a ray maximum (csrc/affine_ray.cuh: window 0 = the whole sheared
// segment, window > 0 = the +-window band; positions sheared out of the
// cube are NEG both ways).  An item with another axis gets an all-0 mask.
//
// Bound on an H100: device-memory bytes, N * D^3 * (4 + 1) B (the float32
// volume read once, the bool mask written once): 0.056 ms for 144 items of
// 64^3 at 3.35 TB/s.  The max over the ray (2w, or one (D-1)-way max per
// ray shared by its D voxels) and the compare are far below the card's
// float32 rate.  Design: the affine-vote kernel's three routes with K = 1
// (csrc/affine_ray.cuh); the mask leaves each route as whole words (the
// tile route packs a warp's 32 results with a ballot and stores 16 bytes a
// lane, the segment route 4 bytes a lane).  The reference runs one pass per
// axis permutation over transposed volumes and selects per item; here there
// are no transposes and no per-axis passes.

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
  if (a >= 0 && a <= 2) check_slopes(slopes[2 * n + 0], slopes[2 * n + 1]);
  mask[g] = a >= 0 && a <= 2 &&
            affine_ray_max(p, c, p[q], a, slopes[2 * n + 0],
                           slopes[2 * n + 1], D, window);
}

// route: AffineRoute, chosen by the wrapper; planes: (N, D, D) float32
// scratch for the segment route, else unused.  Returns a CUDA error code
// (cudaErrorInvalidValue for a route that does not take this window).
extern "C" int affine_pool(const void* vol, const void* axis,
                           const void* slopes, void* mask, void* planes,
                           int N, int D, int window, int route, void* stream) {
  const long long total = (long long)N * D * D * D;
  if (total <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const float* v = (const float*)vol;
  const int32_t* ax = (const int32_t*)axis;
  const float* sl = (const float*)slopes;
  if (route == ROUTE_TILE)
    return (int)launch_tile<true>(v, ax, sl, mask, N, 1, D, window, st);
  if (route == ROUTE_SEGMENT) {
    if (window > 0 && window < D - 1) return (int)cudaErrorInvalidValue;
    return (int)launch_segment<true>(v, ax, sl, (float*)planes, mask, N, 1,
                                     D, st);
  }
  if (route != ROUTE_DIRECT) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  affine_pool_kernel<<<(unsigned)blocks, threads, 0, st>>>(
      v, ax, sl, (uint8_t*)mask, N, D, window);
  return (int)cudaGetLastError();
}
