// Affine ray-pooling vote: per cube, how many of its pooling views find
// each voxel a maximum along the view's (sheared, affine) viewing ray.
//
// Replaces the Pallas TPU kernel surfacenet_tpu/ops/pallas/affine_pool.py
// ::_affine_vote_kernel (driven by _vote_one_axis / ray_vote_affine_pallas,
// called from pipeline/sweep.py).  Plain PyTorch version:
// surfacenet_tpu_torch/ops/ray_pooling.py::ray_vote_affine_plain; wrapper:
// surfacenet_tpu_torch/ops/cuda/affine_vote.py.
//
// For cube n and pooling view k with dominant axis a = axis[n][k] >= 0
// (permutation (o1, o2, a) = (1,2,0), (0,2,1), (0,1,2) for a = 0, 1, 2) and
// slopes (s0, s1) = slopes[n][k], a voxel with coordinates (x0, x1, t)
// along (o1, o2, a) has shear offsets oi(t) = rint(s0 * (t - D/2)),
// oj(t) = rint(s1 * (t - D/2)) (round half to even).  Its ray maximum is
//   NEG                         if (x0 + oi(t), x1 + oj(t)) leaves the cube,
//   max over tt of vol[x0 + oi(t) - oi(tt), x1 + oj(t) - oj(tt), tt]
//                               otherwise, over in-cube positions only, with
//                               tt over [t - w, t + w] (window w > 0) or the
//                               whole segment [0, D) (w = 0);
// and the view votes when vol[x0, x1, t] >= raymax - 1e-6.  votes[n] is the
// sum over the active views.
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

#define NEG (-1e30f)

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
  const int stride[3] = {D * D, D, 1};
  const float* p = vol + (size_t)n * n_vox;
  const float pv = p[q];
  const int half = D / 2;

  int count = 0;
  for (int kk = 0; kk < K; ++kk) {
    const int a = axis[n * K + kk];
    if (a < 0) continue;
    const int d0 = (a == 0) ? 1 : 0;
    const int d1 = (a == 2) ? 1 : 2;
    const float s0 = slopes[2 * (n * K + kk) + 0];
    const float s1 = slopes[2 * (n * K + kk) + 1];
    const int t = c[a];
    const int A = c[d0] + (int)rintf(s0 * (float)(t - half));
    const int B = c[d1] + (int)rintf(s1 * (float)(t - half));
    if (A < 0 || A >= D || B < 0 || B >= D) {
      ++count;  // unsheared position outside the cube: raymax is NEG
      continue;
    }
    const int lo = window > 0 ? max(t - window, 0) : 0;
    const int hi = window > 0 ? min(t + window, D - 1) : D - 1;
    float m = NEG;
    for (int tt = lo; tt <= hi; ++tt) {
      const int ai = A - (int)rintf(s0 * (float)(tt - half));
      const int bi = B - (int)rintf(s1 * (float)(tt - half));
      if (ai >= 0 && ai < D && bi >= 0 && bi < D) {
        m = fmaxf(m, p[ai * stride[d0] + bi * stride[d1] + tt * stride[a]]);
      }
    }
    if (pv >= m - 1e-6f) ++count;
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
