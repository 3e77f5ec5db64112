// The affine ray-max test shared by the affine-vote and affine-pool
// kernels (csrc/affine_vote.cu, csrc/affine_pool.cu).
//
// For a view with dominant axis a in {0, 1, 2} (permutation (o1, o2, a) =
// (1,2,0), (0,2,1), (0,1,2) for a = 0, 1, 2) and slopes (s0, s1), a voxel
// with coordinates (x0, x1, t) along (o1, o2, a) has shear offsets
// oi(t) = rint(s0 * (t - D/2)), oj(t) = rint(s1 * (t - D/2)) (round half to
// even, as jnp.round).  Its ray maximum is
//   NEG                         if (x0 + oi(t), x1 + oj(t)) leaves the cube,
//   max over tt of vol[x0 + oi(t) - oi(tt), x1 + oj(t) - oj(tt), tt]
//                               otherwise, over in-cube positions only, with
//                               tt over [t - w, t + w] (window w > 0) or the
//                               whole segment [0, D) (w = 0);
// and the voxel is a ray maximum when vol[x0, x1, t] >= raymax - 1e-6.

#pragma once

#include <cuda_runtime.h>

#define AFFINE_RAY_NEG (-1e30f)

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
