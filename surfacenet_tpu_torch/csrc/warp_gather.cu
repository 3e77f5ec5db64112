// Warp gather: colored-voxel-cube construction for (cube, view) items.
//
// Replaces the Pallas TPU kernel surfacenet_tpu/ops/pallas/warp_gather.py
// ::_warp_kernel (and its 1-D-grid twin _warp_kernel_fused), reached from
// pipeline/sweep.py through warp_gather_tiled.  Plain PyTorch version:
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
// int8 entry (the reference kernel's int8 mode, warp_gather.py:148-175):
// images hold q = round_half_even(x * 127).  The vertical hat weights are
// rounded to 7 bits, hv0 = rint((1 - dv) * 127), hv1 = rint(dv * 127); per
// column the int32 sum q[v0] * hv0 + q[v1] * hv1 is exact, is converted to
// float32 and scaled by (float)(1/127^2); the two columns are combined with
// the float32 weights 1 - du and du.  Same validity, same output.
//
// Bound on an H100: device-memory bytes.  Per voxel it writes 12 B of
// colour and 1 B of validity and does ~50 float32 operations, far below
// the card's ~20 operations per byte break-even in float32; the bound is
// items * D^3 * 13 B of output over 3.35 TB/s.  The images (bf16, one copy
// per sweep, ~35 MB for 12 views of 600x800; int8 ~17 MB) are read through
// L2 and stay resident there across items.
//
// Design: one thread per (item, voxel), consecutive threads on consecutive
// voxels, so the colour and validity stores of a warp are contiguous runs.
// The TPU kernel's workarounds are not carried over: no hat-matrix matmul
// (the card gathers the four neighbours directly), no crop or chunk
// windows (the TPU needed them to bound VMEM; validity here has no window
// term, which is the XLA oracle's rule), no sub-cube tiling, and no
// reciprocal-plus-Newton step (the card divides exactly).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

template <typename T>
__device__ __forceinline__ float to_f32(T x);

template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }

template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void warp_gather_kernel(const T* __restrict__ images,
                                   const float* __restrict__ Ps,
                                   const int32_t* __restrict__ view_idx,
                                   const float* __restrict__ origins,
                                   float* __restrict__ colors,
                                   uint8_t* __restrict__ valid, int H, int W,
                                   int D, float s) {
  const int b = blockIdx.y;
  const int n_vox = D * D * D;
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n_vox) return;

  const int view = view_idx[b];
  const float* P = Ps + 12 * view;
  const int i = q / (D * D);
  const int j = (q / D) % D;
  const int k = q % D;
  const float fx = origins[3 * b + 0] + ((float)i + 0.5f) * s;
  const float fy = origins[3 * b + 1] + ((float)j + 0.5f) * s;
  const float fz = origins[3 * b + 2] + ((float)k + 0.5f) * s;

  const float nu = P[0] * fx + P[1] * fy + P[2] * fz + P[3];
  const float nv = P[4] * fx + P[5] * fy + P[6] * fz + P[7];
  const float den = P[8] * fx + P[9] * fy + P[10] * fz + P[11];
  const float d = den + 1e-8f;
  const float u = nu / d;
  const float v = nv / d;
  const bool ok = (u >= 0.f) && (u <= (float)(W - 1)) && (v >= 0.f) &&
                  (v <= (float)(H - 1)) && (den > 0.f);

  float r = 0.f, g = 0.f, bl = 0.f;
  if (ok) {
    const float u0 = floorf(u);
    const float v0 = floorf(v);
    const float du = u - u0;
    const float dv = v - v0;
    const int u0i = (int)u0;
    const int v0i = (int)v0;
    const int u1i = min(u0i + 1, W - 1);
    const int v1i = min(v0i + 1, H - 1);
    const T* img = images + (size_t)view * H * W * 3;
    const T* c00 = img + ((size_t)v0i * W + u0i) * 3;
    const T* c01 = img + ((size_t)v0i * W + u1i) * 3;
    const T* c10 = img + ((size_t)v1i * W + u0i) * 3;
    const T* c11 = img + ((size_t)v1i * W + u1i) * 3;
    if constexpr (std::is_same<T, int8_t>::value) {
      const int hv0 = (int)rintf((1.f - dv) * 127.f);
      const int hv1 = (int)rintf(dv * 127.f);
      const float deq = (float)(1.0 / (127.0 * 127.0));
      float out[3];
      for (int c = 0; c < 3; ++c) {
        const float left = (float)((int)c00[c] * hv0 + (int)c10[c] * hv1);
        const float right = (float)((int)c01[c] * hv0 + (int)c11[c] * hv1);
        out[c] = left * deq * (1.f - du) + right * deq * du;
      }
      r = out[0];
      g = out[1];
      bl = out[2];
    } else {
      const float w00 = (1.f - dv) * (1.f - du);
      const float w01 = (1.f - dv) * du;
      const float w10 = dv * (1.f - du);
      const float w11 = dv * du;
      r = to_f32(c00[0]) * w00 + to_f32(c01[0]) * w01 + to_f32(c10[0]) * w10 +
          to_f32(c11[0]) * w11;
      g = to_f32(c00[1]) * w00 + to_f32(c01[1]) * w01 + to_f32(c10[1]) * w10 +
          to_f32(c11[1]) * w11;
      bl = to_f32(c00[2]) * w00 + to_f32(c01[2]) * w01 + to_f32(c10[2]) * w10 +
           to_f32(c11[2]) * w11;
    }
  }
  const size_t o = (size_t)b * n_vox + q;
  colors[3 * o + 0] = r;
  colors[3 * o + 1] = g;
  colors[3 * o + 2] = bl;
  valid[o] = ok ? 1 : 0;
}

template <typename T>
static int launch(const void* images, const void* Ps, const void* view_idx,
                  const void* origins, void* colors, void* valid, int H,
                  int W, int B, int D, float s, void* stream) {
  if (B <= 0) return 0;
  const int n_vox = D * D * D;
  const int threads = 256;
  dim3 grid((n_vox + threads - 1) / threads, B);
  warp_gather_kernel<T><<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const T*)images, (const float*)Ps, (const int32_t*)view_idx,
      (const float*)origins, (float*)colors, (uint8_t*)valid, H, W, D, s);
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
                               void* colors, void* valid, int H, int W, int B,
                               int D, float s, void* stream) {
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
