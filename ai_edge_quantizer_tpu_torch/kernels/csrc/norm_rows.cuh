// RMS norm of the rows of x [M, K] into xn [M, K] in x's dtype, one warp a
// row, for the kernels that fold a norm ahead of a packed int4 matmul
// (qmatmul_int4_rmsnorm.cu, qkv_rope.cu).
//
//   r = 1 / sqrt(var + eps), var = mean(x^2) with the sum of squares taken
//   in f64 (each square is exact there) and rounded to f32 once, as
//   ops/impl.py `rms_inverse` takes it; then, with T the dtype of x
//   (bf16 or f32) and T(v) the rounding of v to it:
//   * kGammaInT (pallas_qmatmul._int4_channelwise_norm_kernel):
//       xn = T(T(x * r) * T(gamma))
//   * otherwise (pallas_qkv._qkv_rope_kernel, the unfused RMS_NORM op's
//     rounding): xn = T(T(x * T(r)) * gamma)
// For f32 both are (x * r) * gamma. Every product is rounded on its own
// (the library is built with --fmad=false).
#pragma once

#include "drq_common.cuh"

namespace aeqt {

constexpr int kNormThreads = 256;  // 8 rows a block

__device__ __forceinline__ float round_as(const float*, float v) { return v; }
__device__ __forceinline__ float round_as(const __nv_bfloat16*, float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T, bool kGammaInT>
__global__ void __launch_bounds__(kNormThreads)
rmsnorm_rows_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                    T* __restrict__ xn, int M, int K, float eps) {
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * (kNormThreads / 32) + (threadIdx.x >> 5);
  if (m >= M) return;  // warp-uniform
  const T* row = x + (size_t)m * K;
  double ss = 0.0;
  for (int k = lane; k < K; k += 32) {
    const double v = (double)load_f(row, k);
    ss += v * v;
  }
  ss = warp_sum_double(ss);
  const float var = (float)(ss / (double)K);
  const float r = 1.0f / sqrtf(var + eps);
  const T* tag = nullptr;
  T* out = xn + (size_t)m * K;
  for (int k = lane; k < K; k += 32) {
    const float v = load_f(row, k);
    float y;
    if (kGammaInT)
      y = round_as(tag, v * r) * round_as(tag, gamma[k]);
    else
      y = round_as(tag, v * round_as(tag, r)) * gamma[k];
    store_f(out, k, y);
  }
}

template <typename T, bool kGammaInT>
int launch_rmsnorm_rows(const void* x, const float* gamma, void* xn, int M,
                        int K, float eps, cudaStream_t stream) {
  const int rows = kNormThreads / 32;
  rmsnorm_rows_kernel<T, kGammaInT><<<(M + rows - 1) / rows, kNormThreads, 0,
                                      stream>>>(
      static_cast<const T*>(x), gamma, static_cast<T*>(xn), M, K, eps);
  return (int)cudaGetLastError();
}

}  // namespace aeqt
