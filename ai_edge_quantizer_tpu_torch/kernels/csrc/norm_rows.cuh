// RMS norm of the rows of x [M, K] into xn [M, K] in x's dtype, one block
// a row, for the kernels that fold a norm ahead of a packed int4 matmul
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
//
// A block of kNormThreads a row, as fused_block.cu's norm_quant_kernel:
// each thread sums its strided columns, the warps' sums meet in shared
// memory in warp order (one warp a row cost about 0.3 ms at 256 rows of
// 2048 in the fused block, a block a row 3.9 us on the H100). The kernel
// lets a programmatic dependent launch after it start at once: that
// launch waits for this grid (griddepcontrol.wait) before it reads xn.
#pragma once

#include "drq_common.cuh"

namespace aeqt {

constexpr int kNormThreads = 256;  // one row a block

template <typename T, bool kGammaInT>
__global__ void __launch_bounds__(kNormThreads)
rmsnorm_rows_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                    T* __restrict__ xn, int K, float eps) {
  __shared__ double part[kNormThreads / 32];
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const size_t m = blockIdx.x;
  const T* row = x + m * K;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  double ss = 0.0;
  for (int k = threadIdx.x; k < K; k += kNormThreads) {
    const double v = (double)load_f(row, k);
    ss += v * v;
  }
  ss = warp_sum_double(ss);
  if (lane == 0) part[warp] = ss;
  __syncthreads();
  ss = part[0];
#pragma unroll
  for (int w = 1; w < kNormThreads / 32; ++w) ss += part[w];
  const float var = (float)(ss / (double)K);
  const float r = 1.0f / sqrtf(var + eps);
  const T* tag = nullptr;
  T* out = xn + m * K;
  for (int k = threadIdx.x; k < K; k += kNormThreads) {
    const float v = load_f(row, k);
    float y;
    if (kGammaInT)
      y = round_to(tag, v * r) * round_to(tag, gamma[k]);
    else
      y = round_to(tag, v * round_to(tag, r)) * gamma[k];
    store_f(out, k, y);
  }
}

template <typename T, bool kGammaInT>
int launch_rmsnorm_rows(const void* x, const float* gamma, void* xn, int M,
                        int K, float eps, cudaStream_t stream) {
  rmsnorm_rows_kernel<T, kGammaInT><<<M, kNormThreads, 0, stream>>>(
      static_cast<const T*>(x), gamma, static_cast<T*>(xn), K, eps);
  return (int)cudaGetLastError();
}

}  // namespace aeqt
