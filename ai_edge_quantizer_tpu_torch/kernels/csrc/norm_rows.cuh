// RMS norm of the rows of x [M, K] into xn [M, K] in x's dtype, one block
// a row, for the kernels that fold a norm ahead of a packed int4 matmul
// (qmatmul_int4_rmsnorm.cu, qkv_rope.cu); and the same norm ending in the
// row's DRQ codes (qkv_rope.cu's DRQ route).
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
// rmsnorm_quant_rows_kernel then quantizes xn (the second rounding) as
// the DRQ matmuls do: xs = max(absmax(xn), 1e-9) * (1/127), xq =
// rint(xn * (1 / xs)), writing xq [M, K] int8 and xs [M] f32 and no xn.
//
// A block of kNormThreads a row, as fused_block.cu's norm_quant_kernel:
// each thread sums its strided columns, the warps' sums meet in shared
// memory in warp order (one warp a row cost about 0.3 ms at 256 rows of
// 2048 in the fused block, a block a row 3.9 us on the H100). The quantize
// passes over the row again from L1 (xn recomputed, the same arithmetic).
// The kernels let a programmatic dependent launch after them start at
// once: that launch waits for this grid (griddepcontrol.wait) before it
// reads xn or the codes.
#pragma once

#include "drq_common.cuh"

namespace aeqt {

constexpr int kNormThreads = 256;  // one row a block

// The row's r (above) from row m of x, the block's threads summing its
// strided columns; every thread returns it. part: kNormThreads / 32
// doubles of shared memory.
template <typename T>
__device__ __forceinline__ float row_rms_inverse(const T* row, int K,
                                                 float eps, double* part) {
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
  return 1.0f / sqrtf(var + eps);
}

// xn[k] of a row, r its row_rms_inverse.
template <typename T, bool kGammaInT>
__device__ __forceinline__ float norm_value(const T* row, const float* gamma,
                                            int k, float r) {
  const T* tag = nullptr;
  const float v = load_f(row, k);
  if (kGammaInT)
    return round_to(tag, round_to(tag, v * r) * round_to(tag, gamma[k]));
  return round_to(tag, round_to(tag, v * round_to(tag, r)) * gamma[k]);
}

template <typename T, bool kGammaInT>
__global__ void __launch_bounds__(kNormThreads)
rmsnorm_rows_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                    T* __restrict__ xn, int K, float eps) {
  __shared__ double part[kNormThreads / 32];
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const size_t m = blockIdx.x;
  const T* row = x + m * K;
  const float r = row_rms_inverse(row, K, eps, part);
  T* out = xn + m * K;
  for (int k = threadIdx.x; k < K; k += kNormThreads)
    store_f(out, k, norm_value<T, kGammaInT>(row, gamma, k, r));
}

// The norm (the unfused op's rounding), then the row's DRQ codes.
template <typename T>
__global__ void __launch_bounds__(kNormThreads)
rmsnorm_quant_rows_kernel(const T* __restrict__ x,
                          const float* __restrict__ gamma, int K, float eps,
                          int8_t* __restrict__ xq, float* __restrict__ xs) {
  __shared__ double part[kNormThreads / 32];
  __shared__ float part_max[kNormThreads / 32];
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const size_t m = blockIdx.x;
  const T* row = x + m * K;
  const float r = row_rms_inverse(row, K, eps, part);
  float amax = 0.0f;
  for (int k = threadIdx.x; k < K; k += kNormThreads)
    amax = fmaxf(amax, fabsf(norm_value<T, false>(row, gamma, k, r)));
  amax = warp_max(amax);
  if ((threadIdx.x & 31) == 0) part_max[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = part_max[0];
#pragma unroll
  for (int w = 1; w < kNormThreads / 32; ++w) amax = fmaxf(amax, part_max[w]);
  const float s = fmaxf(amax, 1e-9f) * kInv127;
  const float inv = 1.0f / s;
  int8_t* dst = xq + m * K;
  for (int k = threadIdx.x; k < K; k += kNormThreads)
    dst[k] = (int8_t)__float2int_rn(norm_value<T, false>(row, gamma, k, r) *
                                    inv);
  if (threadIdx.x == 0) xs[m] = s;
}

template <typename T, bool kGammaInT>
int launch_rmsnorm_rows(const void* x, const float* gamma, void* xn, int M,
                        int K, float eps, cudaStream_t stream) {
  rmsnorm_rows_kernel<T, kGammaInT><<<M, kNormThreads, 0, stream>>>(
      static_cast<const T*>(x), gamma, static_cast<T*>(xn), K, eps);
  return (int)cudaGetLastError();
}

// xq [M, K] int8 (16-byte aligned, K % 16 == 0 for the matmul's TMA) and
// xs [M] f32 from x [M, K].
template <typename T>
int launch_rmsnorm_quant_rows(const void* x, const float* gamma, void* xq,
                              void* xs, int M, int K, float eps,
                              cudaStream_t stream) {
  rmsnorm_quant_rows_kernel<T><<<M, kNormThreads, 0, stream>>>(
      static_cast<const T*>(x), gamma, K, eps, static_cast<int8_t*>(xq),
      static_cast<float*>(xs));
  return (int)cudaGetLastError();
}

}  // namespace aeqt
