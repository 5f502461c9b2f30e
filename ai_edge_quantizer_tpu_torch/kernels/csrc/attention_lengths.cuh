// The lengths-masked int8 decode attention of attention_lengths.cu as a
// kernel template over the compute mode and the output type, shared with
// attention_oproj.cu (the attention of the out-projection epilogue, in its
// mode) and attention_int8_basic.cu (f32, zero points 0). Its contract and
// design note are in attention_lengths.cu.
#pragma once

#include "attention_common.cuh"

namespace aeqt {

template <int C, typename TOut>
__global__ void __launch_bounds__(kAttnThreads)
lengths_attention_kernel(const float* __restrict__ q,
                         const int8_t* __restrict__ k,
                         const int8_t* __restrict__ v,
                         const int* __restrict__ lengths,
                         TOut* __restrict__ out, int NK, int G, int S, int H,
                         float k_scale_eff, float v_scale, float zp_k,
                         float zp_v) {
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;                          // [G][H]
  float* sc = qs + (size_t)G * H;          // [G][S] scores, then probs
  float* qsum = sc + (size_t)G * S;        // [G] sum(q), then p_sum (int8)
  float* red = qsum + G;                   // [RG][kGC][H] context partials
  const int row = blockIdx.x;
  const int b = row / NK;
  const int len = lengths[b];
  const bool none = len <= 0;  // every TPU score is -1e30
  const int L = none ? S : min(len, S);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;

  const float* qr = q + (size_t)row * G * H;
  for (int i = threadIdx.x; i < G * H; i += blockDim.x) qs[i] = qr[i];
  __syncthreads();

  prepare_queries<C>(qs, qsum, red, G, H);
  __syncthreads();

  // Scores: one thread per live cache row.
  const int8_t* kr = k + (size_t)row * S * H;
  for (int j = threadIdx.x; j < L; j += blockDim.x) {
    const int8_t* krow = kr + (size_t)j * H;
    for (int g0 = 0; g0 < G; g0 += kGC) {
      float s[kGC];
      if (!none)
        score_rows<C>(qs, qsum, red, G, H, g0, krow, zp_k, k_scale_eff, s);
#pragma unroll
      for (int i = 0; i < kGC; ++i)
        if (g0 + i < G) sc[(size_t)(g0 + i) * S + j] = none ? kNegInf : s[i];
    }
  }
  __syncthreads();

  // Softmax over the L live scores: one warp per query row.
  for (int g = warp; g < G; g += nwarps) {
    const float codes = softmax_row<C>(sc + (size_t)g * S, L, kNegInf, lane);
    if constexpr (C == kInt8)
      if (lane == 0) qsum[g] = fmaxf(codes, 1.0f);
  }
  __syncthreads();

  context_phase<C>(sc, qsum, red, G, S, H, L, v + (size_t)row * S * H,
                   nullptr, -1, out + (size_t)row * G * H, zp_v, v_scale);
}

template <typename TOut, int C>
int launch_lengths_attention(const void* q, const void* k, const void* v,
                             const void* lengths, void* out, int R, int NK,
                             int G, int S, int H, float k_scale_eff,
                             float v_scale, float zp_k, float zp_v,
                             cudaStream_t stream) {
  const size_t smem = scores_smem_floats(G, S, H) * sizeof(float);
  if (!head_dim_fits(H) || !compute_fits(C, G, H) || !smem_fits(smem))
    return kShapeRefused;
  auto* kernel = lengths_attention_kernel<C, TOut>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<R, kAttnThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), static_cast<const int*>(lengths),
      static_cast<TOut*>(out), NK, G, S, H, k_scale_eff, v_scale, zp_k, zp_v);
  return (int)cudaGetLastError();
}

}  // namespace aeqt

