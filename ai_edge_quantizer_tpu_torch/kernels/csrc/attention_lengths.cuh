// The lengths-masked int8 decode attention of attention_lengths.cu as a
// kernel template over the compute mode and the output type, shared with
// attention_oproj.cu (the attention of the out-projection epilogue, f32)
// and attention_int8_basic.cu (zero points 0). Its contract and design
// note are in attention_lengths.cu.
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
    float* srow = sc + (size_t)g * S;
    float m = kNegInf;
    for (int j = lane; j < L; j += 32) m = fmaxf(m, srow[j]);
    m = warp_max(m);
    float sum = 0.0f;
    for (int j = lane; j < L; j += 32) {
      const float p = expf(srow[j] - m);
      srow[j] = p;
      sum = sum + p;
    }
    sum = warp_sum(sum);
    float codes = 0.0f;  // int8: the sum of the probability codes (exact)
    for (int j = lane; j < L; j += 32) {
      const float p = prob_operand<C>(srow[j], sum);
      srow[j] = p;
      codes = codes + p;
    }
    if constexpr (C == kInt8) {
      codes = warp_sum(codes);
      if (lane == 0) qsum[g] = fmaxf(codes, 1.0f);
    }
  }
  __syncthreads();

  // Context: 4 head columns and one row group per thread.
  const int8_t* vr = v + (size_t)row * S * H;
  const int chunks = H / 4;
  const int RG = blockDim.x / chunks;
  const int c = threadIdx.x % chunks, rg = threadIdx.x / chunks;
  for (int g0 = 0; g0 < G; g0 += kGC) {
    float acc[kGC][4];
    context_rows(sc, S, G, g0, vr, H, L, rg, RG, c, acc);
    __syncthreads();  // the previous pass has read `red`
#pragma unroll
    for (int i = 0; i < kGC; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[((size_t)rg * kGC + i) * H + 4 * c + e] = acc[i][e];
    __syncthreads();
    for (int idx = threadIdx.x; idx < kGC * H; idx += blockDim.x) {
      const int i = idx / H, h = idx % H, g = g0 + i;
      if (g >= G) continue;
      float ctx = 0.0f;
      for (int r = 0; r < RG; ++r) ctx = ctx + red[((size_t)r * kGC + i) * H + h];
      store_f(out, ((size_t)row * G + g) * H + h,
              finish_ctx<C>(ctx, qsum[g], zp_v, v_scale));
    }
  }
}

template <typename TOut, int C = kF32>
int launch_lengths_attention(const void* q, const void* k, const void* v,
                             const void* lengths, void* out, int R, int NK,
                             int G, int S, int H, float k_scale_eff,
                             float v_scale, float zp_k, float zp_v,
                             cudaStream_t stream) {
  const size_t smem =
      ((size_t)G * H + (size_t)G * S + G + kRedFloats) * sizeof(float);
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

