// Weight-only matmul over packed int4 weights with f32 x, on SIMT f32
// (#12's f32-x kernel; qmatmul_int4_weight_only.cu's header states its
// arithmetic):
//   y[M, N] = (sum over groups t of (x_lo_t . w_lo_t^T + x_hi_t . w_hi_t^T))
//             * s[N] (+ bias)
// A 128-thread block computes a 32 x 64 tile of y, 4 x 4 outputs a thread,
// over steps of 32 packed bytes (64 K columns). Each step stages the x
// columns of the low and the high nibbles (f32, k-major) and the two nibble
// planes of the weight tile (one 16-byte load a thread, converted to f32)
// in shared memory. At the end of each group the two partials are added
// into the accumulators.
//
// With res (non-null, [M, N] in TOut) the residual is added to the output
// rounded to TOut first: y = TOut(TOut(o) + res), #19's epilogue.
//
// Used by: qmatmul_int4_weight_only.cu and qmatmul_int4_blockwise.cu (f32
//   x of #12 and #13), qmatmul_int4_rmsnorm.cu (#14), qkv_rope.cu (#20)
//   and attention_oproj.cu (#19, with the residual) at f32 x.
#pragma once

#include "drq_common.cuh"

namespace aeqt {

constexpr int kWpBM = 32;
constexpr int kWpBN = 64;
constexpr int kWpBK = 32;  // packed bytes a step
constexpr int kWpThreads = (kWpBM / 4) * (kWpBN / 4);  // 128

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kWpThreads)
qmatmul_int4_wo_kernel(const TIn* __restrict__ x,
                       const uint8_t* __restrict__ w,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias,
                       TOut* __restrict__ out, int M, int N, int K,
                       int group, const TOut* __restrict__ res) {
  __shared__ __align__(16) float xlo[kWpBK][kWpBM + 4];
  __shared__ __align__(16) float xhi[kWpBK][kWpBM + 4];
  __shared__ __align__(16) float wlo[kWpBK][kWpBN + 4];
  __shared__ __align__(16) float whi[kWpBK][kWpBN + 4];
  const int tid = threadIdx.x;
  const int tm = tid / (kWpBN / 4);  // 0..7: rows tm*4 .. +3
  const int tn = tid % (kWpBN / 4);  // 0..15: cols tn*4 .. +3
  const int m0 = blockIdx.y * kWpBM;
  const int n0 = blockIdx.x * kWpBN;
  const int K2 = K / 2, g2 = group / 2;

  float y[4][4] = {};
  float plo[4][4] = {};
  float phi[4][4] = {};
  for (int j0 = 0; j0 < K2; j0 += kWpBK) {
    const int t = j0 / g2;
    const int klo = t * group + (j0 - t * g2);  // x column of byte j0's low
    const int khi = klo + g2;                   // ... and high nibble
    for (int e = tid; e < kWpBM * kWpBK; e += kWpThreads) {
      const int r = e / kWpBK, c = e % kWpBK;
      float lo = 0.0f, hi = 0.0f;
      if (m0 + r < M) {
        const size_t row = (size_t)(m0 + r) * K;
        lo = load_f(x, row + klo + c);
        hi = load_f(x, row + khi + c);
      }
      xlo[c][r] = lo;
      xhi[c][r] = hi;
    }
    {  // 64 weight rows x 32 bytes, 16 bytes a thread
      const int r = tid / 2, c = (tid % 2) * 16;
      const int4 v = __ldg(reinterpret_cast<const int4*>(
          w + (size_t)(n0 + r) * K2 + j0 + c));
      const int words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int byte = (words[q] >> (8 * b)) & 0xFF;
          wlo[c + 4 * q + b][r] = (float)(((byte & 0xF) ^ 8) - 8);
          whi[c + 4 * q + b][r] = (float)(((byte >> 4) ^ 8) - 8);
        }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kWpBK; ++kk) {
      const float4 al = *reinterpret_cast<const float4*>(&xlo[kk][tm * 4]);
      const float4 bl = *reinterpret_cast<const float4*>(&wlo[kk][tn * 4]);
      const float4 ah = *reinterpret_cast<const float4*>(&xhi[kk][tm * 4]);
      const float4 bh = *reinterpret_cast<const float4*>(&whi[kk][tn * 4]);
      const float alv[4] = {al.x, al.y, al.z, al.w};
      const float blv[4] = {bl.x, bl.y, bl.z, bl.w};
      const float ahv[4] = {ah.x, ah.y, ah.z, ah.w};
      const float bhv[4] = {bh.x, bh.y, bh.z, bh.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          plo[i][j] = __fmaf_rn(alv[i], blv[j], plo[i][j]);
          phi[i][j] = __fmaf_rn(ahv[i], bhv[j], phi[i][j]);
        }
    }
    __syncthreads();
    if ((j0 + kWpBK) % g2 == 0) {  // the end of group t
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float part = plo[i][j] + phi[i][j];
          y[i][j] = y[i][j] + part;
          plo[i][j] = 0.0f;
          phi[i][j] = 0.0f;
        }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + tm * 4 + i;
    if (m >= M) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tn * 4 + j;
      const size_t at = (size_t)m * N + n;
      float v = y[i][j] * scale[n];
      if (bias != nullptr) v = v + bias[n];
      if (res != nullptr) v = round_to(out, v) + load_f(res, at);
      store_f(out, at, v);
    }
  }
}

}  // namespace aeqt
