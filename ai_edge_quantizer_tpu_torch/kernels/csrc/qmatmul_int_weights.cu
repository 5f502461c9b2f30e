// Weight-only integer matmul, f32 compute: y[M, N] = sum_b (x_b . w_b^T)
//   * s[N, b] (+ bias), x [M, K] f32, w [N, K] int8 container (int8, int4
//   or int2 values), s [N, K / bs] (blockwise) or [N] (channelwise, one
//   block of K).
//
// Replaces: ai_edge_quantizer_tpu/kernels/pallas_qmatmul.py qmatmul_pallas
//   (_channelwise_kernel, _blockwise_kernel). The executor reaches it for a
//   symmetric FC with blockwise scales (int4 blockwise-32 FFN and head FCs
//   of gemma_mixed48_b32: packed blockwise needs blocks of 128) and for a
//   non-DRQ channelwise one.
//
// Arithmetic (the Pallas kernel's): x and w are f32 operands (never bf16),
//   each block's partial dot p_b sums in f32, then y = y + p_b * s[n, b] in
//   block order, product and sum rounded on their own (--fmad=false), and
//   the bias is added after the last block. Channelwise is one block: y =
//   p * s[n] (0 + p*s = p*s exactly). Only the order of the f32 sum within
//   a block differs from the MXU's (explicit fmaf here), so the result
//   matches the plain version to rounding (int_qmatmul.py states the bound).
//
// Bound on the H100: decode rows (M = 64) read the int8 weights once (N*K
//   bytes over 3.35 TB/s, 0.16 ms for the 256128 x 2048 head), but the f32
//   FMAs (M*N*K at 33.5 T FMA/s outside the tensor cores, 1.0 ms for that
//   head) bound it: SIMT f32 is the slow unit here.
//
// Design (simple first): a 128-thread block computes a 32 x 64 tile of y,
//   4 x 4 outputs a thread, over K-tiles of 32 (a divisor of every block
//   size the quantizer makes: 32, 64, 128, 256). Each K-tile stages x
//   (transposed, f32) and w (converted to f32, transposed) in shared memory;
//   at the end of each quantization block the partial sums are scaled into
//   the accumulators and reset.
#include "drq_common.cuh"

namespace aeqt {

constexpr int kWoBM = 32;
constexpr int kWoBN = 64;
constexpr int kWoBK = 32;
constexpr int kWoThreads = (kWoBM / 4) * (kWoBN / 4);  // 128

__global__ void __launch_bounds__(kWoThreads)
qmatmul_int_weights_kernel(const float* __restrict__ x,
                           const int8_t* __restrict__ w,
                           const float* __restrict__ scale,
                           const float* __restrict__ bias,
                           float* __restrict__ out, int M, int N, int K,
                           int bs) {
  __shared__ __align__(16) float xs[kWoBK][kWoBM + 4];
  __shared__ __align__(16) float ws[kWoBK][kWoBN + 4];
  const int tid = threadIdx.x;
  const int tm = tid / (kWoBN / 4);   // 0..7: rows tm*4 .. +3
  const int tn = tid % (kWoBN / 4);   // 0..15: cols tn*4 .. +3
  const int m0 = blockIdx.y * kWoBM;
  const int n0 = blockIdx.x * kWoBN;
  const int nblocks = K / bs;

  float y[4][4] = {};
  float p[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kWoBK) {
    // x tile: 32 rows x 32 k, two float4 a thread, stored k-major.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = (tid + i * kWoThreads) * 4;  // element of the 32x32 tile
      const int r = e / kWoBK, c = e % kWoBK;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m0 + r < M)
        v = *reinterpret_cast<const float4*>(x + (size_t)(m0 + r) * K + k0 +
                                             c);
      xs[c][r] = v.x;
      xs[c + 1][r] = v.y;
      xs[c + 2][r] = v.z;
      xs[c + 3][r] = v.w;
    }
    // w tile: 64 rows x 32 k int8, 16 bytes a thread, stored k-major.
    {
      const int r = tid / 2, c = (tid % 2) * 16;
      const int4 v = __ldg(reinterpret_cast<const int4*>(
          w + (size_t)(n0 + r) * K + k0 + c));
      const int words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int b = 0; b < 4; ++b)
          ws[c + 4 * q + b][r] = (float)(int8_t)(words[q] >> (8 * b));
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kWoBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][tm * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][tn * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) p[i][j] = __fmaf_rn(av[i], bv[j], p[i][j]);
    }
    __syncthreads();
    if ((k0 + kWoBK) % bs == 0) {  // the end of quantization block b
      const int b = (k0 + kWoBK) / bs - 1;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float s = scale[(size_t)(n0 + tn * 4 + j) * nblocks + b];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float scaled = p[i][j] * s;
          y[i][j] = y[i][j] + scaled;
          p[i][j] = 0.f;
        }
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
      float v = y[i][j];
      if (bias != nullptr) v = v + bias[n];
      out[(size_t)m * N + n] = v;
    }
  }
}

}  // namespace aeqt

// x [M, K] f32; w [N, K] int8; scale [N, K / bs] f32 (bs = K for a
// channelwise scale [N]); bias [N] f32 or null; out [M, N] f32. Takes
// N % 64 == 0, K % 32 == 0, bs % 32 == 0 and K % bs == 0; refuses any
// other shape with kShapeRefused.
extern "C" int aeqt_qmatmul_int_weights(const void* x, const void* w,
                                        const void* scale, const void* bias,
                                        void* out, int M, int N, int K, int bs,
                                        void* stream) {
  using namespace aeqt;
  if (M <= 0 || N <= 0 || K <= 0 || bs <= 0 || N % kWoBN != 0 ||
      K % kWoBK != 0 || bs % kWoBK != 0 || K % bs != 0)
    return kShapeRefused;
  const dim3 grid(N / kWoBN, (M + kWoBM - 1) / kWoBM);
  qmatmul_int_weights_kernel<<<grid, kWoThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<float*>(out), M, N, K, bs);
  return (int)cudaGetLastError();
}
