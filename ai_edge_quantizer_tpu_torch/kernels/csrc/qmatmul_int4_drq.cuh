// SIMT int4 DRQ matmul tiles: y[M, N] = int8(x) . unpack(w[N, K/2])^T *
// xs[M] * s[N] (+b), the arithmetic of pallas_qmatmul.py
// qmatmul_pallas_int4_packed_drq (_int4_drq_kernel).
//
// Used by #20 qkv_rope.cu (the QKV projection after the norm), the one
//   kernel that still fuses this matmul with other work. The stand-alone
//   #1 (qmatmul_int4_drq.cu), the MLP's gate/up (#3 mlp_int4_drq.cu) and
//   #19's out projection (attention_oproj.cu) run on the int8 tensor-core
//   core (int8_tc_gemm.cuh) instead.
//
// Bound on the H100: at decode shapes (M = batch = 64, K = 2048) the
//   weight bytes dominate: N*K/2 + M*K*2 + M*N*2 bytes over 3.35 TB/s
//   (about 0.8 us for QKV, N = 2560). The int8 work (2*M*N*K) is far below
//   the 1,979 TOP/s peak.
//
// Design (simple first): a block takes 16 rows x 64 columns. It quantizes
//   its 16 rows of x into shared memory with the Pallas formula, then each
//   of its 8 warps walks 8 weight rows: lanes read 16-byte chunks (a warp
//   reads 512 contiguous bytes), sign-extend the nibbles in registers and
//   accumulate with __dp4a into exact int32 sums, reduced by shuffles. The
//   M-tile is the fastest grid dimension, so the blocks that share a weight
//   tile run together and the tile comes from L2 after its first read. The
//   epilogue computes (float(acc) * xs) * s (+ b) in that order, so the
//   result is bit-equal to the plain version.
#pragma once

#include "drq_common.cuh"

namespace aeqt {

constexpr int kQmmBM = 16;
constexpr int kQmmWarps = 8;
constexpr int kQmmColsPerWarp = 8;
constexpr int kQmmBN = kQmmWarps * kQmmColsPerWarp;

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kQmmWarps * 32)
qmatmul_int4_drq_kernel(const TIn* __restrict__ x,
                        const uint8_t* __restrict__ w,
                        const float* __restrict__ scale,
                        const float* __restrict__ bias,
                        TOut* __restrict__ out, int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* xq = reinterpret_cast<int8_t*>(smem);
  float* xs = reinterpret_cast<float*>(smem + (size_t)kQmmBM * K);
  const int m0 = blockIdx.x * kQmmBM;
  const int n0 = blockIdx.y * kQmmBN;
  quantize_rows(x, M, K, m0, kQmmBM, xq, xs);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k2 = K / 2;
  for (int c = 0; c < kQmmColsPerWarp; ++c) {
    const int n = n0 + warp * kQmmColsPerWarp + c;
    if (n >= N) break;  // warp-uniform
    int acc[kQmmBM] = {};
    dot_packed<kQmmBM>(w + (size_t)n * k2, k2, xq, xq + k2, K, lane, acc);
    warp_reduce_rows<kQmmBM>(acc);
    const int mine = pick_row<kQmmBM>(acc, lane);
    if (lane < kQmmBM && m0 + lane < M) {
      float y = ((float)mine * xs[lane]) * scale[n];
      if (bias != nullptr) y = y + bias[n];
      store_f(out, (size_t)(m0 + lane) * N + n, y);
    }
  }
}

inline size_t qmatmul_smem_bytes(int K) {
  return (size_t)kQmmBM * K + kQmmBM * sizeof(float);
}

template <typename TIn, typename TOut>
int launch_qmatmul(const void* x, const void* w, const void* scale,
                   const void* bias, void* out, int M, int N, int K,
                   cudaStream_t stream) {
  const size_t smem = qmatmul_smem_bytes(K);
  auto* kernel = qmatmul_int4_drq_kernel<TIn, TOut>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + kQmmBM - 1) / kQmmBM, (N + kQmmBN - 1) / kQmmBN);
  kernel<<<grid, kQmmWarps * 32, smem, stream>>>(
      static_cast<const TIn*>(x), static_cast<const uint8_t*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<TOut*>(out), M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace aeqt
