// Greedy head: ids[m] = argmax_n (int8(x[m]) . w[n] * xs[m] * s[n]),
// without writing the [M, N] logits.
//
// Replaces: ai_edge_quantizer_tpu/kernels/pallas_head.py head_argmax_pallas
//   (_head_argmax_kernel), DRQ branches: int8 weights [N, K] (the tied
//   Gemma embedding head) and split-half packed int4 weights [N, K/2].
//
// Bound on the H100: the weight stream. Gemma-2B's head is 256128 x 2048
//   int8 = 525 MB, about 157 us at 3.35 TB/s; the int8 work at M = 64 is
//   67 GOP, 34 us at the 1,979 TOP/s peak.
//
// Design (simple first): two launches, deterministic.
//   1. A block takes 16 rows x 64 vocab columns: DRQ of its rows into
//      shared memory, one warp per column with lanes on 16-byte chunks and
//      __dp4a into exact int32 sums (as the int4 DRQ matmul). Each logit is
//      (float(acc) * xs) * s, rounded to the activation dtype and back (the
//      Pallas kernel's cast_dt, so bf16 runs agree with the unfused path),
//      and columns >= true_n become -3.4e38. Each block writes one
//      (max, first index) pair per row.
//   2. One block per row reduces the per-block pairs: the larger value
//      wins, and among equal values the smaller index, so ties go to the
//      first index across tiles as jnp.argmax does.
#include <limits.h>

#include "drq_common.cuh"

namespace {

constexpr int kBM = 16;
constexpr int kWarps = 8;
constexpr int kColsPerWarp = 8;
constexpr int kBN = kWarps * kColsPerWarp;
constexpr float kNegInf = -3.4e38f;  // pallas_head._NEG_INF

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

template <typename T, bool kPacked>
__global__ void __launch_bounds__(kWarps * 32)
head_tiles_kernel(const T* __restrict__ x, const void* __restrict__ w,
                  const float* __restrict__ scale, float* __restrict__ pmax,
                  int* __restrict__ pidx, int M, int N, int K, int true_n,
                  int cast_bf16) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* xq = reinterpret_cast<int8_t*>(smem);
  float* xs = reinterpret_cast<float*>(smem + (size_t)kBM * K);
  float* red_v = xs + kBM;                                  // [kWarps][kBM]
  int* red_i = reinterpret_cast<int*>(red_v + kWarps * kBM);  // [kWarps][kBM]
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  aeqt::quantize_rows(x, M, K, m0, kBM, xq, xs);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float best_v = -INFINITY;
  int best_i = INT_MAX;
  for (int c = 0; c < kColsPerWarp; ++c) {
    const int n = n0 + warp * kColsPerWarp + c;
    if (n >= N) break;
    int acc[kBM] = {};
    if (kPacked) {
      const int k2 = K / 2;
      aeqt::dot_packed<kBM>(static_cast<const uint8_t*>(w) + (size_t)n * k2,
                            k2, xq, xq + k2, K, lane, acc);
    } else {
      aeqt::dot_int8<kBM>(static_cast<const int8_t*>(w) + (size_t)n * K, K,
                          xq, K, lane, acc);
    }
    aeqt::warp_reduce_rows<kBM>(acc);
    const int mine = aeqt::pick_row<kBM>(acc, lane);
    if (lane < kBM) {
      float y = ((float)mine * xs[lane]) * scale[n];
      if (cast_bf16) y = __bfloat162float(__float2bfloat16_rn(y));
      if (n >= true_n) y = kNegInf;
      if (y > best_v) {  // columns rise with c: strict > keeps the first
        best_v = y;
        best_i = n;
      }
    }
  }
  if (lane < kBM) {
    red_v[warp * kBM + lane] = best_v;
    red_i[warp * kBM + lane] = best_i;
  }
  __syncthreads();
  if (threadIdx.x < kBM && m0 + threadIdx.x < M) {
    const int r = threadIdx.x;
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int wi = 0; wi < kWarps; ++wi) {
      const float v = red_v[wi * kBM + r];
      const int i = red_i[wi * kBM + r];
      if (better(v, i, bv, bi)) {
        bv = v;
        bi = i;
      }
    }
    pmax[(size_t)(m0 + r) * gridDim.y + blockIdx.y] = bv;
    pidx[(size_t)(m0 + r) * gridDim.y + blockIdx.y] = bi;
  }
}

__global__ void __launch_bounds__(256)
head_reduce_kernel(const float* __restrict__ pmax, const int* __restrict__ pidx,
                   int nblk, int* __restrict__ ids) {
  __shared__ float sv[256];
  __shared__ int si[256];
  const int m = blockIdx.x;
  float bv = -INFINITY;
  int bi = INT_MAX;
  for (int j = threadIdx.x; j < nblk; j += blockDim.x) {
    const float v = pmax[(size_t)m * nblk + j];
    const int i = pidx[(size_t)m * nblk + j];
    if (better(v, i, bv, bi)) {
      bv = v;
      bi = i;
    }
  }
  sv[threadIdx.x] = bv;
  si[threadIdx.x] = bi;
  __syncthreads();
  for (int o = blockDim.x / 2; o > 0; o >>= 1) {
    if (threadIdx.x < o &&
        better(sv[threadIdx.x + o], si[threadIdx.x + o], sv[threadIdx.x],
               si[threadIdx.x])) {
      sv[threadIdx.x] = sv[threadIdx.x + o];
      si[threadIdx.x] = si[threadIdx.x + o];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) ids[m] = si[0] == INT_MAX ? 0 : si[0];
}

template <typename T, bool kPacked>
int launch_tiles(const void* x, const void* w, const void* scale, void* pmax,
                 void* pidx, int M, int N, int K, int true_n, int cast_bf16,
                 cudaStream_t stream) {
  const size_t smem = (size_t)kBM * K + kBM * sizeof(float) +
                      (size_t)kWarps * kBM * (sizeof(float) + sizeof(int));
  auto* kernel = head_tiles_kernel<T, kPacked>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(x), w, static_cast<const float*>(scale),
      static_cast<float*>(pmax), static_cast<int*>(pidx), M, N, K, true_n,
      cast_bf16);
  return (int)cudaGetLastError();
}

}  // namespace

// x [M, K] f32 or bf16 (x_bf16); w int8 [N, K] or packed uint8 [N, K/2]
// (packed); scale [N] f32; pmax f32 / pidx int32 scratch [M, tiles(N)];
// ids int32 [M]. K % 32 == 0; 16-byte aligned weight rows.
extern "C" int aeqt_head_argmax(const void* x, int x_bf16, const void* w,
                                int packed, const void* scale, void* pmax,
                                void* pidx, void* ids, int M, int N, int K,
                                int true_n, int cast_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (x_bf16) {
    err = packed ? launch_tiles<__nv_bfloat16, true>(x, w, scale, pmax, pidx,
                                                     M, N, K, true_n,
                                                     cast_bf16, s)
                 : launch_tiles<__nv_bfloat16, false>(x, w, scale, pmax, pidx,
                                                      M, N, K, true_n,
                                                      cast_bf16, s);
  } else {
    err = packed ? launch_tiles<float, true>(x, w, scale, pmax, pidx, M, N, K,
                                             true_n, cast_bf16, s)
                 : launch_tiles<float, false>(x, w, scale, pmax, pidx, M, N,
                                              K, true_n, cast_bf16, s);
  }
  if (err != 0) return err;
  const int nblk = (N + kBN - 1) / kBN;
  head_reduce_kernel<<<M, 256, 0, s>>>(static_cast<const float*>(pmax),
                                       static_cast<const int*>(pidx), nblk,
                                       static_cast<int*>(ids));
  return (int)cudaGetLastError();
}
