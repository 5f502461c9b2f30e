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
//
// The weight-only (bf16) branches, drq=False (the JAX executor's default,
//   AEQT_INT4_DRQ=0, for the packed int4 head; int8 weights by direct call):
//   x is rounded to bf16 whatever its dtype (by the caller), the weights
//   are taken as bf16 values (int4 and int8 values are exact there), and
//   the products sum in f32: a packed row's low-nibble and high-nibble
//   halves each in f32, then added (pallas_head.py:77-91). Each logit is
//   acc * s, rounded to the activation dtype, and compared as above.
//   Bound: the weight stream again (the packed head, 256128 x 1024 bytes =
//   262 MB, about 78 us; the bf16 work of M = 64 rows, 2*M*N*K = 67 GFLOP,
//   68 us at the bf16 tensor-core peak).
//   Design: a warp takes 16 rows x 64 vocab columns on tensor cores, the
//   weight-only matmul's tile (aeqt::wo_mma_tile, mma.sync with f32 sums,
//   qmatmul_int4_weight_only.cuh), rounds its logits, and reduces each
//   row's 64 to one (max, first index) pair by shuffles; then the
//   reduction launch of the DRQ branch.
#include <limits.h>

#include "qmatmul_int4_weight_only.cuh"

namespace {

constexpr int kBM = 16;
constexpr int kWarps = 8;
constexpr int kColsPerWarp = 8;
constexpr int kBN = kWarps * kColsPerWarp;
constexpr float kNegInf = -3.4e38f;  // pallas_head._NEG_INF
static_assert(kBN == aeqt::kMmaBN, "one pmax column a tile in both branches");

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

// The weight-only branch's tiles: warp `tile` of the grid takes vocab
// columns [64 * tile, +64) of rows [16 * blockIdx.x, +16) and writes each
// row's best (logit, first index) to pmax/pidx [M, tiles].
template <bool kPacked>
__global__ void __launch_bounds__(aeqt::kMmaWarps * 32)
head_tiles_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                       const uint8_t* __restrict__ w,
                       const float* __restrict__ scale,
                       float* __restrict__ pmax, int* __restrict__ pidx,
                       int M, int N, int K, int true_n, int cast_bf16,
                       int tiles) {
  const int tile = blockIdx.y * aeqt::kMmaWarps + (threadIdx.x >> 5);
  const int n0 = tile * aeqt::kMmaBN;
  if (n0 >= N) return;  // warp-uniform; no block-wide barrier below
  const int m0 = blockIdx.x * aeqt::kMmaBM;
  float y[aeqt::kMmaNT][4];
  aeqt::wo_mma_tile<kPacked>(x, w, M, N, K, K, m0, n0, 0,
                             kPacked ? K / 2 : K, y);
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {  // rows gid and gid + 8
    float bv = -INFINITY;
    int bi = INT_MAX;
#pragma unroll
    for (int nt = 0; nt < aeqt::kMmaNT; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {  // columns rise with (nt, c)
        const int n = n0 + 8 * nt + 2 * tig + c;
        if (n >= N) continue;
        float v = y[nt][2 * half + c] * scale[n];
        if (cast_bf16) v = __bfloat162float(__float2bfloat16_rn(v));
        if (n >= true_n) v = kNegInf;
        if (better(v, n, bv, bi)) {
          bv = v;
          bi = n;
        }
      }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {  // the row's four lanes
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    const int m = m0 + gid + 8 * half;
    if (tig == 0 && m < M) {
      pmax[(size_t)m * tiles + tile] = bv;
      pidx[(size_t)m * tiles + tile] = bi;
    }
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

// The weight-only branch (drq=False): x [M, K] bf16 (rounded by the
// caller); w, scale, pmax, pidx, ids as above; cast_bf16 rounds each logit
// to bf16. Takes K % 128 == 0 (packed) or K % 64 == 0 (int8), else
// kShapeRefused (nothing launched).
extern "C" int aeqt_head_argmax_bf16(const void* x, const void* w, int packed,
                                     const void* scale, void* pmax,
                                     void* pidx, void* ids, int M, int N,
                                     int K, int true_n, int cast_bf16,
                                     void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 ||
      K % (packed ? 2 * aeqt::kMmaChunk : aeqt::kMmaChunk) != 0)
    return aeqt::kShapeRefused;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (N + kBN - 1) / kBN;  // kBN == aeqt::kMmaBN
  const dim3 grid((M + aeqt::kMmaBM - 1) / aeqt::kMmaBM,
                  (tiles + aeqt::kMmaWarps - 1) / aeqt::kMmaWarps);
  auto* kernel = packed ? head_tiles_bf16_kernel<true>
                        : head_tiles_bf16_kernel<false>;
  kernel<<<grid, aeqt::kMmaWarps * 32, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(w),
      static_cast<const float*>(scale), static_cast<float*>(pmax),
      static_cast<int*>(pidx), M, N, K, true_n, cast_bf16, tiles);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  head_reduce_kernel<<<M, 256, 0, s>>>(static_cast<const float*>(pmax),
                                       static_cast<const int*>(pidx), tiles,
                                       static_cast<int*>(ids));
  return (int)cudaGetLastError();
}
