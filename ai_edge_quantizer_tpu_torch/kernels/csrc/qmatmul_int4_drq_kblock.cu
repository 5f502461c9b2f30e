// K-blocked int4 DRQ matmul:
//   y[M, N] = int8(x) . unpack(w[N, K/2])^T * xs[M] * s[N] (+ b)
//
// Replaces: ai_edge_quantizer_tpu/kernels/pallas_qmatmul.py
//   qmatmul_pallas_int4_packed_drq_kblock (_int4_drq_kblock_kernel). The
//   executor reaches it for a packed int4 FC with DRQ on and K > 8192: the
//   FFN down projections (K = 16384) of a graph whose MLP no fusion takes,
//   such as gemma_mixed48_hr's, where a Hadamard rotation sits between the
//   GeGLU product and the down FC.
//
// Arithmetic (the Pallas function's, bit for bit):
//   1. each row of x quantizes once, outside the contraction, as the JAX
//      function does it in XLA: xs = max(absmax, 1e-9) * (1/127) and
//      xq = rint(x / xs) -- a division, IEEE and rounded to nearest (the
//      library is built without fast math), where the non-blocked kernel
//      multiplies by the reciprocal;
//   2. xq[:, :K/2] contracts with the low nibbles and xq[:, K/2:] with the
//      high nibbles into one int32 sum, exact in any order (__dp4a);
//   3. y = (float(acc) * xs) * s, then + b, each rounded on its own
//      (--fmad=false), stored as bf16 for bf16 x, else f32.
//
// Bound on the H100: at decode (M = 64, N = 2048, K = 16384) the 16.8 MB of
//   packed weights dominate (about 5.7 us at 3.35 TB/s); at prefill
//   (M = 1024) the 2*M*N*K = 68.7 G int8 operations over the 1,979 TOP/s
//   tensor-core peak (about 35 us). This SIMT kernel does M*N*K/4 __dp4a,
//   so it is bound by its own instruction rate, far above both (tensor
//   cores, TMA and split-K are later work).
//
// Design (simple first): one launch quantizes every row (one block per row,
//   an exact absmax by shuffles and shared memory) into int8 scratch that
//   the wrapper allocates; a second launch contracts. Its block takes 16
//   rows x 32 columns and walks K in steps of 1024 packed bytes: it stages
//   the step's low-half and high-half codes of its 16 rows in shared memory
//   (32 KB), then each of its 8 warps walks 4 weight rows over the step --
//   lanes read 16-byte chunks, sign-extend the nibbles in registers and
//   accumulate with __dp4a (drq_common.cuh dot_packed) -- reduces by
//   shuffles and adds into lane r's running sum for row r. Staging a K-step
//   instead of whole rows is what lets K = 16384 run: the non-blocked
//   kernel's 16 staged rows of K would not fit shared memory. The M-tile is
//   the fastest grid dimension, so blocks that share a weight tile run
//   together and the tile comes from L2 after its first read. Rows past M
//   are staged as zeros and never stored.
#include "drq_common.cuh"

namespace aeqt {

constexpr int kKbBM = 16;
constexpr int kKbWarps = 8;
constexpr int kKbColsPerWarp = 4;
constexpr int kKbBN = kKbWarps * kKbColsPerWarp;
constexpr int kKbStep = 1024;  // packed bytes of K a block stages at once
constexpr int kQuantThreads = 256;

// Row m of x [M, K] -> xq[m, :] int8 and xs[m]: the Pallas function's
// xs = max(absmax, 1e-9) * (1/127), xq = rint(x / xs).
template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
quantize_rows_div_kernel(const T* __restrict__ x, int K,
                         int8_t* __restrict__ xq, float* __restrict__ xs) {
  __shared__ float part[kQuantThreads / 32];
  const size_t m = blockIdx.x;
  const T* src = x + m * K;
  float amax = 0.0f;
  for (int k = threadIdx.x; k < K; k += kQuantThreads)
    amax = fmaxf(amax, fabsf(load_f(src, k)));
  amax = warp_max(amax);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) part[warp] = amax;
  __syncthreads();
  amax = part[0];
#pragma unroll
  for (int w = 1; w < kQuantThreads / 32; ++w) amax = fmaxf(amax, part[w]);
  const float s = fmaxf(amax, 1e-9f) * kInv127;
  int8_t* dst = xq + m * K;
  for (int k = threadIdx.x; k < K; k += kQuantThreads)
    dst[k] = (int8_t)__float2int_rn(load_f(src, k) / s);
  if (threadIdx.x == 0) xs[m] = s;
}

template <typename TOut>
__global__ void __launch_bounds__(kKbWarps * 32)
qmatmul_int4_drq_kblock_kernel(const int8_t* __restrict__ xq,
                               const float* __restrict__ xs,
                               const uint8_t* __restrict__ w,
                               const float* __restrict__ scale,
                               const float* __restrict__ bias,
                               TOut* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) int8_t xlo[kKbBM * kKbStep];
  __shared__ __align__(16) int8_t xhi[kKbBM * kKbStep];
  const int m0 = blockIdx.x * kKbBM;
  const int n0 = blockIdx.y * kKbBN;
  const int k2 = K / 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int total[kKbColsPerWarp] = {};  // lane r: row m0 + r's running sums

  for (int kb = 0; kb < k2; kb += kKbStep) {
    const int step = min(kKbStep, k2 - kb);  // a multiple of 16
    const int chunks = step / 16;            // 16-byte chunks of a row
    __syncthreads();  // the previous step's reads are done
    for (int i = threadIdx.x; i < kKbBM * chunks; i += kKbWarps * 32) {
      const int r = i / chunks, j = (i % chunks) * 16;
      int4 lo = make_int4(0, 0, 0, 0), hi = lo;
      if (m0 + r < M) {
        const int8_t* row = xq + (size_t)(m0 + r) * K + kb + j;
        lo = *reinterpret_cast<const int4*>(row);
        hi = *reinterpret_cast<const int4*>(row + k2);
      }
      *reinterpret_cast<int4*>(xlo + r * step + j) = lo;
      *reinterpret_cast<int4*>(xhi + r * step + j) = hi;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kKbColsPerWarp; ++c) {
      const int n = n0 + warp * kKbColsPerWarp + c;
      if (n >= N) break;  // warp-uniform
      int acc[kKbBM] = {};
      dot_packed<kKbBM>(w + (size_t)n * k2 + kb, step, xlo, xhi, step, lane,
                        acc);
      warp_reduce_rows<kKbBM>(acc);
      total[c] += pick_row<kKbBM>(acc, lane);
    }
  }

  if (lane >= kKbBM || m0 + lane >= M) return;
  const float row_scale = xs[m0 + lane];
#pragma unroll
  for (int c = 0; c < kKbColsPerWarp; ++c) {
    const int n = n0 + warp * kKbColsPerWarp + c;
    if (n >= N) break;
    float y = ((float)total[c] * row_scale) * scale[n];
    if (bias != nullptr) y = y + bias[n];
    store_f(out, (size_t)(m0 + lane) * N + n, y);
  }
}

template <typename TIn, typename TOut>
int launch_kblock(const void* x, const void* w, const void* scale,
                  const void* bias, void* out, void* xq, void* xs, int M,
                  int N, int K, cudaStream_t stream) {
  quantize_rows_div_kernel<TIn><<<M, kQuantThreads, 0, stream>>>(
      static_cast<const TIn*>(x), K, static_cast<int8_t*>(xq),
      static_cast<float*>(xs));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + kKbBM - 1) / kKbBM, (N + kKbBN - 1) / kKbBN);
  qmatmul_int4_drq_kblock_kernel<TOut><<<grid, kKbWarps * 32, 0, stream>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
      static_cast<const uint8_t*>(w), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<TOut*>(out), M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace aeqt

// x [M, K] f32 or bf16 (x_bf16); w [N, K/2] uint8 split-half packed, rows
// 16-byte aligned; scale [N] f32; bias [N] f32 or null; out [M, N] bf16 for
// bf16 x, else f32; xq [M, K] int8 and xs [M] f32 scratch (the row codes
// and scales). Takes K % 32 == 0 (16-byte halves of each row), M < 2^31
// and N <= 65535 * 32; refuses any other shape with kShapeRefused.
extern "C" int aeqt_qmatmul_int4_drq_kblock(const void* x, int x_bf16,
                                            const void* w, const void* scale,
                                            const void* bias, void* out,
                                            void* xq, void* xs, int M, int N,
                                            int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 32 != 0 ||
      (N + aeqt::kKbBN - 1) / aeqt::kKbBN > 65535)
    return aeqt::kShapeRefused;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return aeqt::launch_kblock<__nv_bfloat16, __nv_bfloat16>(
        x, w, scale, bias, out, xq, xs, M, N, K, s);
  return aeqt::launch_kblock<float, float>(x, w, scale, bias, out, xq, xs, M,
                                           N, K, s);
}
