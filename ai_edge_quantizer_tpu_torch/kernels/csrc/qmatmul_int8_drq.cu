// int8 DRQ matmul: y[M, N] = int8(x) . w[N, K]^T * xs[M] * s[N] (+ b)
//
// Replaces: ai_edge_quantizer_tpu/kernels/pallas_qmatmul.py
//   qmatmul_pallas_int8_drq (_int8_drq_kernel). The executor reaches it for
//   every symmetric per-channel integer FC (int8, or int4 values in int8
//   containers) that is not packed: the attention FCs of the gemma_mixed48
//   recipes, every FC of dynamic_wi8_afp32.
//
// Arithmetic (the Pallas kernel's, bit for bit): x is read as f32 (bf16
//   widens exactly), each row quantizes with xs = max(absmax, 1e-9) *
//   (1/127) and xq = rint(x * (1/xs)) (drq_common.cuh), the int8 products
//   sum exactly in int32 (__dp4a), and y = (f32(acc) * xs) * s (+ b), each
//   product rounded on its own (--fmad=false). Stored as bf16 for bf16 x,
//   else f32.
//
// Bound on the H100: at decode (M = 64, K = 2048, N = 2048 or 2560) the
//   weight bytes N*K dominate (about 1.6 us for N = 2560 at 3.35 TB/s); at
//   prefill (M = 1024) the 2*M*N*K int8 operations over the 1,979 TOP/s
//   tensor-core peak (about 11 us) bound it, which this SIMT kernel is far
//   from (tensor cores come later).
//
// Design (simple first), as qmatmul_int4_drq.cuh with int8 weight rows: a
//   block quantizes BM rows of x into shared memory, then each of its 8
//   warps walks 8 weight rows: lanes read 16-byte chunks (512 contiguous
//   bytes a warp), accumulate with __dp4a and reduce by shuffles. BM is 16
//   when 16 quantized rows of K fit the shared memory, else 8 or 4 (the FFN
//   down projection, K = 16384, takes 8). The M-tile is the fastest grid
//   dimension, so the blocks that share a weight tile run together and the
//   tile comes from L2 after its first read.
#include "drq_common.cuh"

namespace aeqt {

constexpr int kI8Warps = 8;
constexpr int kI8ColsPerWarp = 8;
constexpr int kI8BN = kI8Warps * kI8ColsPerWarp;

template <int BM, typename TIn, typename TOut>
__global__ void __launch_bounds__(kI8Warps * 32)
qmatmul_int8_drq_kernel(const TIn* __restrict__ x,
                        const int8_t* __restrict__ w,
                        const float* __restrict__ scale,
                        const float* __restrict__ bias,
                        TOut* __restrict__ out, int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* xq = reinterpret_cast<int8_t*>(smem);
  float* xs = reinterpret_cast<float*>(smem + (size_t)BM * K);
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * kI8BN;
  quantize_rows(x, M, K, m0, BM, xq, xs);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int c = 0; c < kI8ColsPerWarp; ++c) {
    const int n = n0 + warp * kI8ColsPerWarp + c;
    if (n >= N) break;  // warp-uniform
    int acc[BM] = {};
    dot_int8<BM>(w + (size_t)n * K, K, xq, K, lane, acc);
    warp_reduce_rows<BM>(acc);
    const int mine = pick_row<BM>(acc, lane);
    if (lane < BM && m0 + lane < M) {
      float y = ((float)mine * xs[lane]) * scale[n];
      if (bias != nullptr) y = y + bias[n];
      store_f(out, (size_t)(m0 + lane) * N + n, y);
    }
  }
}

template <int BM, typename TIn, typename TOut>
int launch(const void* x, const void* w, const void* scale, const void* bias,
           void* out, int M, int N, int K, cudaStream_t stream) {
  const size_t smem = (size_t)BM * K + BM * sizeof(float);
  auto* kernel = qmatmul_int8_drq_kernel<BM, TIn, TOut>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + BM - 1) / BM, (N + kI8BN - 1) / kI8BN);
  kernel<<<grid, kI8Warps * 32, smem, stream>>>(
      static_cast<const TIn*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<TOut*>(out), M, N, K);
  return (int)cudaGetLastError();
}

template <typename TIn, typename TOut>
int launch_rows(const void* x, const void* w, const void* scale,
                const void* bias, void* out, int M, int N, int K,
                cudaStream_t s) {
  if (smem_fits((size_t)16 * K + 16 * sizeof(float)))
    return launch<16, TIn, TOut>(x, w, scale, bias, out, M, N, K, s);
  if (smem_fits((size_t)8 * K + 8 * sizeof(float)))
    return launch<8, TIn, TOut>(x, w, scale, bias, out, M, N, K, s);
  if (smem_fits((size_t)4 * K + 4 * sizeof(float)))
    return launch<4, TIn, TOut>(x, w, scale, bias, out, M, N, K, s);
  return kShapeRefused;
}

}  // namespace aeqt

// x [M, K] f32 or bf16 (x_bf16); w [N, K] int8; scale [N] f32; bias [N]
// f32 or null; out [M, N] bf16 for bf16 x, else f32. Takes K % 16 == 0
// (16-byte rows) and 4 quantized rows of K in shared memory (K <= 58112
// on the H100); refuses any other shape with kShapeRefused.
extern "C" int aeqt_qmatmul_int8_drq(const void* x, int x_bf16, const void* w,
                                     const void* scale, const void* bias,
                                     void* out, int M, int N, int K,
                                     void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0) return aeqt::kShapeRefused;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return aeqt::launch_rows<__nv_bfloat16, __nv_bfloat16>(
        x, w, scale, bias, out, M, N, K, s);
  return aeqt::launch_rows<float, float>(x, w, scale, bias, out, M, N, K, s);
}
