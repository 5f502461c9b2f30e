// RMS norm times gamma ahead of the weight-only packed int4 matmul:
//   xn = T(T(x * r) * T(gamma)), r = 1 / sqrt(mean(x^2) + eps)
//   y[M, N] = (xn_lo . w_lo^T + xn_hi . w_hi^T) * s[N] (+ bias), f32 sums,
//   stored in T (bf16 for bf16 x, else f32).
//
// Replaces: ai_edge_quantizer_tpu/kernels/pallas_qmatmul.py
//   qmatmul_pallas_int4_packed_rmsnorm (_int4_channelwise_norm_kernel), the
//   JAX executor's AEQT_NORM_FUSION: an RMS_NORM whose output feeds only
//   packed channelwise FCs folds into each of them. On bench.py's decode
//   (Gemma-2B, batch 256) that is the fused QKV (N 2560) and the gate/up
//   projection (N 32768) of every layer, K 2048. The fused FC is weight-only
//   whatever the DRQ setting, as in the JAX executor.
//
// Bound on the H100 at M 256, K 2048: the operations, 2 * M * N * K at the
//   989 TFLOP/s bf16 tensor-core peak: 2.7 us for QKV (the 2.6 MB of packed
//   weight take 0.8 us), 35 us for gate/up (33.6 MB, 10 us).
//
// Design: two launches on the caller's stream, each the one its unfused
//   part runs. (1) The norm (norm_rows.cuh, a block a row, the sum of
//   squares in f64) writes the M normalized rows in T to a scratch the
//   wrapper allocates (M * K * 2 bytes at bf16: 1 MiB at the bench shape,
//   read back from L2). (2) The contraction of the scratch against the
//   weight, exactly as the unfused weight-only FC (#12,
//   qmatmul_int4_weight_only.cu) runs it: bf16 x on the bf16 tensor-core
//   core int4_bf16_tc_gemm.cuh (policy ChannelScaleAfterNorm: #12's
//   ChannelScale as a programmatic dependent launch on the norm, whose
//   first weight stages load while the norm runs; the low and the high
//   halves sum apart and are added, where the TPU kernel adds them in its
//   own order: the f32 sums differ in order only); f32 x on #12's SIMT f32
//   kernel (qmatmul_int4_simt.cuh). The TPU kernel normalizes once into
//   VMEM and reuses it over its N-tiles; here the scratch plays that part.
#include <type_traits>

#include "int4_bf16_tc_gemm.cuh"
#include "norm_rows.cuh"
#include "qmatmul_int4_simt.cuh"

namespace {

// #12's shapes: N % 64 == 0 and K % 128 == 0 (the core's whole stages; the
// SIMT kernel's tiles of 64 columns and steps of 32 packed bytes).
bool takes(int M, int N, int K) {
  return aeqt::w4::takes(M, N, K, 0) && N % aeqt::kWpBN == 0;
}

template <typename T>
int run(const void* x, const float* gamma, const void* w, const void* scale,
        const void* bias, void* xn, void* out, int M, int N, int K, float eps,
        cudaStream_t stream) {
  int err = aeqt::launch_rmsnorm_rows<T, true>(x, gamma, xn, M, K, eps,
                                                stream);
  if (err != 0) return err;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return aeqt::w4::run<aeqt::w4::ChannelScaleAfterNorm>(
        xn, w, scale, bias, out, M, N, K, 0, stream);
  } else {
    const dim3 grid(N / aeqt::kWpBN, (M + aeqt::kWpBM - 1) / aeqt::kWpBM);
    aeqt::qmatmul_int4_wo_kernel<float, float>
        <<<grid, aeqt::kWpThreads, 0, stream>>>(
            static_cast<const float*>(xn), static_cast<const uint8_t*>(w),
            static_cast<const float*>(scale),
            static_cast<const float*>(bias), static_cast<float*>(out), M, N,
            K, K, nullptr);
    return (int)cudaGetLastError();
  }
}

}  // namespace

// x [M, K] bf16 (x_bf16) or f32; gamma [K] f32; w [N, K/2] uint8
// split-half packed, rows 16-byte aligned; scale [N] f32; bias [N] f32 or
// null; xn [M, K] scratch (16-byte aligned) and out [M, N], both in x's
// dtype. Takes N % 64 == 0 and K % 128 == 0; refuses any other shape with
// kShapeRefused before launching anything.
extern "C" int aeqt_qmatmul_int4_rmsnorm(const void* x, int x_bf16,
                                         const void* gamma, const void* w,
                                         const void* scale, const void* bias,
                                         void* xn, void* out, int M, int N,
                                         int K, float eps, void* stream) {
  if (!takes(M, N, K)) return aeqt::kShapeRefused;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  if (x_bf16)
    return run<__nv_bfloat16>(x, g, w, scale, bias, xn, out, M, N, K, eps, s);
  return run<float>(x, g, w, scale, bias, xn, out, M, N, K, eps, s);
}

// The launches of a shape (packed_qmatmul.RMSNORM_PLAN_FIELDS): the norm's
// grid and threads, then the contraction's grid x, y, z (split), threads,
// dynamic shared memory, ring stages and tokens a tile (the core's
// plan_fields for bf16 x; the SIMT kernel's grid, 1, its threads and 0 for
// f32 x); or kShapeRefused.
extern "C" int aeqt_qmatmul_int4_rmsnorm_plan(int M, int N, int K, int x_bf16,
                                              long long* fields) {
  if (!takes(M, N, K)) return aeqt::kShapeRefused;
  fields[0] = M;
  fields[1] = aeqt::kNormThreads;
  long long* f = fields + 2;
  if (x_bf16) {
    aeqt::w4::plan_fields<aeqt::w4::ChannelScaleAfterNorm>(M, N, K, 0, f);
    return 0;
  }
  f[0] = N / aeqt::kWpBN;
  f[1] = (M + aeqt::kWpBM - 1) / aeqt::kWpBM;
  f[2] = 1;
  f[3] = aeqt::kWpThreads;
  f[4] = 0;
  f[5] = 0;
  f[6] = aeqt::kWpBM;
  return 0;
}
