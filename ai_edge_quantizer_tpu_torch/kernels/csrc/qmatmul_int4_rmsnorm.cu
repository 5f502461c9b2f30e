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
// Design (simple first): two launches on the caller's stream. A norm
//   kernel (norm_rows.cuh, one warp a row) writes the M normalized rows in
//   T to a scratch the wrapper allocates (M * K * 2 bytes at bf16: 1 MiB at
//   the bench shape, read back from L2); then the weight-only tiles of
//   qmatmul_int4_weight_only.cuh (mma.sync bf16 with f32 sums for bf16 x,
//   the SIMT f32 kernel for f32 x) contract the scratch against the weight,
//   exactly as the unfused weight-only FC does. The TPU kernel normalizes
//   once into VMEM and reuses it over its N-tiles; here the scratch plays
//   that part. Normalizing a CTA's 16-row tile in shared memory inside the
//   matmul (no scratch, one launch) is later work.
#include "norm_rows.cuh"
#include "qmatmul_int4_weight_only.cuh"

namespace {

template <typename T>
int run(const void* x, const float* gamma, const void* w, const void* scale,
        const void* bias, void* xn, void* out, int M, int N, int K, float eps,
        cudaStream_t stream) {
  if (!aeqt::wo_shape_ok(M, N, K, K)) return aeqt::kShapeRefused;
  int err = aeqt::launch_rmsnorm_rows<T, true>(x, gamma, xn, M, K, eps,
                                                stream);
  if (err != 0) return err;
  return aeqt::launch_wo<T, T>(xn, w, scale, bias, out, M, N, K, K, nullptr,
                               stream);
}

}  // namespace

// x [M, K] bf16 (x_bf16) or f32; gamma [K] f32; w [N, K/2] uint8
// split-half packed, rows 16-byte aligned; scale [N] f32; bias [N] f32 or
// null; xn [M, K] scratch and out [M, N], both in x's dtype. Takes
// N % 64 == 0 and K % 128 == 0; refuses any other shape with
// kShapeRefused before launching anything.
extern "C" int aeqt_qmatmul_int4_rmsnorm(const void* x, int x_bf16,
                                         const void* gamma, const void* w,
                                         const void* scale, const void* bias,
                                         void* xn, void* out, int M, int N,
                                         int K, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  if (x_bf16)
    return run<__nv_bfloat16>(x, g, w, scale, bias, xn, out, M, N, K, eps, s);
  return run<float>(x, g, w, scale, bias, xn, out, M, N, K, eps, s);
}
