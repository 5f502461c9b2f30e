// Weight-only packed int4 matmul: y[M, N] = x . unpack(w[N, K/2])^T * s[N]
// (+ bias), x in its compute dtype, f32 sums, y stored in the compute dtype.
//
// Replaces: ai_edge_quantizer_tpu/kernels/pallas_qmatmul.py
//   qmatmul_pallas_int4_packed (_int4_channelwise_kernel). The JAX
//   executor's default (AEQT_INT4_DRQ=0) sends every packed channelwise int4
//   FC here: in the default-mode server the fused QKV (N 2560) and the
//   out-projection (N 2048) of each layer, K 2048.
//
// Bound on the H100: at decode rows (M = 64) the packed weight bytes, N*K/2
//   over 3.35 TB/s (about 0.8 us for the QKV weight); at a prefill pass's
//   rows (M = 1024) the operations, 2*M*N*K at the bf16 tensor-core peak
//   (11 us for QKV).
//
// Design: the low-nibble and the high-nibble halves are contracted in f32
//   and added, then y = acc * s (+ b), stored in the compute dtype (bf16 for
//   bf16 x, f32 otherwise), as the Pallas kernel does. bf16 x runs on the
//   bf16 tensor-core core int4_bf16_tc_gemm.cuh (policy ChannelScale: a
//   TMA ring of x and packed weight tiles, the weights widened in registers
//   into wgmma's A fragments, wgmma m64nNk16 against x in shared memory,
//   split-K in a cluster at decode; one launch, no scratch); f32 x on the
//   SIMT f32 kernel (qmatmul_int4_simt.cuh).
#include "int4_bf16_tc_gemm.cuh"
#include "qmatmul_int4_simt.cuh"

// N % 64 == 0 and K % 128 == 0 (int4_bf16_tc_gemm.cuh takes; the SIMT
// kernel's tiles of 64 columns and steps of 32 packed bytes fit them).
static bool takes(int M, int N, int K) {
  return aeqt::w4::takes(M, N, K, 0) && N % aeqt::kWpBN == 0;
}

// x [M, K] bf16 (x_bf16) or f32, 16-byte aligned; w [N, K/2] uint8
// split-half packed, 16-byte aligned; scale [N] f32; bias [N] f32 or null;
// out [M, N] in x's dtype. Takes N % 64 == 0 and K % 128 == 0; refuses
// any other shape with kShapeRefused before any launch.
extern "C" int aeqt_qmatmul_int4_weight_only(const void* x, int x_bf16,
                                             const void* w, const void* scale,
                                             const void* bias, void* out,
                                             int M, int N, int K,
                                             void* stream) {
  if (!takes(M, N, K)) return aeqt::kShapeRefused;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return aeqt::w4::run<aeqt::w4::ChannelScale>(x, w, scale, bias, out, M,
                                                 N, K, 0, s);
  const dim3 grid(N / aeqt::kWpBN, (M + aeqt::kWpBM - 1) / aeqt::kWpBM);
  aeqt::qmatmul_int4_wo_kernel<float, float><<<grid, aeqt::kWpThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const uint8_t*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<float*>(out), M, N, K, K, nullptr);
  return (int)cudaGetLastError();
}

// The launch the bf16 path gives this shape (int4_bf16_tc_gemm.cuh
// plan_fields: grid x, y, z, threads, shared memory, stages, tokens a tile),
// or kShapeRefused.
extern "C" int aeqt_qmatmul_int4_weight_only_plan(int M, int N, int K,
                                                  long long* fields) {
  if (!takes(M, N, K)) return aeqt::kShapeRefused;
  aeqt::w4::plan_fields<aeqt::w4::ChannelScale>(M, N, K, 0, fields);
  return 0;
}
