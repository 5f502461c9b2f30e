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
// Design: the split-half layout is one group of K columns of the shared
//   weight-only kernels (qmatmul_int4_weight_only.cuh): the low-nibble and
//   the high-nibble halves are contracted in f32 and added, then
//   y = acc * s (+ b), stored in the compute dtype (bf16 for bf16 x, f32
//   otherwise), as the Pallas kernel does. bf16 x runs on tensor cores
//   (mma.sync, f32 sums), f32 x on the SIMT f32 kernel.
#include "qmatmul_int4_weight_only.cuh"

// x [M, K] bf16 (x_bf16) or f32; w [N, K/2] uint8 split-half packed, rows
// 16-byte aligned; scale [N] f32; bias [N] f32 or null; out [M, N] in x's
// dtype. Takes N % 64 == 0 and K % 128 == 0; refuses any other shape with
// kShapeRefused.
extern "C" int aeqt_qmatmul_int4_weight_only(const void* x, int x_bf16,
                                             const void* w, const void* scale,
                                             const void* bias, void* out,
                                             int M, int N, int K,
                                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return aeqt::launch_wo<__nv_bfloat16, __nv_bfloat16>(
        x, w, scale, bias, out, M, N, K, K, nullptr, s);
  return aeqt::launch_wo<float, float>(x, w, scale, bias, out, M, N, K, K,
                                       nullptr, s);
}
