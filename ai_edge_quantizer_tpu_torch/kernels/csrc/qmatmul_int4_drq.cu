// int4 DRQ matmul: y[M, N] = int8(x) . unpack(w[N, K/2])^T * xs[M] * s[N] (+b)
//
// Replaces: ai_edge_quantizer_tpu/kernels/pallas_qmatmul.py
//   qmatmul_pallas_int4_packed_drq (_int4_drq_kernel). The executor reaches
//   it for a packed int4 FC with DRQ on and K <= 8192: the fused QKV
//   projection and the attention out-projection of each layer, at every
//   decode tick and every prefill pass.
//
// Arithmetic (the Pallas function's, bit for bit):
//   1. each row of x quantizes once: xs = max(absmax, 1e-9) * (1/127) and
//      xq = rint(x * (1 / xs)) -- the reciprocal, IEEE and rounded to
//      nearest (no fast math), as pallas_qmatmul.py:590-594;
//   2. xq[:, :K/2] contracts with the low nibbles and xq[:, K/2:] with the
//      high nibbles into one int32 sum, exact in any order and under
//      split-K;
//   3. y = (float(acc) * xs) * s, then + b, each rounded on its own
//      (--fmad=false), stored as bf16 for bf16 x, else f32.
//
// Bound on the H100: at decode (M = 64, N = 2560, K = 2048) the 2.6 MB of
//   packed weights (about 0.8 us at 3.35 TB/s), below two launches'
//   latency; at prefill (M = 1024) the 2*M*N*K = 10.7 G int8 operations
//   over the 1,979 TOP/s tensor-core peak (about 5.4 us).
//
// Design (int8_tc_gemm.cuh, policy SplitNibblesRecipB: #6's split-half
//   loader and unpack with #15's reciprocal row quantize): the quantize
//   pass writes the codes to int8 scratch; the contraction brings each
//   packed [128 columns, 128 bytes] tile by TMA with the 128-byte swizzle,
//   unpacks it in shared memory into a lo and a hi s8 tile and runs wgmma
//   m64n128k32 s8 against the codes at kb and at K/2 + kb. Decode's single
//   row of tiles splits K over a cluster (make_plan). #19
//   (attention_oproj.cu) runs these launches, and #20 (qkv_rope.cu) the
//   contraction at a head size its pair tile does not take.
#include "int8_tc_gemm.cuh"

static bool takes(int M, int N, int K) {
  return M > 0 && N > 0 && K > 0 && K % 32 == 0 &&
         (N + aeqt::tc::kBN - 1) / aeqt::tc::kBN <= 65535;
}

// x [M, K] f32 or bf16 (x_bf16); w [N, K/2] uint8 split-half packed, rows
// 16-byte aligned; scale [N] f32; bias [N] f32 or null; out [M, N] bf16 for
// bf16 x, else f32; xq [M, K] int8 and xs [M] f32 scratch (the row codes
// and scales). Takes K % 32 == 0 (16-byte halves of each row), any M and
// N up to 65535 * 128; refuses any other shape with kShapeRefused before
// any launch.
extern "C" int aeqt_qmatmul_int4_drq(const void* x, int x_bf16, const void* w,
                                     const void* scale, const void* bias,
                                     void* out, void* xq, void* xs, int M,
                                     int N, int K, void* stream) {
  using aeqt::tc::SplitNibblesRecipB;
  if (!takes(M, N, K)) return aeqt::kShapeRefused;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return aeqt::tc::run<SplitNibblesRecipB, __nv_bfloat16, __nv_bfloat16>(
        x, w, scale, bias, out, xq, xs, M, N, K, s);
  return aeqt::tc::run<SplitNibblesRecipB, float, float>(
      x, w, scale, bias, out, xq, xs, M, N, K, s);
}

// The launch aeqt_qmatmul_int4_drq gives this shape (int8_tc_gemm.cuh
// plan_fields), or kShapeRefused.
extern "C" int aeqt_qmatmul_int4_drq_plan(int M, int N, int K,
                                          long long* fields) {
  if (!takes(M, N, K)) return aeqt::kShapeRefused;
  aeqt::tc::plan_fields<aeqt::tc::SplitNibblesRecipB>(M, N, K, fields);
  return 0;
}
