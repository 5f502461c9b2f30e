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
//   (1/127) and xq = rint(x * (1/xs)), the int8 products sum exactly in
//   int32, and y = (f32(acc) * xs) * s (+ b), each product rounded on its
//   own (--fmad=false). Stored as bf16 for bf16 x, else f32.
//
// Bound on the H100: at decode (M = 64, K = 2048, N = 2048 or 2560) the
//   weight bytes N*K dominate (about 1.6 us for N = 2560 at 3.35 TB/s); at
//   prefill (M = 1024) the 2*M*N*K int8 operations over the 1,979 TOP/s
//   tensor-core peak (about 5.4 us for the QKV FC).
//
// Design (int8_tc_gemm.cuh, policy Int8RowsB): one pass quantizes each row
//   once into int8 scratch (the Pallas kernel quantizes in its kernel; the
//   SIMT version before this one did so again for every 64 columns); the
//   contraction runs wgmma m64n128k32 s8 tiles fed by a TMA ring, both
//   operands K-major as they lie in memory. Decode's single row of tiles
//   splits K so that every SM streams weights.
#include "int8_tc_gemm.cuh"

static bool takes(int M, int N, int K) {
  return M > 0 && N > 0 && K > 0 && K % 16 == 0 &&
         (N + aeqt::tc::kBN - 1) / aeqt::tc::kBN <= 65535;
}

// x [M, K] f32 or bf16 (x_bf16); w [N, K] int8, 16-byte aligned; scale [N]
// f32; bias [N] f32 or null; out [M, N] bf16 for bf16 x, else f32; xq
// [M, K] int8 and xs [M] f32 scratch (the row codes and scales). Takes
// K % 16 == 0 (16-byte rows for TMA), any M and N up to 65535 * 128;
// refuses any other shape with kShapeRefused before any launch.
extern "C" int aeqt_qmatmul_int8_drq(const void* x, int x_bf16, const void* w,
                                     const void* scale, const void* bias,
                                     void* out, void* xq, void* xs,
                                     int M, int N, int K, void* stream) {
  using aeqt::tc::Int8RowsB;
  if (!takes(M, N, K)) return aeqt::kShapeRefused;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return aeqt::tc::run<Int8RowsB, __nv_bfloat16, __nv_bfloat16>(
        x, w, scale, bias, out, xq, xs, M, N, K, s);
  return aeqt::tc::run<Int8RowsB, float, float>(x, w, scale, bias, out, xq,
                                                xs, M, N, K, s);
}

// The launch aeqt_qmatmul_int8_drq gives this shape (int8_tc_gemm.cuh
// plan_fields: grid x, y, z, threads, shared memory, stages), or
// kShapeRefused.
extern "C" int aeqt_qmatmul_int8_drq_plan(int M, int N, int K,
                                          long long* fields) {
  if (!takes(M, N, K)) return aeqt::kShapeRefused;
  aeqt::tc::plan_fields<aeqt::tc::Int8RowsB>(M, N, K, fields);
  return 0;
}
