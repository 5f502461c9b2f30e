// Decode attention over an int8 KV cache masked by prefix lengths, in the
// f32, bf16 or int8 compute mode.
//
// Replaces: ai_edge_quantizer_tpu/kernels/pallas_attention.py
//   decode_attention_int8_lengths (_ctx_prefix_len, its three compute
//   branches; the modes' operands are at the top of attention_common.cuh).
//   For each
//   (batch, kv-head) row r with L = lengths[b] live cache rows:
//     s[g, j] = (q[g] . k[j] - zp_k * sum(q[g])) * k_scale_eff, j < L
//     p       = exp(s - max_j s) / sum_j exp(s - max_j s)
//     ctx[g]  = (sum_j p[g, j] v[j] - zp_v) * v_scale
//   where k_scale_eff = k_scale / sqrt(H) is formed by the caller. The TPU
//   kernel streams all S rows and sets the scores of rows >= L to -1e30;
//   after the max subtraction those rows add exactly 0, so this kernel
//   does not read them. With L == 0 every TPU score is -1e30, the max is
//   -1e30 and each of the S rows gets weight 1/S: the kernel then reads
//   all S rows with the score -1e30, the same function.
//
// Bound on the H100: the cache bytes of the live rows, 2 * L * H per
//   (batch, kv-head) row over 3.35 TB/s: at Gemma-2B (H = 256, one KV head,
//   G = 8) with B = 64 and full rows (L = 1024) that is 33.5 MB, about
//   10 us. The f32 work (4 * G * L * H per row) is 1/8 of a byte-bound
//   kernel's time at the 67 TFLOP/s f32 peak. In int8 the score dot runs
//   on __dp4a (four products an instruction); the context stays f32 SIMT
//   on the codes, whose sums are exact integers.
//
// Design (simple first): the stale kernel (attention_stale.cu) without its
//   inline column, on the shared helpers of attention_common.cuh. One block
//   of 256 threads per (batch, kv-head) row; scores one thread per live
//   cache row, four 16-byte loads in flight; softmax one warp per query row
//   (max, exp, sum, divide, in the TPU kernel's order); context 4 head
//   columns and one row group per thread, the row groups' partial sums
//   added in a fixed order, so the result does not depend on timing.
//
// The kernel is in attention_lengths.cuh (shared with attention_oproj.cu).
#include "attention_lengths.cuh"

namespace {

template <typename TOut>
int launch(int compute, const void* q, const void* k, const void* v,
           const void* lengths, void* out, int R, int NK, int G, int S, int H,
           float k_scale_eff, float v_scale, float zp_k, float zp_v,
           cudaStream_t s) {
  return aeqt::with_compute(compute, [&](auto mode) {
    return aeqt::launch_lengths_attention<TOut, decltype(mode)::value>(
        q, k, v, lengths, out, R, NK, G, S, H, k_scale_eff, v_scale, zp_k,
        zp_v, s);
  });
}

}  // namespace

// q f32 [R, G, H] with R = B * NK; k, v int8 [R, S, H]; lengths int32 [B];
// out [R, G, H] f32 or bf16 (out_bf16); compute aeqt::kF32, kBF16 or kInt8.
// Returns aeqt::kShapeRefused unless H % 16 == 0, 1024 % H == 0, the G x S
// scores fit in shared memory and (int8) G * H / 4 + G <= aeqt::kRedFloats.
extern "C" int aeqt_attention_lengths(const void* q, const void* k,
                                      const void* v, const void* lengths,
                                      void* out, int out_bf16, int compute,
                                      int R, int NK, int G, int S, int H,
                                      float k_scale_eff, float v_scale,
                                      float zp_k, float zp_v, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    return launch<__nv_bfloat16>(compute, q, k, v, lengths, out, R, NK, G, S,
                                 H, k_scale_eff, v_scale, zp_k, zp_v, s);
  return launch<float>(compute, q, k, v, lengths, out, R, NK, G, S, H,
                       k_scale_eff, v_scale, zp_k, zp_v, s);
}
