// Basic int8-cache decode attention: per-tensor scales, no zero points, f32
// in and out, masked by prefix lengths.
//
// Replaces: ai_edge_quantizer_tpu/kernels/pallas_attention.py
//   decode_attention_int8 (_decode_attn_kernel). For each (batch, kv-head)
//   row r with L = lengths[b] live cache rows:
//     s[g, j] = (q[g] . k[j]) * k_scale_eff, j < L   (k_scale / sqrt(H))
//     p       = exp(s - max_j s) / sum_j exp(s - max_j s)
//     ctx[g]  = (sum_j p[g, j] v[j]) * v_scale
//   The Pallas kernel scores all S rows and sets rows >= L to -1e30 (they
//   weigh exactly 0); with L == 0 each of the S rows weighs 1/S.
//
// Bound on the H100: the cache bytes of the live rows, 2 * L * H per row
//   (at Gemma-2B, H = 256, one KV head, B = 64, full rows: 33.5 MB, about
//   10 us at 3.35 TB/s).
//
// Design: the f32 lengths kernel of attention_lengths.cuh (#7) with both
//   zero points 0, one block of 256 threads per (batch, kv-head) row. With
//   finite sums of q, (acc - 0 * sum(q)) * k_scale_eff is acc * k_scale_eff
//   and (ctx - 0) * v_scale is ctx * v_scale, so the body computes this
//   kernel's function bit for bit; it is a launch of its own, with its own
//   entry point and launch count.
#include "attention_lengths.cuh"

// q f32 [R, G, H] with R = B * NK; k, v int8 [R, S, H]; lengths int32 [B];
// out f32 [R, G, H]; k_scale_eff = f32(k_scale) / f32(sqrt(H)). Returns
// aeqt::kShapeRefused unless H % 16 == 0, 1024 % H == 0 and the G x S
// scores fit in shared memory.
extern "C" int aeqt_attention_int8_basic(const void* q, const void* k,
                                         const void* v, const void* lengths,
                                         void* out, int R, int NK, int G,
                                         int S, int H, float k_scale_eff,
                                         float v_scale, void* stream) {
  return aeqt::launch_lengths_attention<float, aeqt::kF32>(
      q, k, v, lengths, out, R, NK, G, S, H, k_scale_eff, v_scale, 0.0f, 0.0f,
      static_cast<cudaStream_t>(stream));
}
