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
// Design: #7's f32 lengths kernel with both zero points 0. With finite
//   sums of q, (acc - 0 * sum(q)) * k_scale_eff is acc * k_scale_eff and
//   (ctx - 0) * v_scale is ctx * v_scale, so #7's f32 form computes this
//   kernel's function bit for bit; it is a launch of its own, with its own
//   entry point and launch count.
//   Where the split core takes the shape (attention_split_tc.cuh, the
//   lengths form `attend<kLengths, kF32>`: H 64, 128 or 256, G <= 16,
//   R <= 65535, a slice's scores in shared memory), a (batch, kv-head)
//   row's S rows split across a cluster of CTAs sized by the occupancy
//   query, each streaming the live rows of its 128-row chunks through a
//   ring of bulk copies; the scores are one f32 FMA chain a score in
//   increasing h (the plain version's order on the card), the maxima, sums
//   and context partials meet in distributed shared memory in split order.
//   Other shapes go, by that fixed rule, to #7's one-block kernel of
//   attention_lengths.cuh (one block of 256 threads a row, the G x S
//   scores in shared memory), which takes any H with 1024 % H == 0 while
//   the scores fit. The launch is #7's (attention_lengths.cuh,
//   aeqt::lengths::launch) at compute kF32.
#include "attention_lengths.cuh"

// q f32 [R, G, H] with R = B * NK; k, v int8 [R, S, H]; lengths int32 [B];
// out f32 [R, G, H]; k_scale_eff = f32(k_scale) / f32(sqrt(H)). The split
// core where it takes the shape, else the one-block kernel; returns
// aeqt::kShapeRefused (nothing launched) where neither does: the one-block
// kernel needs H % 16 == 0, 1024 % H == 0 and the G x S scores in shared
// memory.
extern "C" int aeqt_attention_int8_basic(const void* q, const void* k,
                                         const void* v, const void* lengths,
                                         void* out, int R, int NK, int G,
                                         int S, int H, float k_scale_eff,
                                         float v_scale, void* stream) {
  return aeqt::lengths::launch<aeqt::kF32>(
      q, k, v, lengths, out, 0, R, NK, G, S, H, k_scale_eff, v_scale, 0.0f,
      0.0f, static_cast<cudaStream_t>(stream));
}

// The launch of a shape (chip_smoke.SPLIT_PLAN_FIELDS: cluster size, rows,
// cache rows a CTA, threads, shared memory); a shape on the one-block
// kernel gives cluster 0, R blocks of all S rows and its shared memory.
extern "C" int aeqt_attention_int8_basic_plan(int R, int G, int S, int H,
                                              long long* fields) {
  return aeqt::lengths::plan_fields<aeqt::kF32>(R, G, S, H, fields);
}
