// Decode attention over a stale (pre-write) int8 KV cache plus the new
// token's k/v row as one inline softmax column, in the f32, bf16 or int8
// compute mode.
//
// Replaces: ai_edge_quantizer_tpu/kernels/pallas_attention.py
//   decode_attention_int8_lengths_stale (_ctx_prefix_len_cur, its three
//   compute branches; the modes' operands are at the top of
//   attention_common.cuh).
//   For each (batch, kv-head) row r with L = clip(lengths[b] - 1, 0, S)
//   stale rows:
//     s[g, j]  = (q[g] . k[j] - zp_k * sum(q[g])) * k_scale_eff, j < L
//     s_cur[g] = (q[g] . k_new - zp_k * sum(q[g])) * k_scale_eff
//     p = softmax over [s[g, :L], s_cur[g]]
//     ctx[g]   = ((sum_j p[g, j] v[j] + p_cur[g] v_new) - zp_v) * v_scale
//   where k_scale_eff = k_scale / sqrt(H) is formed by the caller. Rows at
//   index >= L are masked in the TPU kernel (exp underflows to exactly 0),
//   so this kernel does not read them at all. With L = 0 the new column is
//   the only weight: ctx = v_new (no 1 / S spread, unlike the lengths
//   form).
//
// Bound on the H100: the cache bytes of the live rows, 2 * L * H per
//   (batch, kv-head) row over 3.35 TB/s: at Gemma-2B (H = 256, one KV head)
//   with B = 64 and full rows (L = 1023) that is 33.5 MB, about 10 us.
//
// Design: attention_split_tc.cuh, the stale form (`attend<kStale, C>`): the
//   lengths form's schedule (#7) over the L stale rows (a CTA whose slice
//   lies past L copies nothing and still joins the cluster's barriers),
//   with the new column apart from the cache rows. Every CTA of a row's
//   cluster forms s_cur itself while its first chunks are in flight (G
//   dots of H, k_new staged in shared memory; f32 and bf16 in the order of
//   the plain version's one-column matmul on the card, int8 exact in
//   int32) and needs no exchange for it: the maximum takes s_cur after the
//   cluster's maxima, the denominator e_cur after the slices' sums (added
//   in split order; int8 inside the f64 sum), and the output p_cur's
//   operand times v_new after the cluster's context partials (int8: its
//   code in int32, and into the code sum), in the plain version's order.
//
// Shapes the core does not take (H other than 64, 128 or 256, G > 16,
//   R > 65535, or a slice's scores past shared memory) go, by that fixed
//   rule, to the one-block kernel (attention_stale.cuh, with the split
//   kernels and the launch that the fused decode block shares): one block
//   of 256 threads per (batch, kv-head) row (the G query rows staged in
//   shared memory, one
//   thread a cache row for the scores, one warp a query row for the
//   softmax, 4 head columns and a row group a thread for the context, the
//   new column last). Its body is aeqt::stale_attention_row
//   (attention_common.cuh); it takes any H with 1024 % H == 0 while the
//   G x S scores fit.
#include "attention_stale.cuh"

// q f32 [R, G, H] with R = B * NK; k, v int8 [R, S, H]; k_new, v_new int8
// [R, H]; lengths int32 [B] (counting the new token); out [R, G, H] f32 or
// bf16 (out_bf16); compute aeqt::kF32, kBF16 or kInt8. The split core where
// it takes the shape, else the one-block kernel; returns
// aeqt::kShapeRefused (nothing launched) where neither does: the one-block
// kernel needs H % 16 == 0, 1024 % H == 0, the G x S scores in shared
// memory and (int8) G * H / 4 + G <= aeqt::kRedFloats.
extern "C" int aeqt_attention_stale(const void* q, const void* k,
                                    const void* v, const void* k_new,
                                    const void* v_new, const void* lengths,
                                    void* out, int out_bf16, int compute,
                                    int R, int NK, int G, int S, int H,
                                    float k_scale_eff, float v_scale,
                                    float zp_k, float zp_v, void* stream) {
  return aeqt::stale::run(q, k, v, k_new, v_new, lengths, out, out_bf16,
                          compute, R, NK, G, S, H, k_scale_eff, v_scale, zp_k,
                          zp_v, stream);
}

// The launch of a shape (chip_smoke.SPLIT_PLAN_FIELDS; see
// aeqt::stale::plan).
extern "C" int aeqt_attention_stale_plan(int R, int G, int S, int H,
                                         int compute, long long* fields) {
  return aeqt::stale::plan(R, G, S, H, compute, fields);
}
