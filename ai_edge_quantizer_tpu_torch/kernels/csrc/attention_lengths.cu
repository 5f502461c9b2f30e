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
//   all S V rows (and no K row), the same function. It is the masked
//   kernel's arithmetic (#17) with a prefix mask.
//
// Bound on the H100: the cache bytes of the live rows, 2 * L * H per
//   (batch, kv-head) row over 3.35 TB/s: at Gemma-2B (H = 256, one KV head,
//   G = 8) with B = 64 and full rows (L = 1024) that is 33.5 MB, about
//   10 us.
//
// Design: attention_split_tc.cuh, the lengths form (`attend<kLengths, C>`):
//   the S rows of a (batch, kv-head) row split across a cluster of CTAs
//   sized by the occupancy query (3 at a batch of 64 and S 1024), each
//   streaming the live rows of its 128-row chunks through a two-stage ring
//   of bulk copies (a CTA past L copies none and still joins the cluster's
//   barriers); bf16 and int8 scores and every mode's context on the tensor
//   cores; the softmax's maxima and sums, and the context partials, meet in
//   distributed shared memory in split order. The f32 mode's q . k is one
//   FMA chain a score in increasing h, the plain version's order on the
//   card (the header says why), its context summed a k-step at a time.
//   The output is f32 or bf16, rounded once at the write.
//
// Shapes the core does not take (H other than 64, 128 or 256, G > 16,
//   R > 65535, or a slice's scores past shared memory) go, by that fixed
//   rule, to the one-block kernel of attention_lengths.cuh (one block of
//   256 threads a row, the G x S scores in shared memory), which takes any
//   H with 1024 % H == 0 while the scores fit. The launch lives in
//   attention_lengths.cuh (aeqt::lengths), shared with #19 and #22.
#include "attention_lengths.cuh"

// q f32 [R, G, H] with R = B * NK; k, v int8 [R, S, H]; lengths int32 [B];
// out [R, G, H] f32 or bf16 (out_bf16); compute aeqt::kF32, kBF16 or kInt8.
// The split core where it takes the shape, else the one-block kernel;
// returns aeqt::kShapeRefused (nothing launched) where neither does: the
// one-block kernel needs H % 16 == 0, 1024 % H == 0, the G x S scores in
// shared memory and (int8) G * H / 4 + G <= aeqt::kRedFloats.
extern "C" int aeqt_attention_lengths(const void* q, const void* k,
                                      const void* v, const void* lengths,
                                      void* out, int out_bf16, int compute,
                                      int R, int NK, int G, int S, int H,
                                      float k_scale_eff, float v_scale,
                                      float zp_k, float zp_v, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return aeqt::with_compute(compute, [&](auto mode) {
    return aeqt::lengths::launch<decltype(mode)::value>(
        q, k, v, lengths, out, out_bf16, R, NK, G, S, H, k_scale_eff,
        v_scale, zp_k, zp_v, s);
  });
}

// The launch of a shape (chip_smoke.SPLIT_PLAN_FIELDS: cluster size, rows,
// cache rows a CTA, threads, shared memory); a shape on the one-block
// kernel gives cluster 0, R blocks of all S rows and its shared memory.
extern "C" int aeqt_attention_lengths_plan(int R, int G, int S, int H,
                                           int compute, long long* fields) {
  return aeqt::with_compute(compute, [&](auto mode) {
    return aeqt::lengths::plan_fields<decltype(mode)::value>(R, G, S, H,
                                                             fields);
  });
}
