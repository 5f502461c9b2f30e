// Decode attention over an int8 KV cache that reads only the live prefix
// (f32 compute).
//
// Replaces: ai_edge_quantizer_tpu/kernels/pallas_attention.py
//   decode_attention_int8_dynlen. The JAX executor runs it for each decode
//   attention under AEQT_ATTN_DYNLEN=1 (with AEQT_ATTN_LENGTHS off): 18 a
//   server tick for Gemma-2B. The TPU kernel takes (batch, kv-head) rows in
//   blocks of rb and streams n_chunks = clip(ceil(max length in the block /
//   c), 1, S / c) chunks for each; per row and chunk ci (rows [ci*c, +c)):
//     s  = (q . k - zp_k * sum(q)) * k_scale_eff, -1e30 where pos >= len
//     m' = max(m, max_j s);  a = exp(m - m');  p = exp(s - m')
//     l  = a * l + sum_j p;  acc = acc * a + p . v;  m = m'
//   from m = -1e30, l = 0, acc = 0; then ctx = (acc / max(l, 1e-30) - zp_v)
//   * v_scale, f32.
//
// A row of length 0 (a server's idle slot) scores -1e30 everywhere, so m
//   stays -1e30 and every one of its n_chunks * c rows gets p = 1: its
//   context is the mean of that many V rows, a count set by the longest
//   row in its row block. This kernel reproduces that: each CTA finds its
//   row block's longest row, and a zero-length row reads n_chunks * c V
//   rows. A row of length L > 0 gains nothing from a chunk past L (there
//   m' = m, a = 1, p = 0 exactly), so no row at or past L is read.
//
// Bound on the H100: the K and V bytes of the live rows (2 * L * H a row,
//   n_chunks * c * H for a zero-length row's V) over 3.35 TB/s.
//
// Design: attention_split_tc.cuh. The S rows of a (batch, kv-head) row are
//   split across a cluster of CTAs sized by the occupancy query (3 at a
//   batch of 64 and S 1024); a CTA streams only the live rows of its
//   slice through its ring (none past L: it still joins the cluster's
//   barriers). With the row's maximum m over the
//   cluster, e = exp(s - m) needs no rescaling: l is the cluster's sum of
//   e, acc the sum of e . v over the slices in split order, and a chunk
//   past L adds exactly 0, as in the online form; on a row of length > 0
//   the two differ only by rounding.
#include "attention_split_tc.cuh"

namespace {

using aeqt::split::Args;
using aeqt::split::Kernel;

template <int H, int NTS>
__global__ void __launch_bounds__(aeqt::split::kThreads, 2)
dynlen_attention_kernel(const Args a) {
  aeqt::split::attend<aeqt::split::kDynlen, aeqt::kF32, H, NTS>(a);
}

// The kernel of a head dim and query-row count; nullptr for a shape the
// kernels do not take.
Kernel kernel_for(int R, int G, int S, int H) {
  if (!aeqt::split::takes(aeqt::split::kDynlen, aeqt::kF32, R, G, S, H))
    return nullptr;
  const bool two = G > 8;  // query rows in two n-tiles
  switch (H) {
    case 64:
      return two ? &dynlen_attention_kernel<64, 2>
                 : &dynlen_attention_kernel<64, 1>;
    case 128:
      return two ? &dynlen_attention_kernel<128, 2>
                 : &dynlen_attention_kernel<128, 1>;
    case 256:
      return two ? &dynlen_attention_kernel<256, 2>
                 : &dynlen_attention_kernel<256, 1>;
  }
  return nullptr;
}

aeqt::split::Plan plan_of(Kernel kernel, int R, int G, int S, int H) {
  return aeqt::split::choose_plan(
      kernel, aeqt::split::Int8Smem{aeqt::split::kDynlen, aeqt::kF32, G, H},
      S, R);
}

}  // namespace

// q f32 [R, G, H] with R = B * NK; k, v int8 [R, S, H]; lengths int32 [B];
// out f32 [R, G, H]; c, rb the TPU kernel's chunk and row block (the
// wrapper forms them as it does). Returns aeqt::kShapeRefused unless H is
// 64, 128 or 256, G <= 16, R <= 65535, S % c == 0, R % rb == 0 and a CTA's
// shared memory fits.
extern "C" int aeqt_attention_dynlen(const void* q, const void* k,
                                     const void* v, const void* lengths,
                                     void* out, int R, int NK, int G, int S,
                                     int H, int c, int rb, float k_scale_eff,
                                     float v_scale, float zp_k, float zp_v,
                                     void* stream) {
  const Kernel kernel = kernel_for(R, G, S, H);
  if (kernel == nullptr || c <= 0 || S % c != 0 || rb <= 0 || R % rb != 0)
    return aeqt::kShapeRefused;
  Args a = {};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const int8_t*>(k);
  a.v = static_cast<const int8_t*>(v);
  a.out = out;
  a.lengths = static_cast<const int*>(lengths);
  a.c = c;
  a.rb = rb;
  a.NK = NK;
  a.G = G;
  a.S = S;
  a.ks = k_scale_eff;
  a.v_scale = v_scale;
  a.zp_k = zp_k;
  a.zp_v = zp_v;
  return aeqt::split::launch(kernel, a, plan_of(kernel, R, G, S, H), R,
                             static_cast<cudaStream_t>(stream));
}

// The launch of a shape (chip_smoke.SPLIT_PLAN_FIELDS).
extern "C" int aeqt_attention_dynlen_plan(int R, int G, int S, int H,
                                          long long* fields) {
  const Kernel kernel = kernel_for(R, G, S, H);
  if (kernel == nullptr) return aeqt::kShapeRefused;
  aeqt::split::plan_fields(plan_of(kernel, R, G, S, H), R, fields);
  return 0;
}
