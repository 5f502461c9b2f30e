// Decode attention over an int8 KV cache with an additive mask, in the
// f32, bf16 or int8 compute mode.
//
// Replaces: ai_edge_quantizer_tpu/kernels/pallas_attention.py
//   decode_attention_int8_masked (_decode_attn_mask_kernel,
//   _decode_attn_mask_kernel_bf16 and _decode_attn_mask_kernel_int8: the
//   compute modes' operands are at the top of attention_common.cuh), which
//   the JAX executor's default (AEQT_ATTN_LENGTHS=0) runs at every decode
//   step. For each (batch, kv-head) row r over all S cache rows:
//     s[g, j] = ((q[g] . k[j] - zp_k * sum(q[g])) * k_scale_eff) + mask[g, j]
//     p       = exp(s - max_j s) / sum_j exp(s - max_j s)
//     ctx[g]  = (sum_j p[g, j] v[j] - zp_v) * v_scale
//   in that order, where k_scale_eff = k_scale / sqrt(H) is formed by the
//   caller; the probabilities are divided by their sum before the PV
//   product (and rounded to the mode's operand after it), as the TPU kernel
//   does. The mask decides which rows count, so every row is read; a row
//   whose mask is -1e9 everywhere gets uniform weights (its scores are all
//   equal after the add; in int8 each code is rint(127 / S), 0 at S 1024,
//   so p_sum is 1 and ctx is -zp_v * v_scale), one that is -inf everywhere
//   gives NaN, as on the TPU.
//
// Bound on the H100: the cache bytes, 2 * S * H per (batch, kv-head) row,
//   plus the mask as the caller gives it: at Gemma-2B (H = 256, one KV head,
//   G = 8) with B = 64 and S = 1024 that is 33.5 MB of K/V, about 10 us at
//   3.35 TB/s.
//
// Design: attention_split_tc.cuh. The S rows of a (batch, kv-head) row are
//   split across a cluster of CTAs sized by the occupancy query (3 at a
//   batch of 64 and S 1024), each streaming its 128-row chunks through a
//   two-stage ring of bulk copies; scores and context on the tensor cores
//   (bf16 / fp16 mma.sync, s8 in int8 mode); the softmax's
//   maxima and sums, and the context partials, meet in distributed shared
//   memory in split order. The mask element is added beside its score after
//   the scale, addressed by strides (a mask broadcast over kv heads or
//   query rows is never copied).
#include "attention_split_tc.cuh"

namespace {

using aeqt::split::Args;
using aeqt::split::Kernel;

template <int C, int H, int NTS>
__global__ void __launch_bounds__(aeqt::split::kThreads, 2)
masked_attention_kernel(const Args a) {
  aeqt::split::attend<aeqt::split::kMasked, C, H, NTS>(a);
}

template <int C>
Kernel kernel_for(int H, int G) {
  const bool two = G > 8;  // query rows in two n-tiles
  switch (H) {
    case 64:
      return two ? &masked_attention_kernel<C, 64, 2>
                 : &masked_attention_kernel<C, 64, 1>;
    case 128:
      return two ? &masked_attention_kernel<C, 128, 2>
                 : &masked_attention_kernel<C, 128, 1>;
    case 256:
      return two ? &masked_attention_kernel<C, 256, 2>
                 : &masked_attention_kernel<C, 256, 1>;
  }
  return nullptr;
}

// The kernel of a compute mode, head dim and query-row count; nullptr for
// a shape or mode the kernels do not take.
Kernel kernel_for(int compute, int R, int G, int S, int H) {
  if (!aeqt::split::takes(aeqt::split::kMasked, compute, R, G, S, H))
    return nullptr;
  switch (compute) {
    case aeqt::kF32: return kernel_for<aeqt::kF32>(H, G);
    case aeqt::kBF16: return kernel_for<aeqt::kBF16>(H, G);
    case aeqt::kInt8: return kernel_for<aeqt::kInt8>(H, G);
  }
  return nullptr;
}

aeqt::split::Plan plan_of(Kernel kernel, int compute, int R, int G, int S,
                          int H) {
  return aeqt::split::choose_plan(
      kernel, aeqt::split::Int8Smem{aeqt::split::kMasked, compute, G, H}, S,
      R);
}

}  // namespace

// q f32 [R, G, H] with R = B * NK; k, v int8 [R, S, H]; mask f32 with
// element (b, nk, g, j) at b * mask_sb + nk * mask_sn + g * mask_sg + j
// (a stride of 0 broadcasts); out f32 [R, G, H]; compute aeqt::kF32, kBF16
// or kInt8. Returns aeqt::kShapeRefused (nothing launched) unless H is 64,
// 128 or 256, G <= 16, R <= 65535 and a CTA's shared memory (its ring, the
// G x rows scores) fits.
extern "C" int aeqt_attention_masked(const void* q, const void* k,
                                     const void* v, const void* mask,
                                     void* out, int compute, int R, int NK,
                                     int G, int S, int H, long long mask_sb,
                                     long long mask_sn, long long mask_sg,
                                     float k_scale_eff, float v_scale,
                                     float zp_k, float zp_v, void* stream) {
  const Kernel kernel = kernel_for(compute, R, G, S, H);
  if (kernel == nullptr) return aeqt::kShapeRefused;
  Args a = {};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const int8_t*>(k);
  a.v = static_cast<const int8_t*>(v);
  a.out = out;
  a.mask = static_cast<const float*>(mask);
  a.mask_sb = mask_sb;
  a.mask_sn = mask_sn;
  a.mask_sg = mask_sg;
  a.NK = NK;
  a.G = G;
  a.S = S;
  a.ks = k_scale_eff;
  a.v_scale = v_scale;
  a.zp_k = zp_k;
  a.zp_v = zp_v;
  return aeqt::split::launch(kernel, a, plan_of(kernel, compute, R, G, S, H),
                             R, static_cast<cudaStream_t>(stream));
}

// The launch of a shape (chip_smoke.SPLIT_PLAN_FIELDS: cluster size,
// rows, cache rows a CTA, threads, shared memory).
extern "C" int aeqt_attention_masked_plan(int R, int G, int S, int H,
                                          int compute, long long* fields) {
  const Kernel kernel = kernel_for(compute, R, G, S, H);
  if (kernel == nullptr) return aeqt::kShapeRefused;
  aeqt::split::plan_fields(plan_of(kernel, compute, R, G, S, H), R, fields);
  return 0;
}
