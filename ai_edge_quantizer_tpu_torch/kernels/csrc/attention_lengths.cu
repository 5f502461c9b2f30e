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
//   H with 1024 % H == 0 while the scores fit.
#include "attention_lengths.cuh"
#include "attention_split_tc.cuh"

namespace {

using aeqt::split::Args;
using aeqt::split::Kernel;

template <int C, int H, int NTS>
__global__ void __launch_bounds__(aeqt::split::kThreads, 2)
lengths_attention_split_kernel(const Args a) {
  aeqt::split::attend<aeqt::split::kLengths, C, H, NTS>(a);
}

template <int C>
Kernel kernel_for(int H, int G) {
  const bool two = G > 8;  // query rows in two n-tiles
  switch (H) {
    case 64:
      return two ? &lengths_attention_split_kernel<C, 64, 2>
                 : &lengths_attention_split_kernel<C, 64, 1>;
    case 128:
      return two ? &lengths_attention_split_kernel<C, 128, 2>
                 : &lengths_attention_split_kernel<C, 128, 1>;
    case 256:
      return two ? &lengths_attention_split_kernel<C, 256, 2>
                 : &lengths_attention_split_kernel<C, 256, 1>;
  }
  return nullptr;
}

// The split kernel of a compute mode and shape; nullptr for a shape the
// core does not take (the one-block kernel's).
Kernel kernel_for(int compute, int R, int G, int S, int H) {
  if (!aeqt::split::takes(aeqt::split::kLengths, compute, R, G, S, H))
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
      kernel, aeqt::split::Int8Smem{aeqt::split::kLengths, compute, G, H}, S,
      R);
}

template <typename TOut>
int launch_one_block(int compute, const void* q, const void* k,
                     const void* v, const void* lengths, void* out, int R,
                     int NK, int G, int S, int H, float k_scale_eff,
                     float v_scale, float zp_k, float zp_v, cudaStream_t s) {
  return aeqt::with_compute(compute, [&](auto mode) {
    return aeqt::launch_lengths_attention<TOut, decltype(mode)::value>(
        q, k, v, lengths, out, R, NK, G, S, H, k_scale_eff, v_scale, zp_k,
        zp_v, s);
  });
}

}  // namespace

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
  const Kernel kernel = kernel_for(compute, R, G, S, H);
  if (kernel == nullptr) {
    if (out_bf16)
      return launch_one_block<__nv_bfloat16>(compute, q, k, v, lengths, out,
                                             R, NK, G, S, H, k_scale_eff,
                                             v_scale, zp_k, zp_v, s);
    return launch_one_block<float>(compute, q, k, v, lengths, out, R, NK, G,
                                   S, H, k_scale_eff, v_scale, zp_k, zp_v,
                                   s);
  }
  Args a = {};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const int8_t*>(k);
  a.v = static_cast<const int8_t*>(v);
  a.out = out;
  a.out_bf16 = out_bf16;
  a.lengths = static_cast<const int*>(lengths);
  a.NK = NK;
  a.G = G;
  a.S = S;
  a.ks = k_scale_eff;
  a.v_scale = v_scale;
  a.zp_k = zp_k;
  a.zp_v = zp_v;
  return aeqt::split::launch(kernel, a, plan_of(kernel, compute, R, G, S, H),
                             R, s);
}

// The launch of a shape (chip_smoke.SPLIT_PLAN_FIELDS: cluster size, rows,
// cache rows a CTA, threads, shared memory); a shape on the one-block
// kernel gives cluster 0, R blocks of all S rows and its shared memory.
extern "C" int aeqt_attention_lengths_plan(int R, int G, int S, int H,
                                           int compute, long long* fields) {
  const Kernel kernel = kernel_for(compute, R, G, S, H);
  if (kernel != nullptr) {
    aeqt::split::plan_fields(plan_of(kernel, compute, R, G, S, H), R, fields);
    return 0;
  }
  const size_t smem = aeqt::scores_smem_floats(G, S, H) * sizeof(float);
  if (compute < aeqt::kF32 || compute > aeqt::kInt8 ||
      !aeqt::head_dim_fits(H) || !aeqt::compute_fits(compute, G, H) ||
      !aeqt::smem_fits(smem))
    return aeqt::kShapeRefused;
  fields[0] = 0;
  fields[1] = R;
  fields[2] = S;
  fields[3] = aeqt::kAttnThreads;
  fields[4] = (long long)smem;
  return 0;
}
