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
//   rule, to the one-block kernel below: one block of 256 threads per
//   (batch, kv-head) row (the G query rows staged in shared memory, one
//   thread a cache row for the scores, one warp a query row for the
//   softmax, 4 head columns and a row group a thread for the context, the
//   new column last). Its body is aeqt::stale_attention_row
//   (attention_common.cuh), which the fused decode block (fused_block.cu)
//   runs too; it takes any H with 1024 % H == 0 while the G x S scores fit.
#include "attention_common.cuh"
#include "attention_split_tc.cuh"

namespace {

using aeqt::split::Args;
using aeqt::split::Kernel;
constexpr int kThreads = aeqt::kAttnThreads;

template <int C, int H, int NTS>
__global__ void __launch_bounds__(aeqt::split::kThreads, 2)
stale_attention_split_kernel(const Args a) {
  aeqt::split::attend<aeqt::split::kStale, C, H, NTS>(a);
}

template <int C>
Kernel kernel_for(int H, int G) {
  const bool two = G > 8;  // query rows in two n-tiles
  switch (H) {
    case 64:
      return two ? &stale_attention_split_kernel<C, 64, 2>
                 : &stale_attention_split_kernel<C, 64, 1>;
    case 128:
      return two ? &stale_attention_split_kernel<C, 128, 2>
                 : &stale_attention_split_kernel<C, 128, 1>;
    case 256:
      return two ? &stale_attention_split_kernel<C, 256, 2>
                 : &stale_attention_split_kernel<C, 256, 1>;
  }
  return nullptr;
}

// The split kernel of a compute mode and shape; nullptr for a shape the
// core does not take (the one-block kernel's).
Kernel kernel_for(int compute, int R, int G, int S, int H) {
  if (!aeqt::split::takes(aeqt::split::kStale, compute, R, G, S, H))
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
      kernel, aeqt::split::Int8Smem{aeqt::split::kStale, compute, G, H}, S,
      R);
}

template <int C, typename TOut>
__global__ void __launch_bounds__(kThreads)
stale_attention_kernel(const float* __restrict__ q,
                       const int8_t* __restrict__ k,
                       const int8_t* __restrict__ v,
                       const int8_t* __restrict__ k_new,
                       const int8_t* __restrict__ v_new,
                       const int* __restrict__ lengths,
                       TOut* __restrict__ out, int NK, int G, int S, int H,
                       float k_scale_eff, float v_scale, float zp_k,
                       float zp_v) {
  extern __shared__ __align__(16) float sm[];
  const int row = blockIdx.x;
  const int b = row / NK;
  const int L = min(max(lengths[b] - 1, 0), S);
  const float* qr = q + (size_t)row * G * H;
  for (int i = threadIdx.x; i < G * H; i += blockDim.x) sm[i] = qr[i];
  __syncthreads();
  aeqt::stale_attention_row<C>(sm, G, S, H, L, k + (size_t)row * S * H,
                            v + (size_t)row * S * H, k_new + (size_t)row * H,
                            v_new + (size_t)row * H, out + (size_t)row * G * H,
                            k_scale_eff, v_scale, zp_k, zp_v);
}

template <int C, typename TOut>
int launch(const void* q, const void* k, const void* v, const void* k_new,
           const void* v_new, const void* lengths, void* out, int R, int NK,
           int G, int S, int H, float k_scale_eff, float v_scale, float zp_k,
           float zp_v, cudaStream_t stream) {
  const size_t smem = aeqt::stale_smem_floats(G, S, H) * sizeof(float);
  if (!aeqt::head_dim_fits(H) || !aeqt::compute_fits(C, G, H) ||
      !aeqt::smem_fits(smem))
    return aeqt::kShapeRefused;
  auto* kernel = stale_attention_kernel<C, TOut>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<R, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), static_cast<const int8_t*>(k_new),
      static_cast<const int8_t*>(v_new), static_cast<const int*>(lengths),
      static_cast<TOut*>(out), NK, G, S, H, k_scale_eff, v_scale, zp_k, zp_v);
  return (int)cudaGetLastError();
}

template <typename TOut>
int launch_mode(int compute, const void* q, const void* k, const void* v,
                const void* k_new, const void* v_new, const void* lengths,
                void* out, int R, int NK, int G, int S, int H,
                float k_scale_eff, float v_scale, float zp_k, float zp_v,
                cudaStream_t s) {
  return aeqt::with_compute(compute, [&](auto mode) {
    return launch<decltype(mode)::value, TOut>(q, k, v, k_new, v_new, lengths,
                                               out, R, NK, G, S, H,
                                               k_scale_eff, v_scale, zp_k,
                                               zp_v, s);
  });
}

}  // namespace

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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Kernel kernel = kernel_for(compute, R, G, S, H);
  if (kernel == nullptr) {
    if (out_bf16)
      return launch_mode<__nv_bfloat16>(compute, q, k, v, k_new, v_new,
                                        lengths, out, R, NK, G, S, H,
                                        k_scale_eff, v_scale, zp_k, zp_v, s);
    return launch_mode<float>(compute, q, k, v, k_new, v_new, lengths, out,
                              R, NK, G, S, H, k_scale_eff, v_scale, zp_k,
                              zp_v, s);
  }
  Args a = {};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const int8_t*>(k);
  a.v = static_cast<const int8_t*>(v);
  a.k_new = static_cast<const int8_t*>(k_new);
  a.v_new = static_cast<const int8_t*>(v_new);
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
extern "C" int aeqt_attention_stale_plan(int R, int G, int S, int H,
                                         int compute, long long* fields) {
  const Kernel kernel = kernel_for(compute, R, G, S, H);
  if (kernel != nullptr) {
    aeqt::split::plan_fields(plan_of(kernel, compute, R, G, S, H), R, fields);
    return 0;
  }
  const size_t smem = aeqt::stale_smem_floats(G, S, H) * sizeof(float);
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
