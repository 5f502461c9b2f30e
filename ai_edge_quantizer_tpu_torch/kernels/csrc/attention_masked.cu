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
//   3.35 TB/s. The f32 work (4 * G * S * H per row) is 1/8 of that time at
//   the 67 TFLOP/s f32 rate; in int8 the score dot runs on __dp4a.
//
// Design (simple first): the lengths kernel's layout (attention_lengths.cuh,
//   helpers of attention_common.cuh) over all S rows. One block of 256
//   threads per (batch, kv-head) row; the G query rows and the G x S scores
//   live in shared memory (32 KB of scores at G 8, S 1024), the int8 q
//   codes and scales in the context partials' space until the context
//   starts; scores one thread per cache row, four 16-byte loads in flight,
//   the mask element added beside its score after the scale (the mask is
//   addressed by strides, so a mask broadcast over kv heads or query rows
//   is never copied); softmax one warp per query row; context 4 head
//   columns and one row group per thread, the row groups' partial sums
//   added in a fixed order, so the result does not depend on timing.
#include "attention_common.cuh"

namespace {

using aeqt::kGC;
constexpr int kThreads = aeqt::kAttnThreads;

template <int C>
__global__ void __launch_bounds__(kThreads)
masked_attention_kernel(const float* __restrict__ q,
                        const int8_t* __restrict__ k,
                        const int8_t* __restrict__ v,
                        const float* __restrict__ mask,
                        float* __restrict__ out, int NK, int G, int S, int H,
                        long long mask_sb, long long mask_sn,
                        long long mask_sg, float k_scale_eff, float v_scale,
                        float zp_k, float zp_v) {
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;                          // [G][H]
  float* sc = qs + (size_t)G * H;          // [G][S] scores, then probs
  float* qsum = sc + (size_t)G * S;        // [G] sum(q), then p_sum (int8)
  float* red = qsum + G;                   // [RG][kGC][H] context partials
  const int row = blockIdx.x;
  const int b = row / NK, nk = row % NK;
  const float* mrow = mask + b * mask_sb + nk * mask_sn;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;

  const float* qr = q + (size_t)row * G * H;
  for (int i = threadIdx.x; i < G * H; i += blockDim.x) qs[i] = qr[i];
  __syncthreads();

  aeqt::prepare_queries<C>(qs, qsum, red, G, H);
  __syncthreads();

  // Scores: one thread per cache row, the mask added after the scale.
  const int8_t* kr = k + (size_t)row * S * H;
  for (int j = threadIdx.x; j < S; j += blockDim.x) {
    const int8_t* krow = kr + (size_t)j * H;
    for (int g0 = 0; g0 < G; g0 += kGC) {
      float s[kGC];
      aeqt::score_rows<C>(qs, qsum, red, G, H, g0, krow, zp_k, k_scale_eff,
                          s);
#pragma unroll
      for (int i = 0; i < kGC; ++i) {
        const int g = g0 + i;
        if (g < G) sc[(size_t)g * S + j] = s[i] + mrow[g * mask_sg + j];
      }
    }
  }
  __syncthreads();

  // Softmax over the S scores: one warp per query row (no floor under the
  // max: jnp.max of the row).
  for (int g = warp; g < G; g += nwarps) {
    const float codes =
        aeqt::softmax_row<C>(sc + (size_t)g * S, S, -INFINITY, lane);
    if constexpr (C == aeqt::kInt8)
      if (lane == 0) qsum[g] = fmaxf(codes, 1.0f);
  }
  __syncthreads();

  aeqt::context_phase<C>(sc, qsum, red, G, S, H, S, v + (size_t)row * S * H,
                         nullptr, -1, out + (size_t)row * G * H, zp_v,
                         v_scale);
}

template <int C>
int launch(const void* q, const void* k, const void* v, const void* mask,
           void* out, int R, int NK, int G, int S, int H, long long mask_sb,
           long long mask_sn, long long mask_sg, float k_scale_eff,
           float v_scale, float zp_k, float zp_v, cudaStream_t stream) {
  const size_t smem = aeqt::scores_smem_floats(G, S, H) * sizeof(float);
  if (R <= 0 || G <= 0 || S <= 0 || !aeqt::head_dim_fits(H) ||
      !aeqt::compute_fits(C, G, H) || !aeqt::smem_fits(smem))
    return aeqt::kShapeRefused;
  auto* kernel = masked_attention_kernel<C>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<R, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), static_cast<const float*>(mask),
      static_cast<float*>(out), NK, G, S, H, mask_sb, mask_sn, mask_sg,
      k_scale_eff, v_scale, zp_k, zp_v);
  return (int)cudaGetLastError();
}

}  // namespace

// q f32 [R, G, H] with R = B * NK; k, v int8 [R, S, H]; mask f32 with
// element (b, nk, g, j) at b * mask_sb + nk * mask_sn + g * mask_sg + j
// (a stride of 0 broadcasts); out f32 [R, G, H]; compute aeqt::kF32, kBF16
// or kInt8. Returns aeqt::kShapeRefused (nothing launched) unless
// H % 16 == 0, 1024 % H == 0, the G x S scores fit in shared memory and
// (int8) G * H / 4 + G <= aeqt::kRedFloats.
extern "C" int aeqt_attention_masked(const void* q, const void* k,
                                     const void* v, const void* mask,
                                     void* out, int compute, int R, int NK,
                                     int G, int S, int H, long long mask_sb,
                                     long long mask_sn, long long mask_sg,
                                     float k_scale_eff, float v_scale,
                                     float zp_k, float zp_v, void* stream) {
  return aeqt::with_compute(compute, [&](auto mode) {
    return launch<decltype(mode)::value>(
        q, k, v, mask, out, R, NK, G, S, H, mask_sb, mask_sn, mask_sg,
        k_scale_eff, v_scale, zp_k, zp_v, static_cast<cudaStream_t>(stream));
  });
}
