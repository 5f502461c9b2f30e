// Decode attention over an int8 KV cache with an additive mask, f32
// compute.
//
// Replaces: ai_edge_quantizer_tpu/kernels/pallas_attention.py
//   decode_attention_int8_masked (_decode_attn_mask_kernel, compute='f32'),
//   which the JAX executor's default (AEQT_ATTN_LENGTHS=0) runs at every
//   decode step. For each (batch, kv-head) row r over all S cache rows:
//     s[g, j] = ((q[g] . k[j] - zp_k * sum(q[g])) * k_scale_eff) + mask[g, j]
//     p       = exp(s - max_j s) / sum_j exp(s - max_j s)
//     ctx[g]  = (sum_j p[g, j] v[j] - zp_v) * v_scale
//   in that order, where k_scale_eff = k_scale / sqrt(H) is formed by the
//   caller; the probabilities are divided by their sum before the PV
//   product, as the TPU kernel does. The mask decides which rows count, so
//   every row is read; a row whose mask is -1e9 everywhere gets uniform
//   weights (its scores are all equal after the add), one that is -inf
//   everywhere gives NaN, as on the TPU.
//
// Bound on the H100: the cache bytes, 2 * S * H per (batch, kv-head) row,
//   plus the mask as the caller gives it: at Gemma-2B (H = 256, one KV head,
//   G = 8) with B = 64 and S = 1024 that is 33.5 MB of K/V, about 10 us at
//   3.35 TB/s. The f32 work (4 * G * S * H per row) is 1/8 of that time at
//   the 67 TFLOP/s f32 rate.
//
// Design (simple first): the lengths kernel's layout (attention_lengths.cu,
//   helpers of attention_common.cuh) over all S rows. One block of 256
//   threads per (batch, kv-head) row; the G query rows and the G x S scores
//   live in shared memory (32 KB of scores at G 8, S 1024); scores one
//   thread per cache row, four 16-byte loads in flight, the mask element
//   read beside its score (the mask is addressed by strides, so a mask
//   broadcast over kv heads or query rows is never copied); softmax one
//   warp per query row; context 4 head columns and one row group per
//   thread, the row groups' partial sums added in a fixed order, so the
//   result does not depend on timing.
#include "attention_common.cuh"

namespace {

using aeqt::kGC;
using aeqt::kRedFloats;
constexpr int kThreads = aeqt::kAttnThreads;

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
  float* qsum = sc + (size_t)G * S;        // [G]
  float* red = qsum + G;                   // [RG][kGC][H] context partials
  const int row = blockIdx.x;
  const int b = row / NK, nk = row % NK;
  const float* mrow = mask + b * mask_sb + nk * mask_sn;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;

  const float* qr = q + (size_t)row * G * H;
  for (int i = threadIdx.x; i < G * H; i += blockDim.x) qs[i] = qr[i];
  __syncthreads();

  // sum(q[g]): one warp per query row.
  for (int g = warp; g < G; g += nwarps) {
    float s = 0.0f;
    for (int h = lane; h < H; h += 32) s = s + qs[g * H + h];
    s = aeqt::warp_sum(s);
    if (lane == 0) qsum[g] = s;
  }
  __syncthreads();

  // Scores: one thread per cache row.
  const int8_t* kr = k + (size_t)row * S * H;
  for (int j = threadIdx.x; j < S; j += blockDim.x) {
    const int8_t* krow = kr + (size_t)j * H;
    for (int g0 = 0; g0 < G; g0 += kGC) {
      float acc[kGC];
      aeqt::dot_row(qs, H, G, g0, krow, acc);
#pragma unroll
      for (int i = 0; i < kGC; ++i) {
        const int g = g0 + i;
        if (g < G) {
          const float scaled = (acc[i] - zp_k * qsum[g]) * k_scale_eff;
          sc[(size_t)g * S + j] = scaled + mrow[g * mask_sg + j];
        }
      }
    }
  }
  __syncthreads();

  // Softmax over the S scores: one warp per query row.
  for (int g = warp; g < G; g += nwarps) {
    float* srow = sc + (size_t)g * S;
    float m = -INFINITY;
    for (int j = lane; j < S; j += 32) m = fmaxf(m, srow[j]);
    m = aeqt::warp_max(m);
    float sum = 0.0f;
    for (int j = lane; j < S; j += 32) {
      const float p = expf(srow[j] - m);
      srow[j] = p;
      sum = sum + p;
    }
    sum = aeqt::warp_sum(sum);
    for (int j = lane; j < S; j += 32) srow[j] = srow[j] / sum;
  }
  __syncthreads();

  // Context: 4 head columns and one row group per thread.
  const int8_t* vr = v + (size_t)row * S * H;
  const int chunks = H / 4;
  const int RG = blockDim.x / chunks;
  const int c = threadIdx.x % chunks, rg = threadIdx.x / chunks;
  for (int g0 = 0; g0 < G; g0 += kGC) {
    float acc[kGC][4];
    aeqt::context_rows(sc, S, G, g0, vr, H, S, rg, RG, c, acc);
    __syncthreads();  // the previous pass has read `red`
#pragma unroll
    for (int i = 0; i < kGC; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[((size_t)rg * kGC + i) * H + 4 * c + e] = acc[i][e];
    __syncthreads();
    for (int idx = threadIdx.x; idx < kGC * H; idx += blockDim.x) {
      const int i = idx / H, h = idx % H, g = g0 + i;
      if (g >= G) continue;
      float ctx = 0.0f;
      for (int r = 0; r < RG; ++r) ctx = ctx + red[((size_t)r * kGC + i) * H + h];
      out[((size_t)row * G + g) * H + h] = (ctx - zp_v) * v_scale;
    }
  }
}

}  // namespace

// q f32 [R, G, H] with R = B * NK; k, v int8 [R, S, H]; mask f32 with
// element (b, nk, g, j) at b * mask_sb + nk * mask_sn + g * mask_sg + j
// (a stride of 0 broadcasts); out f32 [R, G, H]. Returns aeqt::kShapeRefused
// (nothing launched) unless H % 16 == 0, 1024 % H == 0 and the G x S scores
// fit in shared memory.
extern "C" int aeqt_attention_masked(const void* q, const void* k,
                                     const void* v, const void* mask,
                                     void* out, int R, int NK, int G, int S,
                                     int H, long long mask_sb,
                                     long long mask_sn, long long mask_sg,
                                     float k_scale_eff, float v_scale,
                                     float zp_k, float zp_v, void* stream) {
  const size_t smem =
      ((size_t)G * H + (size_t)G * S + G + kRedFloats) * sizeof(float);
  if (R <= 0 || G <= 0 || S <= 0 || !aeqt::head_dim_fits(H) ||
      !aeqt::smem_fits(smem))
    return aeqt::kShapeRefused;
  cudaError_t err = cudaFuncSetAttribute(
      masked_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  masked_attention_kernel<<<R, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), static_cast<const float*>(mask),
      static_cast<float*>(out), NK, G, S, H, mask_sb, mask_sn, mask_sg,
      k_scale_eff, v_scale, zp_k, zp_v);
  return (int)cudaGetLastError();
}
