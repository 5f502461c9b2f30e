// Decode attention over an int8 KV cache masked by prefix lengths, f32
// compute.
//
// Replaces: ai_edge_quantizer_tpu/kernels/pallas_attention.py
//   decode_attention_int8_lengths (_ctx_prefix_len, f32 branch). For each
//   (batch, kv-head) row r with L = lengths[b] live cache rows:
//     s[g, j] = (q[g] . k[j] - zp_k * sum(q[g])) * k_scale_eff, j < L
//     p       = exp(s - max_j s) / sum_j exp(s - max_j s)
//     ctx[g]  = (sum_j p[g, j] v[j] - zp_v) * v_scale
//   where k_scale_eff = k_scale / sqrt(H) is formed by the caller. The TPU
//   kernel streams all S rows and sets the scores of rows >= L to -1e30;
//   after the max subtraction those rows add exactly 0, so this kernel
//   does not read them. With L == 0 every TPU score is -1e30, the max is
//   -1e30 and each of the S rows gets weight 1/S: the kernel then reads
//   all S rows with the score -1e30, the same function.
//
// Bound on the H100: the cache bytes of the live rows, 2 * L * H per
//   (batch, kv-head) row over 3.35 TB/s: at Gemma-2B (H = 256, one KV head,
//   G = 8) with B = 64 and full rows (L = 1024) that is 33.5 MB, about
//   10 us. The f32 work (4 * G * L * H per row) is 1/8 of a byte-bound
//   kernel's time at the 67 TFLOP/s f32 peak.
//
// Design (simple first): the stale kernel (attention_stale.cu) without its
//   inline column, on the shared helpers of attention_common.cuh. One block
//   of 256 threads per (batch, kv-head) row; scores one thread per live
//   cache row, four 16-byte loads in flight; softmax one warp per query row
//   (max, exp, sum, divide, in the TPU kernel's order); context 4 head
//   columns and one row group per thread, the row groups' partial sums
//   added in a fixed order, so the result does not depend on timing.
#include "attention_common.cuh"

namespace {

using aeqt::kGC;
using aeqt::kRedFloats;
constexpr int kThreads = aeqt::kAttnThreads;

template <typename TOut>
__global__ void __launch_bounds__(kThreads)
lengths_attention_kernel(const float* __restrict__ q,
                         const int8_t* __restrict__ k,
                         const int8_t* __restrict__ v,
                         const int* __restrict__ lengths,
                         TOut* __restrict__ out, int NK, int G, int S, int H,
                         float k_scale_eff, float v_scale, float zp_k,
                         float zp_v) {
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;                          // [G][H]
  float* sc = qs + (size_t)G * H;          // [G][S] scores, then probs
  float* qsum = sc + (size_t)G * S;        // [G]
  float* red = qsum + G;                   // [RG][kGC][H] context partials
  const int row = blockIdx.x;
  const int b = row / NK;
  const int len = lengths[b];
  const bool none = len <= 0;  // every TPU score is -1e30
  const int L = none ? S : min(len, S);
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

  // Scores: one thread per live cache row.
  const int8_t* kr = k + (size_t)row * S * H;
  for (int j = threadIdx.x; j < L; j += blockDim.x) {
    const int8_t* krow = kr + (size_t)j * H;
    for (int g0 = 0; g0 < G; g0 += kGC) {
      float acc[kGC] = {};
      if (!none) aeqt::dot_row(qs, H, G, g0, krow, acc);
#pragma unroll
      for (int i = 0; i < kGC; ++i) {
        const int g = g0 + i;
        if (g < G)
          sc[(size_t)g * S + j] =
              none ? aeqt::kNegInf : (acc[i] - zp_k * qsum[g]) * k_scale_eff;
      }
    }
  }
  __syncthreads();

  // Softmax over the L live scores: one warp per query row.
  for (int g = warp; g < G; g += nwarps) {
    float* srow = sc + (size_t)g * S;
    float m = aeqt::kNegInf;
    for (int j = lane; j < L; j += 32) m = fmaxf(m, srow[j]);
    m = aeqt::warp_max(m);
    float sum = 0.0f;
    for (int j = lane; j < L; j += 32) {
      const float p = expf(srow[j] - m);
      srow[j] = p;
      sum = sum + p;
    }
    sum = aeqt::warp_sum(sum);
    for (int j = lane; j < L; j += 32) srow[j] = srow[j] / sum;
  }
  __syncthreads();

  // Context: 4 head columns and one row group per thread.
  const int8_t* vr = v + (size_t)row * S * H;
  const int chunks = H / 4;
  const int RG = blockDim.x / chunks;
  const int c = threadIdx.x % chunks, rg = threadIdx.x / chunks;
  for (int g0 = 0; g0 < G; g0 += kGC) {
    float acc[kGC][4];
    aeqt::context_rows(sc, S, G, g0, vr, H, L, rg, RG, c, acc);
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
      aeqt::store_f(out, ((size_t)row * G + g) * H + h, (ctx - zp_v) * v_scale);
    }
  }
}

template <typename TOut>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* out, int R, int NK, int G, int S, int H, float k_scale_eff,
           float v_scale, float zp_k, float zp_v, cudaStream_t stream) {
  const size_t smem =
      ((size_t)G * H + (size_t)G * S + G + kRedFloats) * sizeof(float);
  if (!aeqt::head_dim_fits(H) || !aeqt::smem_fits(smem))
    return aeqt::kShapeRefused;
  auto* kernel = lengths_attention_kernel<TOut>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<R, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), static_cast<const int*>(lengths),
      static_cast<TOut*>(out), NK, G, S, H, k_scale_eff, v_scale, zp_k, zp_v);
  return (int)cudaGetLastError();
}

}  // namespace

// q f32 [R, G, H] with R = B * NK; k, v int8 [R, S, H]; lengths int32 [B];
// out [R, G, H] f32 or bf16 (out_bf16). Returns aeqt::kShapeRefused unless
// H % 16 == 0, 1024 % H == 0 and the G x S scores fit in shared memory.
extern "C" int aeqt_attention_lengths(const void* q, const void* k,
                                      const void* v, const void* lengths,
                                      void* out, int out_bf16, int R, int NK,
                                      int G, int S, int H, float k_scale_eff,
                                      float v_scale, float zp_k, float zp_v,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    return launch<__nv_bfloat16>(q, k, v, lengths, out, R, NK, G, S, H,
                                 k_scale_eff, v_scale, zp_k, zp_v, s);
  return launch<float>(q, k, v, lengths, out, R, NK, G, S, H, k_scale_eff,
                       v_scale, zp_k, zp_v, s);
}
