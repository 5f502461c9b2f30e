// Decode attention over an int8 KV cache that reads only the live prefix:
// chunks of c cache rows, an online softmax across them (f32 compute).
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
//   row in its row block. This kernel reproduces that: each block finds
//   its row block's longest row, and a zero-length row reads n_chunks * c
//   V rows. A row of length L > 0 gains nothing from a chunk past L (there
//   m' = m, a = 1, p = 0 exactly), so it reads ceil(L / c) chunks and no
//   row at or past L.
//
// Bound on the H100: the K and V bytes of the live rows (2 * L * H a row,
//   n_chunks * c * H for a zero-length row's V) over 3.35 TB/s.
//
// Design (simple first): one block of 256 threads per (batch, kv-head) row
//   (the TPU's row block only sets n_chunks), its chunks in order. Per
//   chunk: scores one thread per cache row (attention_common.cuh's dot_row,
//   G query rows in registers); the softmax update one warp per query row;
//   the context 4 head columns and one row group per thread, the row
//   groups' partials added in a fixed order, then acc = acc * a + pv in
//   shared memory.
#include "attention_common.cuh"

namespace {

using aeqt::kGC;
using aeqt::kRedFloats;
constexpr int kThreads = aeqt::kAttnThreads;

__global__ void __launch_bounds__(kThreads)
dynlen_attention_kernel(const float* __restrict__ q,
                        const int8_t* __restrict__ k,
                        const int8_t* __restrict__ v,
                        const int* __restrict__ lengths,
                        float* __restrict__ out, int NK, int G, int S, int H,
                        int c, int rb, float k_scale_eff, float v_scale,
                        float zp_k, float zp_v) {
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;                          // [G][H]
  float* acc_s = qs + (size_t)G * H;       // [G][H] context accumulators
  float* sc = acc_s + (size_t)G * H;       // [G][c] scores, then p
  float* qsum = sc + (size_t)G * c;        // [G]
  float* m_s = qsum + G;                   // [G] running max
  float* l_s = m_s + G;                    // [G] running denominator
  float* a_s = l_s + G;                    // [G] this chunk's rescale
  float* red = a_s + G;                    // [RG][kGC][H] context partials
  const int row = blockIdx.x;
  const int len = lengths[row / NK];
  const bool zero = len <= 0;
  // n_chunks of the row block (the TPU kernel's grid step).
  const int rb0 = (row / rb) * rb;
  int blk_len = lengths[rb0 / NK];
  for (int r = rb0 + 1; r < rb0 + rb; ++r) blk_len = max(blk_len, lengths[r / NK]);
  const int max_chunks = S / c;
  const int n_chunks =
      min(max(blk_len > 0 ? (blk_len + c - 1) / c : 0, 1), max_chunks);
  const int row_chunks = zero ? n_chunks : min(n_chunks, (len + c - 1) / c);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int8_t* kr = k + (size_t)row * S * H;
  const int8_t* vr = v + (size_t)row * S * H;

  const float* qr = q + (size_t)row * G * H;
  for (int i = threadIdx.x; i < G * H; i += blockDim.x) {
    qs[i] = qr[i];
    acc_s[i] = 0.0f;
  }
  __syncthreads();
  for (int g = warp; g < G; g += nwarps) {
    float s = 0.0f;
    for (int h = lane; h < H; h += 32) s = s + qs[g * H + h];
    s = aeqt::warp_sum(s);
    if (lane == 0) {
      qsum[g] = s;
      m_s[g] = aeqt::kNegInf;
      l_s[g] = 0.0f;
    }
  }
  __syncthreads();

  const int chunks = H / 4;
  const int RG = blockDim.x / chunks;
  const int col = threadIdx.x % chunks, rg = threadIdx.x / chunks;
  for (int ci = 0; ci < row_chunks; ++ci) {
    const int base = ci * c;
    // Rows of this chunk below the row's length (all of them for len 0,
    // whose p is 1 everywhere).
    const int live = zero ? c : min(c, len - base);
    for (int j = threadIdx.x; j < c; j += blockDim.x) {
      for (int g0 = 0; g0 < G; g0 += kGC) {
        float acc[kGC] = {};
        const bool scored = !zero && j < live;
        if (scored) aeqt::dot_row(qs, H, G, g0, kr + (size_t)(base + j) * H, acc);
#pragma unroll
        for (int i = 0; i < kGC; ++i) {
          const int g = g0 + i;
          if (g < G)
            sc[(size_t)g * c + j] =
                scored ? (acc[i] - zp_k * qsum[g]) * k_scale_eff
                       : aeqt::kNegInf;
        }
      }
    }
    __syncthreads();
    // The online softmax update: one warp per query row.
    for (int g = warp; g < G; g += nwarps) {
      float* srow = sc + (size_t)g * c;
      float mc = aeqt::kNegInf;
      for (int j = lane; j < c; j += 32) mc = fmaxf(mc, srow[j]);
      mc = aeqt::warp_max(mc);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mc);
      float sum = 0.0f;
      for (int j = lane; j < c; j += 32) {
        const float p = expf(srow[j] - m_new);
        srow[j] = p;
        sum = sum + p;
      }
      sum = aeqt::warp_sum(sum);
      __syncwarp();
      if (lane == 0) {
        const float a = expf(m_prev - m_new);
        a_s[g] = a;
        l_s[g] = a * l_s[g] + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    // acc = acc * a + p . v over the chunk's live rows (p is 0 past them).
    for (int g0 = 0; g0 < G; g0 += kGC) {
      float acc[kGC][4];
      aeqt::context_rows(sc, c, G, g0, vr + (size_t)base * H, H, live, rg,
                         RG, col, acc);
#pragma unroll
      for (int i = 0; i < kGC; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          red[((size_t)rg * kGC + i) * H + 4 * col + e] = acc[i][e];
      __syncthreads();
      for (int idx = threadIdx.x; idx < kGC * H; idx += blockDim.x) {
        const int i = idx / H, h = idx % H, g = g0 + i;
        if (g >= G) continue;
        float pv = 0.0f;
        for (int r = 0; r < RG; ++r)
          pv = pv + red[((size_t)r * kGC + i) * H + h];
        acc_s[g * H + h] = acc_s[g * H + h] * a_s[g] + pv;
      }
      __syncthreads();  // red is free again; acc_s and sc are settled
    }
  }

  for (int i = threadIdx.x; i < G * H; i += blockDim.x) {
    const int g = i / H;
    out[(size_t)row * G * H + i] =
        (acc_s[i] / fmaxf(l_s[g], 1e-30f) - zp_v) * v_scale;
  }
}

}  // namespace

// q f32 [R, G, H] with R = B * NK; k, v int8 [R, S, H]; lengths int32 [B];
// out f32 [R, G, H]; c, rb the TPU kernel's chunk and row block (the
// wrapper forms them as it does). Returns aeqt::kShapeRefused unless
// H % 16 == 0, 1024 % H == 0, S % c == 0, R % rb == 0 and the block's
// shared memory fits.
extern "C" int aeqt_attention_dynlen(const void* q, const void* k,
                                     const void* v, const void* lengths,
                                     void* out, int R, int NK, int G, int S,
                                     int H, int c, int rb, float k_scale_eff,
                                     float v_scale, float zp_k, float zp_v,
                                     void* stream) {
  const size_t smem = ((size_t)2 * G * H + (size_t)G * c + 4 * G +
                       kRedFloats) * sizeof(float);
  if (!aeqt::head_dim_fits(H) || c <= 0 || S % c != 0 || rb <= 0 ||
      R % rb != 0 || !aeqt::smem_fits(smem))
    return aeqt::kShapeRefused;
  cudaError_t err = cudaFuncSetAttribute(
      dynlen_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dynlen_attention_kernel<<<R, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), static_cast<const int*>(lengths),
      static_cast<float*>(out), NK, G, S, H, c, rb, k_scale_eff, v_scale,
      zp_k, zp_v);
  return (int)cudaGetLastError();
}
