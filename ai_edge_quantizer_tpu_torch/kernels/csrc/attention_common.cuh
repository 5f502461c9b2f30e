// Device helpers shared by the port's int8-cache decode attention kernels
// (attention_stale.cu, attention_lengths.cu).
//
// Both kernels take one block per (batch, kv-head) row, stage the G query
// rows in shared memory, score one cache row per thread (kGC query rows'
// dot products in registers, four 16-byte chunks of the row in flight),
// and form the context with 4 head columns and one row group per thread.
// Every product and sum is rounded on its own (the library is built with
// --fmad=false), in a fixed order.
#pragma once

#include "drq_common.cuh"

namespace aeqt {

constexpr int kAttnThreads = 256;
constexpr int kGC = 8;  // query rows a thread keeps in registers at once
// Context partials: [RG][kGC][H] floats with RG * H = 4 * kAttnThreads.
constexpr int kRedFloats = 4 * kAttnThreads * kGC;
constexpr float kNegInf = -1e30f;  // the TPU kernels' masked score

// The head dims the row layout takes: 16-byte K chunks, and H / 4 context
// column groups dividing the block's 256 threads.
inline bool head_dim_fits(int H) { return H % 16 == 0 && 1024 % H == 0; }

// acc[i] += q[g0 + i][h, h + 16) . k[h, h + 16) for this pass's query rows.
__device__ __forceinline__ void dot16(const float* qs, int H, int G, int g0,
                                      int h, int4 kv, float (&acc)[kGC]) {
  const int words[4] = {kv.x, kv.y, kv.z, kv.w};
  float kf[16];
#pragma unroll
  for (int e = 0; e < 16; ++e)
    kf[e] = (float)(int8_t)(words[e >> 2] >> (8 * (e & 3)));
#pragma unroll
  for (int i = 0; i < kGC; ++i) {
    if (g0 + i < G) {
      const float* qq = qs + (g0 + i) * H + h;
      float a = acc[i];
#pragma unroll
      for (int e = 0; e < 16; ++e) a = a + qq[e] * kf[e];
      acc[i] = a;
    }
  }
}

// Dot products of the kGC query rows from g0 with cache row `krow` (H
// int8 values), four 16-byte chunks of the row in flight at once.
__device__ __forceinline__ void dot_row(const float* qs, int H, int G, int g0,
                                        const int8_t* __restrict__ krow,
                                        float (&acc)[kGC]) {
#pragma unroll
  for (int i = 0; i < kGC; ++i) acc[i] = 0.0f;
  for (int h0 = 0; h0 < H; h0 += 64) {
    int4 kv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (h0 + 16 * u < H)
        kv[u] = __ldg(reinterpret_cast<const int4*>(krow + h0 + 16 * u));
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (h0 + 16 * u < H) dot16(qs, H, G, g0, h0 + 16 * u, kv[u], acc);
  }
}

// acc[i][e] += p[g0 + i][j] * v[j][4c + e] for this pass's query rows.
__device__ __forceinline__ void add_row(const float* sc, int S, int G, int g0,
                                        int j, char4 vv,
                                        float (&acc)[kGC][4]) {
  const float vf[4] = {(float)vv.x, (float)vv.y, (float)vv.z, (float)vv.w};
#pragma unroll
  for (int i = 0; i < kGC; ++i) {
    if (g0 + i < G) {
      const float p = sc[(size_t)(g0 + i) * S + j];
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = acc[i][e] + p * vf[e];
    }
  }
}

// Partial context of rows j = rg, rg + RG, ... < L for head columns
// [4c, 4c + 4): four rows' loads in flight, rows added in increasing order.
__device__ __forceinline__ void context_rows(const float* sc, int S, int G,
                                             int g0, const int8_t* vr, int H,
                                             int L, int rg, int RG, int c,
                                             float (&acc)[kGC][4]) {
#pragma unroll
  for (int i = 0; i < kGC; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
  int j = rg;
  for (; j + 3 * RG < L; j += 4 * RG) {
    char4 vv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      vv[u] = __ldg(reinterpret_cast<const char4*>(
          vr + (size_t)(j + u * RG) * H + 4 * c));
#pragma unroll
    for (int u = 0; u < 4; ++u) add_row(sc, S, G, g0, j + u * RG, vv[u], acc);
  }
  for (; j < L; j += RG)
    add_row(sc, S, G, g0, j,
            __ldg(reinterpret_cast<const char4*>(vr + (size_t)j * H + 4 * c)),
            acc);
}

// Floats of shared memory that stale_attention_row takes.
inline size_t stale_smem_floats(int G, int S, int H) {
  return (size_t)G * H + (size_t)G * S + 2 * G + kRedFloats;
}

// Stale-cache attention of one (batch, kv-head) row, one block of
// kAttnThreads threads (body of pallas_attention._ctx_prefix_len_cur, f32):
//   s[g, j]  = (q[g] . k[j] - zp_k * sum(q[g])) * k_scale_eff, j < L
//   s_cur[g] = (q[g] . k_new - zp_k * sum(q[g])) * k_scale_eff
//   p = softmax over [s[g, :L], s_cur[g]]
//   ctx[g]   = ((sum_j p[g, j] v[j] + p_cur[g] v_new) - zp_v) * v_scale
// sm holds stale_smem_floats(G, S, H) floats, the G query rows first
// (qs [G][H], written by the caller before a __syncthreads). kr, vr: the
// row's S x H int8 cache; knr, vnr: its new k and v rows (H int8 each);
// out: its G x H context. Scores: one thread per live cache row (four
// 16-byte chunks in flight, kGC query rows' dot products in registers);
// softmax: one warp per query row; context: 4 head columns and one row
// group per thread, partials added in row-group order, the new row's
// column last. Rows at index >= L are not read.
template <typename TOut>
__device__ void stale_attention_row(float* sm, int G, int S, int H, int L,
                                    const int8_t* __restrict__ kr,
                                    const int8_t* __restrict__ vr,
                                    const int8_t* knr, const int8_t* vnr,
                                    TOut* out, float k_scale_eff,
                                    float v_scale, float zp_k, float zp_v) {
  float* qs = sm;                          // [G][H]
  float* sc = qs + (size_t)G * H;          // [G][S] scores, then probs
  float* qsum = sc + (size_t)G * S;        // [G]
  float* pcur = qsum + G;                  // [G] s_cur, then p_cur / denom
  float* red = pcur + G;                   // [RG][kGC][H] context partials
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;

  // sum(q[g]) and the current column's score: one warp per query row.
  for (int g = warp; g < G; g += nwarps) {
    float s = 0.0f, d = 0.0f;
    for (int h = lane; h < H; h += 32) {
      const float qv = qs[g * H + h];
      s = s + qv;
      d = d + qv * (float)knr[h];
    }
    s = warp_sum(s);
    d = warp_sum(d);
    if (lane == 0) {
      qsum[g] = s;
      pcur[g] = (d - zp_k * s) * k_scale_eff;
    }
  }
  __syncthreads();

  // Stale scores: one thread per live cache row.
  for (int j = threadIdx.x; j < L; j += blockDim.x) {
    const int8_t* krow = kr + (size_t)j * H;
    for (int g0 = 0; g0 < G; g0 += kGC) {
      float acc[kGC];
      dot_row(qs, H, G, g0, krow, acc);
#pragma unroll
      for (int i = 0; i < kGC; ++i) {
        const int g = g0 + i;
        if (g < G) sc[(size_t)g * S + j] = (acc[i] - zp_k * qsum[g]) * k_scale_eff;
      }
    }
  }
  __syncthreads();

  // Softmax over [stale scores, current column]: one warp per query row.
  for (int g = warp; g < G; g += nwarps) {
    float* srow = sc + (size_t)g * S;
    const float s_cur = pcur[g];
    float m = s_cur;
    for (int j = lane; j < L; j += 32) m = fmaxf(m, srow[j]);
    m = warp_max(m);
    float sum = 0.0f;
    for (int j = lane; j < L; j += 32) {
      const float p = expf(srow[j] - m);
      srow[j] = p;
      sum = sum + p;
    }
    sum = warp_sum(sum);
    const float p_cur = expf(s_cur - m);
    const float denom = sum + p_cur;
    for (int j = lane; j < L; j += 32) srow[j] = srow[j] / denom;
    __syncwarp();
    if (lane == 0) pcur[g] = p_cur / denom;
  }
  __syncthreads();

  // Context: 4 head columns and one row group per thread.
  const int chunks = H / 4;
  const int RG = blockDim.x / chunks;
  const int c = threadIdx.x % chunks, rg = threadIdx.x / chunks;
  for (int g0 = 0; g0 < G; g0 += kGC) {
    float acc[kGC][4];
    context_rows(sc, S, G, g0, vr, H, L, rg, RG, c, acc);
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
      ctx = ctx + pcur[g] * (float)vnr[h];
      store_f(out, (size_t)g * H + h, (ctx - zp_v) * v_scale);
    }
  }
}

}  // namespace aeqt
