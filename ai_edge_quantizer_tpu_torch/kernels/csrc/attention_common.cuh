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

}  // namespace aeqt
