// Decode attention over a stale (pre-write) int8 KV cache plus the new
// token's k/v row as one inline softmax column, f32 compute.
//
// Replaces: ai_edge_quantizer_tpu/kernels/pallas_attention.py
//   decode_attention_int8_lengths_stale (_ctx_prefix_len_cur, f32 branch).
//   For each (batch, kv-head) row r with L = lengths[b] - 1 stale rows:
//     s[g, j]  = (q[g] . k[j] - zp_k * sum(q[g])) * k_scale_eff, j < L
//     s_cur[g] = (q[g] . k_new - zp_k * sum(q[g])) * k_scale_eff
//     p = softmax over [s[g, :L], s_cur[g]]
//     ctx[g]   = ((sum_j p[g, j] v[j] + p_cur[g] v_new) - zp_v) * v_scale
//   where k_scale_eff = k_scale / sqrt(H) is formed by the caller. Rows at
//   index >= L are masked in the TPU kernel (exp underflows to exactly 0),
//   so this kernel does not read them at all.
//
// Bound on the H100: the cache bytes of the live rows, 2 * L * H per
//   (batch, kv-head) row over 3.35 TB/s: at Gemma-2B (H = 256, one KV head)
//   with B = 64 and full rows (L = 1023) that is 33.5 MB, about 10 us.
//
// Design (simple first): one block of 256 threads per (batch, kv-head)
//   row; the G query rows (G <= 31 at decode) are staged in shared memory.
//   Scores: one thread per cache row reads its row in 16-byte chunks, four
//   in flight at once, and
//   keeps 8 query rows' dot products in registers; the [G, L] scores live
//   in shared memory. Softmax: one warp per query row (max, exp, sum,
//   divide, as the TPU kernel orders them). Context: each thread takes 4
//   head columns and one of RG = 1024 / H row groups (rows rg, rg + RG,
//   ...), so a warp reads contiguous 128-byte pieces of a V row and four
//   rows of every group are in flight together; the partial sums meet in shared
//   memory and are added in row-group order, so the result does not depend
//   on timing. The new row's column is added last.
#include "drq_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGC = 8;  // query rows a thread keeps in registers at once
// Context partials: [RG][kGC][H] floats with RG * H = 4 * kThreads.
constexpr int kRedFloats = 4 * kThreads * kGC;

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

template <typename TOut>
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
  float* qs = sm;                          // [G][H]
  float* sc = qs + (size_t)G * H;          // [G][S] scores, then probs
  float* qsum = sc + (size_t)G * S;        // [G]
  float* pcur = qsum + G;                  // [G] s_cur, then p_cur / denom
  float* red = pcur + G;                   // [RG][kGC][H] context partials
  const int row = blockIdx.x;
  const int b = row / NK;
  const int L = min(max(lengths[b] - 1, 0), S);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;

  const float* qr = q + (size_t)row * G * H;
  for (int i = threadIdx.x; i < G * H; i += blockDim.x) qs[i] = qr[i];
  __syncthreads();

  // sum(q[g]) and the current column's score: one warp per query row.
  const int8_t* knr = k_new + (size_t)row * H;
  for (int g = warp; g < G; g += nwarps) {
    float s = 0.0f, d = 0.0f;
    for (int h = lane; h < H; h += 32) {
      const float qv = qs[g * H + h];
      s = s + qv;
      d = d + qv * (float)knr[h];
    }
    s = aeqt::warp_sum(s);
    d = aeqt::warp_sum(d);
    if (lane == 0) {
      qsum[g] = s;
      pcur[g] = (d - zp_k * s) * k_scale_eff;
    }
  }
  __syncthreads();

  // Stale scores: one thread per live cache row.
  const int8_t* kr = k + (size_t)row * S * H;
  for (int j = threadIdx.x; j < L; j += blockDim.x) {
    const int8_t* krow = kr + (size_t)j * H;
    for (int g0 = 0; g0 < G; g0 += kGC) {
      float acc[kGC];
#pragma unroll
      for (int i = 0; i < kGC; ++i) acc[i] = 0.0f;
      // Four 16-byte chunks of the row in flight at once.
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
    m = aeqt::warp_max(m);
    float sum = 0.0f;
    for (int j = lane; j < L; j += 32) {
      const float p = expf(srow[j] - m);
      srow[j] = p;
      sum = sum + p;
    }
    sum = aeqt::warp_sum(sum);
    const float p_cur = expf(s_cur - m);
    const float denom = sum + p_cur;
    for (int j = lane; j < L; j += 32) srow[j] = srow[j] / denom;
    __syncwarp();
    if (lane == 0) pcur[g] = p_cur / denom;
  }
  __syncthreads();

  // Context: 4 head columns and one row group per thread.
  const int8_t* vr = v + (size_t)row * S * H;
  const int8_t* vnr = v_new + (size_t)row * H;
  const int chunks = H / 4;
  const int RG = blockDim.x / chunks;
  const int c = threadIdx.x % chunks, rg = threadIdx.x / chunks;
  for (int g0 = 0; g0 < G; g0 += kGC) {
    float acc[kGC][4];
#pragma unroll
    for (int i = 0; i < kGC; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
    // Four rows' loads in flight at once, rows added in increasing order.
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
      aeqt::store_f(out, ((size_t)row * G + g) * H + h, (ctx - zp_v) * v_scale);
    }
  }
}

template <typename TOut>
int launch(const void* q, const void* k, const void* v, const void* k_new,
           const void* v_new, const void* lengths, void* out, int R, int NK,
           int G, int S, int H, float k_scale_eff, float v_scale, float zp_k,
           float zp_v, cudaStream_t stream) {
  const size_t smem =
      ((size_t)G * H + (size_t)G * S + 2 * G + kRedFloats) * sizeof(float);
  auto* kernel = stale_attention_kernel<TOut>;
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

}  // namespace

// q f32 [R, G, H] with R = B * NK; k, v int8 [R, S, H]; k_new, v_new int8
// [R, H]; lengths int32 [B] (counting the new token); out [R, G, H] f32 or
// bf16 (out_bf16). H % 16 == 0 and 1024 % H == 0.
extern "C" int aeqt_attention_stale(const void* q, const void* k,
                                    const void* v, const void* k_new,
                                    const void* v_new, const void* lengths,
                                    void* out, int out_bf16, int R, int NK,
                                    int G, int S, int H, float k_scale_eff,
                                    float v_scale, float zp_k, float zp_v,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    return launch<__nv_bfloat16>(q, k, v, k_new, v_new, lengths, out, R, NK,
                                 G, S, H, k_scale_eff, v_scale, zp_k, zp_v, s);
  return launch<float>(q, k, v, k_new, v_new, lengths, out, R, NK, G, S, H,
                       k_scale_eff, v_scale, zp_k, zp_v, s);
}
