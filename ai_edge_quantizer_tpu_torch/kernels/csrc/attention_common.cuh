// Device helpers shared by the port's int8-cache decode attention kernels
// (attention_stale.cu, attention_lengths.cu, attention_masked.cu,
// attention_writeback.cu and the kernels built on them).
//
// Each kernel takes one block per (batch, kv-head) row, stage the G query
// rows in shared memory, score one cache row per thread (kGC query rows'
// dot products in registers, four 16-byte chunks of the row in flight),
// and form the context with 4 head columns and one row group per thread.
// Every product and sum is rounded on its own (the library is built with
// --fmad=false), in a fixed order.
//
// Compute modes (the TPU kernels' `compute`, pallas_attention.py
// _ctx_prefix_len, _ctx_prefix_len_cur and _decode_attn_mask_kernel_*): a
// template parameter of the stale body and of the lengths, masked and
// splice kernels.
//   kF32:  f32 q, f32 probabilities.
//   kBF16: q rounded to bf16 for the dots (its sum for the zero-point term
//          from the unrounded q); the probabilities rounded to bf16 after
//          the f32 normalisation. int8 K/V values are exact in bf16 and a
//          bf16 x bf16 product is exact in f32, so f32 products of the
//          rounded operands are the TPU's; only the order of the sums
//          differs.
//   kInt8: q_scale = max(absmax, 1e-9) * f32(1/127), q codes
//          rint(q / q_scale) (a true division); the score dot int8 x int8
//          in int32 (__dp4a); scores = acc * q_scale - zp_k * sum(code *
//          q_scale); probability codes rint(p / denom * 127); the context
//          sum of codes times V values, exact (integers below 2^24 in f32),
//          divided by max(sum of the codes, 1).
#pragma once

#include <type_traits>

#include "drq_common.cuh"

namespace aeqt {

constexpr int kAttnThreads = 256;
constexpr int kGC = 8;  // query rows a thread keeps in registers at once
// Context partials: [RG][kGC][H] floats with RG * H = 4 * kAttnThreads.
constexpr int kRedFloats = 4 * kAttnThreads * kGC;
constexpr float kNegInf = -1e30f;  // the TPU kernels' masked score

enum Compute : int { kF32 = 0, kBF16 = 1, kInt8 = 2 };

// f(std::integral_constant<int, c>{}) for the runtime compute code c, so
// that a launcher instantiates its kernel once per mode; kShapeRefused for
// a code that is not a Compute.
template <class F>
int with_compute(int c, F f) {
  switch (c) {
    case kF32: return f(std::integral_constant<int, kF32>{});
    case kBF16: return f(std::integral_constant<int, kBF16>{});
    case kInt8: return f(std::integral_constant<int, kInt8>{});
  }
  return kShapeRefused;
}

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

// acc[i] += q codes of row g0 + i, columns [h, h + 16), . k[h, h + 16), in
// int32 (__dp4a: exact). qc holds the G x H codes, rows 4-byte aligned.
__device__ __forceinline__ void dot16_i8(const int8_t* qc, int H, int G,
                                         int g0, int h, int4 kv,
                                         int (&acc)[kGC]) {
#pragma unroll
  for (int i = 0; i < kGC; ++i) {
    if (g0 + i < G) {
      const int* qq = reinterpret_cast<const int*>(qc + (g0 + i) * H + h);
      int a = acc[i];
      a = __dp4a(kv.x, qq[0], a);
      a = __dp4a(kv.y, qq[1], a);
      a = __dp4a(kv.z, qq[2], a);
      a = __dp4a(kv.w, qq[3], a);
      acc[i] = a;
    }
  }
}

// dot_row with int8 q codes: int32 sums.
__device__ __forceinline__ void dot_row_i8(const int8_t* qc, int H, int G,
                                           int g0,
                                           const int8_t* __restrict__ krow,
                                           int (&acc)[kGC]) {
#pragma unroll
  for (int i = 0; i < kGC; ++i) acc[i] = 0;
  for (int h0 = 0; h0 < H; h0 += 64) {
    int4 kv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (h0 + 16 * u < H)
        kv[u] = __ldg(reinterpret_cast<const int4*>(krow + h0 + 16 * u));
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (h0 + 16 * u < H) dot16_i8(qc, H, G, g0, h0 + 16 * u, kv[u], acc);
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

// The int8 mode's q codes ([G][H] int8) and q scales ([G] f32) live in the
// context partials' space `red`, which the scores no longer need once the
// context starts: they fit for G * H / 4 + G <= kRedFloats (G < 32 at
// H = 1024), which the launchers check.
inline bool compute_fits(int C, int G, int H) {
  return C != kInt8 || (size_t)G * H / 4 + G <= (size_t)kRedFloats;
}
__device__ __forceinline__ int8_t* q_codes(float* red) {
  return reinterpret_cast<int8_t*>(red);
}
__device__ __forceinline__ float* q_scales(float* red, int G, int H) {
  return red + (size_t)G * H / 4;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// One warp per query row of qs [G][H] (f32 q): qsum[g], the sum that the
// zero-point term takes, and the score operands by mode. f32: qs as it is,
// qsum = sum(q). bf16: qsum = sum(q) of the unrounded q, then qs <- bf16(q).
// int8: q_scale and the codes into red (q_codes, q_scales),
// qsum = sum(code * q_scale).
template <int C>
__device__ void prepare_queries(float* qs, float* qsum, float* red, int G,
                                int H) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  int8_t* qc = q_codes(red);
  float* qscale = q_scales(red, G, H);
  for (int g = warp; g < G; g += nwarps) {
    float* qr = qs + (size_t)g * H;
    float s = 0.0f;
    if constexpr (C == kInt8) {
      float m = 0.0f;
      for (int h = lane; h < H; h += 32) m = fmaxf(m, fabsf(qr[h]));
      m = warp_max(m);
      const float scale = fmaxf(m, (float)1e-9) * kInv127;
      for (int h = lane; h < H; h += 32) {
        const float code = rintf(qr[h] / scale);
        qc[(size_t)g * H + h] = (int8_t)(int)code;
        s = s + code * scale;
      }
      s = warp_sum(s);
      if (lane == 0) qscale[g] = scale;
    } else {
      for (int h = lane; h < H; h += 32) s = s + qr[h];
      s = warp_sum(s);
      if constexpr (C == kBF16)
        for (int h = lane; h < H; h += 32) qr[h] = round_bf16(qr[h]);
    }
    if (lane == 0) qsum[g] = s;
  }
}

// Scores of query rows [g0, g0 + kGC) against cache row krow before the
// mask: (q . k - zp_k * qsum) * ks, or with int8 codes
// (float(acc) * q_scale - zp_k * qsum) * ks.
template <int C>
__device__ __forceinline__ void score_rows(const float* qs, const float* qsum,
                                           const float* red, int G, int H,
                                           int g0,
                                           const int8_t* __restrict__ krow,
                                           float zp_k, float ks,
                                           float (&out)[kGC]) {
  if constexpr (C == kInt8) {
    const float* qscale = red + (size_t)G * H / 4;
    int acc[kGC];
    dot_row_i8(reinterpret_cast<const int8_t*>(red), H, G, g0, krow, acc);
#pragma unroll
    for (int i = 0; i < kGC; ++i)
      if (g0 + i < G)
        out[i] = ((float)acc[i] * qscale[g0 + i] - zp_k * qsum[g0 + i]) * ks;
  } else {
    float acc[kGC];
    dot_row(qs, H, G, g0, krow, acc);
#pragma unroll
    for (int i = 0; i < kGC; ++i)
      if (g0 + i < G) out[i] = (acc[i] - zp_k * qsum[g0 + i]) * ks;
  }
}

// The context's operand of a probability p / denom: f32; bf16-rounded; or
// the int8 code rint(p / denom * 127), as a float.
template <int C>
__device__ __forceinline__ float prob_operand(float p, float denom) {
  const float x = p / denom;
  if constexpr (C == kBF16) return round_bf16(x);
  if constexpr (C == kInt8) return rintf(x * 127.0f);
  return x;
}

// The output of a context sum: (acc - zp_v) * v_scale, with int8 codes
// (acc / p_sum - zp_v) * v_scale, p_sum = max(sum of the codes, 1).
template <int C>
__device__ __forceinline__ float finish_ctx(float acc, float p_sum,
                                            float zp_v, float v_scale) {
  if constexpr (C == kInt8) acc = acc / p_sum;
  return (acc - zp_v) * v_scale;
}

// The softmax denominator's accumulator: f32, and f64 in int8, where the
// codes rint(e / sum * 127) hang on the sum's last bit. An f64 sum of the
// f32 terms, rounded once to f32, does not depend on the order of the sum
// (but for a tie of the f32 rounding, about one row in 10^9), so the
// kernels and the plain versions (attention.py `_softmax_sum`), which sum
// in other orders, give the same codes.
template <int C>
using SumT = typename std::conditional<C == kInt8, double, float>::type;

template <typename T>
__device__ __forceinline__ T warp_sum_t(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Softmax of one query row's n scores srow[0, n), in place, by one warp in
// the TPU kernels' order: m = max(m0, max_j s), e = exp(s - m), their sum
// (SumT<C>), then each e replaced by its operand prob_operand<C>(e, sum).
// Returns, on every lane, the sum of the operands (int8: the code sum,
// exact).
template <int C>
__device__ __forceinline__ float softmax_row(float* srow, int n, float m0,
                                             int lane) {
  float m = m0;
  for (int j = lane; j < n; j += 32) m = fmaxf(m, srow[j]);
  m = warp_max(m);
  SumT<C> acc = 0;
  for (int j = lane; j < n; j += 32) {
    const float e = expf(srow[j] - m);
    srow[j] = e;
    acc = acc + (SumT<C>)e;
  }
  const float sum = (float)warp_sum_t(acc);
  float ops = 0.0f;
  for (int j = lane; j < n; j += 32) {
    const float p = prob_operand<C>(srow[j], sum);
    srow[j] = p;
    ops = ops + p;
  }
  if constexpr (C == kInt8) ops = warp_sum(ops);
  return ops;
}

// context_rows with cache row p read from vnr instead of the cache (the
// splice kernel's row), one row in flight.
__device__ __forceinline__ void context_rows_spliced(
    const float* sc, int S, int G, int g0, const int8_t* vr,
    const int8_t* vnr, int p, int H, int L, int rg, int RG, int c,
    float (&acc)[kGC][4]) {
#pragma unroll
  for (int i = 0; i < kGC; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
  for (int j = rg; j < L; j += RG) {
    const int8_t* row = j == p ? vnr : vr + (size_t)j * H;
    add_row(sc, S, G, g0, j, __ldg(reinterpret_cast<const char4*>(row + 4 * c)),
            acc);
  }
}

// The context phase of the lengths, masked and splice kernels, after the
// softmax: out[g] = finish_ctx<C>(sum_{j < L} sc[g, j] v[j], qsum[g]) for
// the G query rows (qsum holds p_sum in int8), cache row p read from vnr
// (p < 0: every row from vr). 4 head columns and one row group per thread;
// the row groups' partials meet in `red` and are added in row-group order,
// so the result does not depend on timing. Overwrites `red` (the int8 q
// codes: the scores must be done).
template <int C, typename TOut>
__device__ __forceinline__ void context_phase(
    const float* sc, const float* qsum, float* red, int G, int S, int H,
    int L, const int8_t* vr, const int8_t* vnr, int p, TOut* out, float zp_v,
    float v_scale) {
  const int chunks = H / 4;
  const int RG = blockDim.x / chunks;
  const int c = threadIdx.x % chunks, rg = threadIdx.x / chunks;
  for (int g0 = 0; g0 < G; g0 += kGC) {
    float acc[kGC][4];
    if (p < 0)
      context_rows(sc, S, G, g0, vr, H, L, rg, RG, c, acc);
    else
      context_rows_spliced(sc, S, G, g0, vr, vnr, p, H, L, rg, RG, c, acc);
    __syncthreads();  // the previous pass (or the scores) has read `red`
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
      for (int r = 0; r < RG; ++r)
        ctx = ctx + red[((size_t)r * kGC + i) * H + h];
      store_f(out, (size_t)g * H + h, finish_ctx<C>(ctx, qsum[g], zp_v,
                                                     v_scale));
    }
  }
}

// Floats of shared memory of the lengths, masked and splice kernels:
// qs [G][H], the scores [G][S], qsum [G] and the context partials.
inline size_t scores_smem_floats(int G, int S, int H) {
  return (size_t)G * H + (size_t)G * S + G + kRedFloats;
}

// Floats of shared memory that stale_attention_row takes.
inline size_t stale_smem_floats(int G, int S, int H) {
  return (size_t)G * H + (size_t)G * S + 2 * G + kRedFloats;
}

// Stale-cache attention of one (batch, kv-head) row, one block of
// kAttnThreads threads (body of pallas_attention._ctx_prefix_len_cur in
// compute mode C):
//   s[g, j]  = (q[g] . k[j] - zp_k * sum(q[g])) * k_scale_eff, j < L
//   s_cur[g] = (q[g] . k_new - zp_k * sum(q[g])) * k_scale_eff
//   p = softmax over [s[g, :L], s_cur[g]]
//   ctx[g]   = ((sum_j p[g, j] v[j] + p_cur[g] v_new) - zp_v) * v_scale
// with the mode's operands (see the top of this file; in int8 the current
// column's codes join the code sum and p_sum). sm holds
// stale_smem_floats(G, S, H) floats, the G query rows first (qs [G][H], f32,
// written by the caller before a __syncthreads). kr, vr: the row's S x H
// int8 cache; knr, vnr: its new k and v rows (H int8 each); out: its G x H
// context. Scores: one thread per live cache row (four 16-byte chunks in
// flight, kGC query rows' dot products in registers); softmax: one warp per
// query row; context: 4 head columns and one row group per thread, partials
// added in row-group order, the new row's column last. Rows at index >= L
// are not read.
template <int C, typename TOut>
__device__ void stale_attention_row(float* sm, int G, int S, int H, int L,
                                    const int8_t* __restrict__ kr,
                                    const int8_t* __restrict__ vr,
                                    const int8_t* knr, const int8_t* vnr,
                                    TOut* out, float k_scale_eff,
                                    float v_scale, float zp_k, float zp_v) {
  float* qs = sm;                          // [G][H]
  float* sc = qs + (size_t)G * H;          // [G][S] scores, then probs
  float* qsum = sc + (size_t)G * S;        // [G] sum(q), then p_sum (int8)
  float* pcur = qsum + G;                  // [G] s_cur, then p_cur's operand
  float* red = pcur + G;                   // [RG][kGC][H] context partials
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;

  prepare_queries<C>(qs, qsum, red, G, H);
  __syncthreads();

  // The current column's score: one warp per query row.
  for (int g = warp; g < G; g += nwarps) {
    float s_cur;
    if constexpr (C == kInt8) {
      const int8_t* qc = q_codes(red) + (size_t)g * H;
      int d = 0;
      for (int h = lane; h < H; h += 32) d = d + (int)qc[h] * (int)knr[h];
      d = warp_sum_int(d);
      s_cur = ((float)d * q_scales(red, G, H)[g] - zp_k * qsum[g]) *
              k_scale_eff;
    } else {
      float d = 0.0f;
      for (int h = lane; h < H; h += 32) d = d + qs[g * H + h] * (float)knr[h];
      d = warp_sum(d);
      s_cur = (d - zp_k * qsum[g]) * k_scale_eff;
    }
    if (lane == 0) pcur[g] = s_cur;
  }

  // Stale scores: one thread per live cache row.
  for (int j = threadIdx.x; j < L; j += blockDim.x) {
    const int8_t* krow = kr + (size_t)j * H;
    for (int g0 = 0; g0 < G; g0 += kGC) {
      float s[kGC];
      score_rows<C>(qs, qsum, red, G, H, g0, krow, zp_k, k_scale_eff, s);
#pragma unroll
      for (int i = 0; i < kGC; ++i)
        if (g0 + i < G) sc[(size_t)(g0 + i) * S + j] = s[i];
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
    SumT<C> sum = 0;
    for (int j = lane; j < L; j += 32) {
      const float p = expf(srow[j] - m);
      srow[j] = p;
      sum = sum + (SumT<C>)p;
    }
    sum = warp_sum_t(sum);
    const float p_cur = expf(s_cur - m);
    const float denom = (float)(sum + (SumT<C>)p_cur);
    float codes = 0.0f;  // int8: the sum of the probability codes (exact)
    for (int j = lane; j < L; j += 32) {
      const float p = prob_operand<C>(srow[j], denom);
      srow[j] = p;
      codes = codes + p;
    }
    if constexpr (C == kInt8) codes = warp_sum(codes);
    __syncwarp();
    if (lane == 0) {
      const float pc = prob_operand<C>(p_cur, denom);
      pcur[g] = pc;
      if constexpr (C == kInt8) qsum[g] = fmaxf(codes + pc, 1.0f);
    }
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
      store_f(out, (size_t)g * H + h, finish_ctx<C>(ctx, qsum[g], zp_v, v_scale));
    }
  }
}

}  // namespace aeqt
