// Lengths-masked decode attention over an int8 KV cache whose row `pos` is
// replaced by the new token's K/V rows, which it also writes into the
// caches (f32 compute).
//
// Replaces: ai_edge_quantizer_tpu/kernels/pallas_attention.py
//   decode_attention_int8_lengths_writeback (f32 branch of
//   _ctx_prefix_len over the spliced cache). The JAX executor runs it for
//   each decode attention whose cache row write it folds in, under
//   AEQT_ATTN_WRITEBACK_MODE=splice with AEQT_ATTN_LENGTHS=1 (18 a step for
//   Gemma-2B). For each (batch, kv-head) row r with L = lengths[b] live
//   rows and p = clip(pos, 0, S - 1):
//     k'[j] = k_new if j == p else k[j]   (v' likewise)
//     s[g, j] = (q[g] . k'[j] - zp_k * sum(q[g])) * k_scale_eff, j < L
//     ctx[g]  = (sum_j softmax(s)[g, j] v'[j] - zp_v) * v_scale
//   and k[p] = k_new, v[p] = v_new are written into the caches, whose
//   storage is the output (the TPU kernel aliases its cache outputs to its
//   inputs). With L == 0 every score is -1e30 and each of the S rows gets
//   weight 1/S, the spliced row among them.
//
// Bound on the H100: the cache bytes of the live rows, 2 * L * H a row,
//   plus the two new rows read and written (at the bench shape, B 256, H
//   256, 897 live rows: 117.6 MB, 35 us).
//
// Design: the lengths kernel (attention_lengths.cu) with the row pointer
//   chosen per cache row: row p is read from k_new / v_new, never from the
//   cache, so the block's own write of row p (after its last read, at the
//   end) races with no read; no other block touches row r. The TPU kernel
//   writes back the whole 32-row tile around p (HBM writes must cover full
//   tiles); here only the two rows move. The wrapper keeps the TPU gate
//   S % 32 == 0 so that the routes agree.
#include "attention_common.cuh"

namespace {

using aeqt::kGC;
using aeqt::kRedFloats;
constexpr int kThreads = aeqt::kAttnThreads;

// context_rows of attention_common.cuh with cache row p read from vnr.
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
    aeqt::add_row(sc, S, G, g0, j,
                  __ldg(reinterpret_cast<const char4*>(row + 4 * c)), acc);
  }
}

template <typename TOut>
__global__ void __launch_bounds__(kThreads)
writeback_attention_kernel(const float* __restrict__ q, int8_t* k, int8_t* v,
                           const int8_t* __restrict__ k_new,
                           const int8_t* __restrict__ v_new,
                           const int* __restrict__ lengths,
                           const int* __restrict__ pos_ptr,
                           TOut* __restrict__ out, int NK, int G, int S,
                           int H, float k_scale_eff, float v_scale,
                           float zp_k, float zp_v) {
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
  const int p = min(max(*pos_ptr, 0), S - 1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  int8_t* kr = k + (size_t)row * S * H;
  int8_t* vr = v + (size_t)row * S * H;
  const int8_t* knr = k_new + (size_t)row * H;
  const int8_t* vnr = v_new + (size_t)row * H;

  const float* qr = q + (size_t)row * G * H;
  for (int i = threadIdx.x; i < G * H; i += blockDim.x) qs[i] = qr[i];
  __syncthreads();

  for (int g = warp; g < G; g += nwarps) {
    float s = 0.0f;
    for (int h = lane; h < H; h += 32) s = s + qs[g * H + h];
    s = aeqt::warp_sum(s);
    if (lane == 0) qsum[g] = s;
  }
  __syncthreads();

  // Scores: one thread per live cache row, row p from k_new.
  for (int j = threadIdx.x; j < L; j += blockDim.x) {
    const int8_t* krow = j == p ? knr : kr + (size_t)j * H;
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

  for (int g = warp; g < G; g += nwarps) {
    float* srow = sc + (size_t)g * S;
    float m = aeqt::kNegInf;
    for (int j = lane; j < L; j += 32) m = fmaxf(m, srow[j]);
    m = aeqt::warp_max(m);
    float sum = 0.0f;
    for (int j = lane; j < L; j += 32) {
      const float e = expf(srow[j] - m);
      srow[j] = e;
      sum = sum + e;
    }
    sum = aeqt::warp_sum(sum);
    for (int j = lane; j < L; j += 32) srow[j] = srow[j] / sum;
  }
  __syncthreads();

  const int chunks = H / 4;
  const int RG = blockDim.x / chunks;
  const int c = threadIdx.x % chunks, rg = threadIdx.x / chunks;
  for (int g0 = 0; g0 < G; g0 += kGC) {
    float acc[kGC][4];
    context_rows_spliced(sc, S, G, g0, vr, vnr, p, H, L, rg, RG, c, acc);
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
      for (int r = 0; r < RG; ++r)
        ctx = ctx + red[((size_t)r * kGC + i) * H + h];
      aeqt::store_f(out, ((size_t)row * G + g) * H + h,
                    (ctx - zp_v) * v_scale);
    }
  }

  // The row write, after every read of this row's caches.
  for (int i = threadIdx.x; i < H; i += blockDim.x) {
    kr[(size_t)p * H + i] = knr[i];
    vr[(size_t)p * H + i] = vnr[i];
  }
}

template <typename TOut>
int launch(const void* q, void* k, void* v, const void* k_new,
           const void* v_new, const void* lengths, const void* pos, void* out,
           int R, int NK, int G, int S, int H, float k_scale_eff,
           float v_scale, float zp_k, float zp_v, cudaStream_t stream) {
  const size_t smem =
      ((size_t)G * H + (size_t)G * S + G + kRedFloats) * sizeof(float);
  if (!aeqt::head_dim_fits(H) || S % 32 != 0 || !aeqt::smem_fits(smem))
    return aeqt::kShapeRefused;
  auto* kernel = writeback_attention_kernel<TOut>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<R, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<int8_t*>(k),
      static_cast<int8_t*>(v), static_cast<const int8_t*>(k_new),
      static_cast<const int8_t*>(v_new), static_cast<const int*>(lengths),
      static_cast<const int*>(pos), static_cast<TOut*>(out), NK, G, S, H,
      k_scale_eff, v_scale, zp_k, zp_v);
  return (int)cudaGetLastError();
}

}  // namespace

// q f32 [R, G, H] with R = B * NK; k, v int8 [R, S, H] (written at row
// clip(*pos, 0, S - 1)); k_new, v_new int8 [R, H]; lengths int32 [B]; pos
// int32 [1] on the device; out [R, G, H] f32 or bf16 (out_bf16). Returns
// aeqt::kShapeRefused unless H % 16 == 0, 1024 % H == 0, S % 32 == 0 and
// the G x S scores fit in shared memory.
extern "C" int aeqt_attention_writeback(const void* q, void* k, void* v,
                                        const void* k_new, const void* v_new,
                                        const void* lengths, const void* pos,
                                        void* out, int out_bf16, int R,
                                        int NK, int G, int S, int H,
                                        float k_scale_eff, float v_scale,
                                        float zp_k, float zp_v,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    return launch<__nv_bfloat16>(q, k, v, k_new, v_new, lengths, pos, out, R,
                                 NK, G, S, H, k_scale_eff, v_scale, zp_k,
                                 zp_v, s);
  return launch<float>(q, k, v, k_new, v_new, lengths, pos, out, R, NK, G, S,
                       H, k_scale_eff, v_scale, zp_k, zp_v, s);
}
