// Prefill-shaped attention over an int8 KV cache with an additive mask:
// an online softmax over S tiles, f32 compute.
//
// Replaces: ai_edge_quantizer_tpu/kernels/pallas_attention.py
//   flash_attention_int8_masked (_flash_attn_kernel). For each (batch,
//   kv-head) row and query row r (R = G * T grouped query rows):
//     s[j]  = (q[r] . k[j] - zp_k * sum(q[r])) * k_scale_eff + mask[r, j]
//     m'    = max(m, max_j s[j]),  a = exp(m - m'),  p[j] = exp(s[j] - m')
//     l     = a * l + sum_j p[j],  acc = a * acc + sum_j p[j] v[j]
//   over the S tiles in order from m = -1e30, l = 0, acc = 0; then
//     out[r] = (acc / max(l, 1e-30) - zp_v) * v_scale      (f32)
//   where k_scale_eff = k_scale / sqrt(H) is formed by the caller. No tile
//   is skipped: masked scores are -1e9 (not -inf), so a fully masked row
//   averages every row of V, as the TPU kernel's does.
//
// Bound on the H100: the TPU kernel's work is 4 * R * S * H operations per
//   (batch, kv-head) row, 8.6 GFLOP at the server's prefill (B = 8, R =
//   1024, S = 1024, H = 256): 8.7 us at the 989 TFLOP/s bf16 tensor-core
//   peak. The bytes (q f32, K and V int8, the f32 mask [B, R, S], the f32
//   output) are 44 MiB, about 13.8 us at 3.35 TB/s: the bound is bytes.
//
// Design (simple first): f32 SIMT, no tensor cores. One block of 256
//   threads per (64 query rows, batch * kv-head row); the 64 q rows stay in
//   shared memory as f32. For each tile of 64 keys the block stages the K
//   and V rows as int8 in shared memory (rows padded by 4 bytes, so a
//   warp's 4-byte reads of 16 rows fall in 16 banks) and widens them in
//   registers. Scores: each thread forms a 4 x 4 block of the 64 x 64 tile
//   (rows ty + 16i, keys tx + 16j) with fmaf, adds the streamed mask and
//   writes it to shared memory. Softmax: one warp per 8 rows keeps m and l
//   in registers. Context: each thread keeps 4 rows x H/16 head columns
//   (4 consecutive columns per 64) of the accumulator in registers, forms
//   the tile's p.V in a second register block and adds acc * a + p.V as
//   the TPU kernel orders it. Keys past S (a ragged last tile) get the
//   score -1e30 and add exactly 0.
#include "drq_common.cuh"

namespace {

constexpr int kBR = 64;       // query rows per block
constexpr int kBS = 64;       // keys per tile
constexpr int kThreads = 256;
constexpr int kRowsPerWarp = kBR / (kThreads / 32);
constexpr float kNeg = -1e30f;

template <int H>
constexpr size_t smem_bytes() {
  return (size_t)kBR * (H + 4) * sizeof(float)   // q
         + 2 * (size_t)kBS * (H + 4)             // K, V tiles
         + (size_t)kBR * (kBS + 1) * sizeof(float)  // scores, then p
         + 2 * (size_t)kBR * sizeof(float);      // sum(q), then a and l
}

template <int H>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q,
                       const int8_t* __restrict__ k,
                       const int8_t* __restrict__ v,
                       const float* __restrict__ mask,
                       float* __restrict__ out, int NK, int R, int S,
                       int mask_nk, float k_scale_eff, float v_scale,
                       float zp_k, float zp_v) {
  constexpr int HC = H / 64;       // 4-column groups per thread
  constexpr int QLD = H + 4;       // q row stride (floats)
  constexpr int KLD = H + 4;       // K / V row stride (bytes)
  constexpr int PLD = kBS + 1;     // score row stride (floats)
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  int8_t* ks = reinterpret_cast<int8_t*>(qs + kBR * QLD);
  int8_t* vs = ks + kBS * KLD;
  float* ps = reinterpret_cast<float*>(vs + kBS * KLD);
  float* qsum = ps + kBR * PLD;
  float* rowv = qsum + kBR;  // a of the current tile; l at the end

  const int bn = blockIdx.y;
  const int b = bn / NK, n = bn % NK;
  const int r0 = blockIdx.x * kBR;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;

  // Stage q rows [r0, r0 + 64) (zeros past R), then sum(q) per row.
  const float* qb = q + (size_t)bn * R * H;
  for (int i = tid; i < kBR * (H / 4); i += kThreads) {
    const int r = i / (H / 4), c4 = i % (H / 4);
    float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r0 + r < R)
      val = *reinterpret_cast<const float4*>(qb + (size_t)(r0 + r) * H + 4 * c4);
    *reinterpret_cast<float4*>(qs + r * QLD + 4 * c4) = val;
  }
  __syncthreads();
  for (int r = warp; r < kBR; r += kThreads / 32) {
    float s = 0.0f;
    for (int h = lane; h < H; h += 32) s = s + qs[r * QLD + h];
    s = aeqt::warp_sum(s);
    if (lane == 0) qsum[r] = s;
  }

  const int8_t* kb = k + (size_t)bn * S * H;
  const int8_t* vb = v + (size_t)bn * S * H;
  const float* mb =
      mask + ((size_t)b * mask_nk + (mask_nk == 1 ? 0 : n)) * R * S;
  float m_run[kRowsPerWarp], l_run[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m_run[i] = kNeg;
    l_run[i] = 0.0f;
  }
  float acc[4][HC][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < HC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.0f;

  for (int s0 = 0; s0 < S; s0 += kBS) {
    const int ns = min(kBS, S - s0);
    __syncthreads();  // the previous tile's K, V and p are read
    // Stage the K and V tiles: 16-byte global loads, 4-byte shared stores.
    for (int i = tid; i < kBS * (H / 16); i += kThreads) {
      const int j = i / (H / 16), c16 = i % (H / 16);
      int4 kv = make_int4(0, 0, 0, 0), vv = make_int4(0, 0, 0, 0);
      if (j < ns) {
        const size_t off = (size_t)(s0 + j) * H + 16 * c16;
        kv = __ldg(reinterpret_cast<const int4*>(kb + off));
        vv = __ldg(reinterpret_cast<const int4*>(vb + off));
      }
      int* kd = reinterpret_cast<int*>(ks + j * KLD + 16 * c16);
      int* vd = reinterpret_cast<int*>(vs + j * KLD + 16 * c16);
      kd[0] = kv.x; kd[1] = kv.y; kd[2] = kv.z; kd[3] = kv.w;
      vd[0] = vv.x; vd[1] = vv.y; vd[2] = vv.z; vd[3] = vv.w;
    }
    __syncthreads();

    // Scores of rows ty + 16i against keys tx + 16j.
    float sacc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sacc[i][j] = 0.0f;
#pragma unroll 4
    for (int h = 0; h < H; h += 4) {
      float4 qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * QLD + h);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const char4 kc =
            *reinterpret_cast<const char4*>(ks + (tx + 16 * j) * KLD + h);
        const float k0 = kc.x, k1 = kc.y, k2 = kc.z, k3 = kc.w;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float a = sacc[i][j];
          a = fmaf(qv[i].x, k0, a);
          a = fmaf(qv[i].y, k1, a);
          a = fmaf(qv[i].z, k2, a);
          a = fmaf(qv[i].w, k3, a);
          sacc[i][j] = a;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const bool row_ok = r0 + r < R;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        float s = kNeg;
        if (col < ns) {
          const float mval =
              row_ok ? mb[(size_t)(r0 + r) * S + s0 + col] : 0.0f;
          s = (sacc[i][j] - zp_k * qsum[r]) * k_scale_eff + mval;
        }
        ps[r * PLD + col] = s;
      }
    }
    __syncthreads();

    // Online softmax: one warp per 8 rows, m and l in registers.
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = kRowsPerWarp * warp + i;
      float* prow = ps + r * PLD;
      const float sa = prow[lane], sb = prow[lane + 32];
      const float m_new = fmaxf(m_run[i], aeqt::warp_max(fmaxf(sa, sb)));
      const float a = expf(m_run[i] - m_new);
      const float pa = expf(sa - m_new), pb = expf(sb - m_new);
      const float psum = aeqt::warp_sum(pa + pb);
      l_run[i] = a * l_run[i] + psum;
      m_run[i] = m_new;
      prow[lane] = pa;
      prow[lane + 32] = pb;
      if (lane == 0) rowv[r] = a;
    }
    __syncthreads();

    // p.V of the tile, then acc = acc * a + p.V.
    float pv[4][HC][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < HC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) pv[i][c][e] = 0.0f;
    for (int j = 0; j < ns; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * PLD + j];
#pragma unroll
      for (int c = 0; c < HC; ++c) {
        const char4 vc =
            *reinterpret_cast<const char4*>(vs + j * KLD + 64 * c + 4 * tx);
        const float vf[4] = {(float)vc.x, (float)vc.y, (float)vc.z,
                             (float)vc.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            pv[i][c][e] = fmaf(p[i], vf[e], pv[i][c][e]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = rowv[ty + 16 * i];
#pragma unroll
      for (int c = 0; c < HC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[i][c][e] = acc[i][c][e] * a + pv[i][c][e];
    }
  }

  __syncthreads();  // every thread has read the last tile's a
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
    if (lane == 0) rowv[kRowsPerWarp * warp + i] = l_run[i];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r0 + r >= R) continue;
    const float denom = fmaxf(rowv[r], 1e-30f);
    float* orow = out + ((size_t)bn * R + r0 + r) * H;
#pragma unroll
    for (int c = 0; c < HC; ++c) {
      float4 o;
      o.x = (acc[i][c][0] / denom - zp_v) * v_scale;
      o.y = (acc[i][c][1] / denom - zp_v) * v_scale;
      o.z = (acc[i][c][2] / denom - zp_v) * v_scale;
      o.w = (acc[i][c][3] / denom - zp_v) * v_scale;
      *reinterpret_cast<float4*>(orow + 64 * c + 4 * tx) = o;
    }
  }
}

template <int H>
int launch(const void* q, const void* k, const void* v, const void* mask,
           void* out, int BN, int NK, int R, int S, int mask_nk,
           float k_scale_eff, float v_scale, float zp_k, float zp_v,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<H>();
  auto* kernel = flash_attention_kernel<H>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((R + kBR - 1) / kBR, BN);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), static_cast<const float*>(mask),
      static_cast<float*>(out), NK, R, S, mask_nk, k_scale_eff, v_scale,
      zp_k, zp_v);
  return (int)cudaGetLastError();
}

}  // namespace

// q f32 [BN, R, H] with BN = B * NK; k, v int8 [BN, S, H]; mask f32
// [B, mask_nk, R, S] with mask_nk 1 (broadcast over kv heads) or NK; out
// f32 [BN, R, H]. H is 64, 128, 192 or 256. Returns aeqt::kShapeRefused for
// another H.
extern "C" int aeqt_flash_attention_int8(const void* q, const void* k,
                                         const void* v, const void* mask,
                                         void* out, int BN, int NK, int R,
                                         int S, int H, int mask_nk,
                                         float k_scale_eff, float v_scale,
                                         float zp_k, float zp_v,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (H) {
    case 64:
      return launch<64>(q, k, v, mask, out, BN, NK, R, S, mask_nk,
                        k_scale_eff, v_scale, zp_k, zp_v, s);
    case 128:
      return launch<128>(q, k, v, mask, out, BN, NK, R, S, mask_nk,
                         k_scale_eff, v_scale, zp_k, zp_v, s);
    case 192:
      return launch<192>(q, k, v, mask, out, BN, NK, R, S, mask_nk,
                         k_scale_eff, v_scale, zp_k, zp_v, s);
    case 256:
      return launch<256>(q, k, v, mask, out, BN, NK, R, S, mask_nk,
                         k_scale_eff, v_scale, zp_k, zp_v, s);
    default:
      return aeqt::kShapeRefused;
  }
}
