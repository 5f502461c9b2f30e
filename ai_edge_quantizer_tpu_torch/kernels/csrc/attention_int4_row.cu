// Decode attention over int4 K/V pools with one scale per cache row (per
// token), masked by prefix lengths.
//
// Replaces: ai_edge_quantizer_tpu/kernels/pallas_attention.py
//   decode_attention_int4_lengths (body _ctx_prefix_len_int4). The pools
//   are [R, S, H/2] uint8 with R = B * NK, split-half along H: byte i holds
//   column i in its low nibble and column H/2 + i in its high nibble, both
//   signed, ((u & 0xF) ^ 8) - 8. The scales [R, 8, S] bf16 hold the K row
//   scales in row 0 and the V row scales in row 1 (rows 2-7 pad the TPU
//   tile and are not read). For each row r with L = lengths[b] live rows:
//     qb[g]   = bf16(q[g])
//     s[g, j] = ((qb[g][:H/2] . lo_k[j]) + (qb[g][H/2:] . hi_k[j]))
//               * kscale[j] * inv_sqrt_h,                 j < L
//     p       = softmax over j in f32 (max, exp, sum, divide)
//     pv      = bf16(p * vscale[j])
//     ctx[g]  = [pv[g] . lo_v, pv[g] . hi_v]               (f32 sums)
//   with inv_sqrt_h = f32(1 / sqrt(H)), multiplied after kscale. The two
//   half dots are separate f32 sums added in that order. q and the nibbles
//   are exact in bf16 and their products exact in f32, so only the order
//   of each sum can differ from the TPU. The Pallas kernel scores all S
//   rows and sets rows >= L to -1e30 (they weigh exactly 0); with L == 0
//   each of the S rows weighs 1/S, and the kernel then reads all S rows.
//
// Bound on the H100: bytes. A live row costs H bytes of packed K and V and
//   4 bytes of its two scales: at the A/B tool's shape (B 256, one KV head,
//   G 8, H 256, 1022 live rows) about 68 MB, 0.02 ms at 3.35 TB/s, against
//   4 G H L products a row (1.1 GFLOP, 0.001 ms on the bf16 tensor cores).
//
// Design: attention_split_tc.cuh's per-row int4 body (`attend_int4r`), the
//   cluster split, ring, softmax exchange and partial gather of the lengths
//   (#7) and int4-group (#10) bodies: the S rows of a (batch, kv-head) row
//   split across a cluster of CTAs sized by the occupancy query; a CTA
//   streams its live rows' packed codes and their scales (S is the minor
//   axis of kv_scales, so a chunk's K or V scales are one 256-byte strip)
//   through a two-stage ring of bulk copies, two a chunk. Scores: as #10's,
//   one f32 FMA chain a half dot in the plain version's order on the card
//   (bf16(q) over h = 0 .. H/2 - 1 against the low nibbles, and over the
//   high half against the high nibbles, read from the K chunk copied to
//   padded rows), then ((lo + hi) * kscale) * inv_sqrt_h: the check rounds
//   p * vscale to bf16 before the context, which a one-ulp difference of a
//   score flips. Softmax: f32 probabilities, the maxima and sums met across
//   the cluster in split order. Context on the bf16 tensor cores (mma.sync
//   m16n8k16, f32 sums): the V nibble widened to bf16 exactly (0x4300 |
//   (u ^ 8), less 136) as A, bf16(p * vscale) as the N side; warps split H
//   by nibble. The output is f32 or bf16, rounded once at the write.
//
// Shapes the core does not take (H other than 64, 128 or 256, G > 16,
//   R > 65535, S % 8 != 0, kv_scales not 16-byte aligned, or a slice past
//   shared memory) go, by that fixed rule, to the first design's one-block
//   kernel below (SIMT): one block of 256 threads per (batch, kv-head) row.
//   bf16(q) sits in shared memory. Scores: one thread per live row, 16
//   packed bytes (16 low and 16 high columns) a load, the kGC query rows'
//   two half dots in registers. Softmax: one warp per query row in the TPU
//   kernel's order, then bf16(p * vscale) as the context operand. Context:
//   2 packed bytes (columns 2c, 2c + 1 and H/2 + 2c, H/2 + 2c + 1) and one
//   row group per thread, the row groups' partials added in a fixed order,
//   so the result does not depend on timing. Every product and sum is
//   rounded on its own (--fmad=false).
#include "attention_common.cuh"
#include "attention_split_tc.cuh"

namespace {

using aeqt::kGC;
using aeqt::kRedFloats;
constexpr int kThreads = aeqt::kAttnThreads;

__device__ __forceinline__ float bf16_bits(uint16_t bits) {
  return __uint_as_float((uint32_t)bits << 16);
}

__device__ __forceinline__ float nibble_lo(uint32_t byte) {
  return (float)((int)((byte & 0xFu) ^ 8u) - 8);
}

__device__ __forceinline__ float nibble_hi(uint32_t byte) {
  return (float)((int)(((byte >> 4) & 0xFu) ^ 8u) - 8);
}

__global__ void __launch_bounds__(kThreads)
int4_row_attention_kernel(const float* __restrict__ q,
                          const uint8_t* __restrict__ kp,
                          const uint8_t* __restrict__ vp,
                          const uint16_t* __restrict__ scales,
                          const int* __restrict__ lengths,
                          void* __restrict__ out, int out_bf16, int NK,
                          int G, int S, int H, float inv_sqrt_h) {
  extern __shared__ __align__(16) float sm[];
  const int H2 = H / 2;
  float* qs = sm;                          // [G][H] bf16(q)
  float* sc = qs + (size_t)G * H;          // [G][S] scores, then pv
  float* red = sc + (size_t)G * S;         // [RG][kGC][H] context partials
  const int row = blockIdx.x;
  const int b = row / NK;
  const int len = lengths[b];
  const bool none = len <= 0;  // every TPU score is -1e30
  const int L = none ? S : min(len, S);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const uint16_t* kscale = scales + (size_t)row * 8 * S;
  const uint16_t* vscale = kscale + S;

  const float* qr = q + (size_t)row * G * H;
  for (int i = threadIdx.x; i < G * H; i += blockDim.x)
    qs[i] = aeqt::round_bf16(qr[i]);
  __syncthreads();

  // Scores: one thread per live cache row.
  const uint8_t* kr = kp + (size_t)row * S * H2;
  for (int j = threadIdx.x; j < L; j += blockDim.x) {
    const uint8_t* krow = kr + (size_t)j * H2;
    const float ks = bf16_bits(__ldg(kscale + j));
    for (int g0 = 0; g0 < G; g0 += kGC) {
      if (none) {
        for (int i = 0; i < kGC && g0 + i < G; ++i)
          sc[(size_t)(g0 + i) * S + j] = aeqt::kNegInf;
        continue;
      }
      float lo[kGC], hi[kGC];
#pragma unroll
      for (int i = 0; i < kGC; ++i) lo[i] = hi[i] = 0.0f;
      for (int b0 = 0; b0 < H2; b0 += 16) {
        const uint4 w = __ldg(reinterpret_cast<const uint4*>(krow + b0));
        const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const uint32_t byte = (words[e >> 2] >> (8 * (e & 3))) & 0xFFu;
          const float kl = nibble_lo(byte), kh = nibble_hi(byte);
#pragma unroll
          for (int i = 0; i < kGC; ++i) {
            if (g0 + i < G) {
              const float* qq = qs + (size_t)(g0 + i) * H + b0 + e;
              lo[i] = lo[i] + qq[0] * kl;
              hi[i] = hi[i] + qq[H2] * kh;
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kGC; ++i)
        if (g0 + i < G)
          sc[(size_t)(g0 + i) * S + j] = ((lo[i] + hi[i]) * ks) * inv_sqrt_h;
    }
  }
  __syncthreads();

  // Softmax over the L live scores: one warp per query row; the context's
  // operand is bf16(p * vscale).
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
    for (int j = lane; j < L; j += 32)
      srow[j] = aeqt::round_bf16((srow[j] / sum) * bf16_bits(__ldg(vscale + j)));
  }
  __syncthreads();

  // Context: 2 packed bytes (columns 2c, 2c + 1 in the low nibbles and
  // H/2 + 2c, H/2 + 2c + 1 in the high ones) and one row group per thread.
  const uint8_t* vr = vp + (size_t)row * S * H2;
  const int chunks = H / 4;
  const int RG = blockDim.x / chunks;
  const int c = threadIdx.x % chunks, rg = threadIdx.x / chunks;
  const int col[4] = {2 * c, 2 * c + 1, H2 + 2 * c, H2 + 2 * c + 1};
  for (int g0 = 0; g0 < G; g0 += kGC) {
    float acc[kGC][4];
#pragma unroll
    for (int i = 0; i < kGC; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
    for (int j = rg; j < L; j += RG) {
      const uint32_t w = __ldg(reinterpret_cast<const unsigned short*>(
          vr + (size_t)j * H2 + 2 * c));
      const float vv[4] = {nibble_lo(w), nibble_lo(w >> 8), nibble_hi(w),
                           nibble_hi(w >> 8)};
#pragma unroll
      for (int i = 0; i < kGC; ++i) {
        if (g0 + i < G) {
          const float p = sc[(size_t)(g0 + i) * S + j];
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][e] = acc[i][e] + p * vv[e];
        }
      }
    }
    __syncthreads();  // the previous pass has read `red`
#pragma unroll
    for (int i = 0; i < kGC; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[((size_t)rg * kGC + i) * H + col[e]] = acc[i][e];
    __syncthreads();
    for (int idx = threadIdx.x; idx < kGC * H; idx += blockDim.x) {
      const int i = idx / H, h = idx % H, g = g0 + i;
      if (g >= G) continue;
      float ctx = 0.0f;
      for (int r = 0; r < RG; ++r) ctx = ctx + red[((size_t)r * kGC + i) * H + h];
      const size_t at = ((size_t)row * G + g) * H + h;
      if (out_bf16)
        aeqt::store_f(static_cast<__nv_bfloat16*>(out), at, ctx);
      else
        aeqt::store_f(static_cast<float*>(out), at, ctx);
    }
  }
}

// The one-block kernel's shared memory.
size_t one_block_smem(int G, int S, int H) {
  return ((size_t)G * H + (size_t)G * S + kRedFloats) * sizeof(float);
}

bool row_fits(int R, int NK, int G, int S, int H) {
  return R > 0 && NK > 0 && G > 0 && S > 0 && H > 0 && H % 32 == 0 &&
         1024 % H == 0;
}

template <int H, int NTS>
__global__ void __launch_bounds__(aeqt::split::kThreads, 2)
int4_row_attention_split_kernel(const aeqt::split::Args a) {
  aeqt::split::attend_int4r<H, NTS>(a);
}

// The split kernel of a shape; nullptr for one the core does not take (the
// one-block kernel's).
aeqt::split::Kernel split_kernel_for(int R, int G, int S, int H) {
  if (!aeqt::split::takes_int4r(R, G, S, H)) return nullptr;
  const bool two = G > 8;  // query rows in two n-tiles
  switch (H) {
    case 64:
      return two ? &int4_row_attention_split_kernel<64, 2>
                 : &int4_row_attention_split_kernel<64, 1>;
    case 128:
      return two ? &int4_row_attention_split_kernel<128, 2>
                 : &int4_row_attention_split_kernel<128, 1>;
    case 256:
      return two ? &int4_row_attention_split_kernel<256, 2>
                 : &int4_row_attention_split_kernel<256, 1>;
  }
  return nullptr;
}

aeqt::split::Plan plan_of(aeqt::split::Kernel kernel, int R, int G, int S,
                          int H) {
  return aeqt::split::choose_plan(kernel, aeqt::split::Int4RowSmem{G, H}, S,
                                  R);
}

}  // namespace

// q f32 [R, G, H] with R = B * NK; k, v uint8 [R, S, H/2]; scales bf16
// [R, 8, S]; lengths int32 [B]; out [R, G, H] f32 or bf16 (out_bf16);
// inv_sqrt_h = f32(1 / sqrt(H)). The split core where it takes the shape,
// else the one-block kernel; returns aeqt::kShapeRefused unless H % 32 ==
// 0, 1024 % H == 0 and one of the two takes the shape (the one-block
// kernel: the G x S scores fit in shared memory).
extern "C" int aeqt_attention_int4_row(const void* q, const void* k,
                                       const void* v, const void* scales,
                                       const void* lengths, void* out,
                                       int out_bf16, int R, int NK, int G,
                                       int S, int H, float inv_sqrt_h,
                                       void* stream) {
  if (!row_fits(R, NK, G, S, H)) return aeqt::kShapeRefused;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const aeqt::split::Kernel split =
      reinterpret_cast<uintptr_t>(scales) % 16 == 0
          ? split_kernel_for(R, G, S, H)
          : nullptr;
  if (split != nullptr) {
    aeqt::split::Args a = {};
    a.q = static_cast<const float*>(q);
    a.k = static_cast<const int8_t*>(k);
    a.v = static_cast<const int8_t*>(v);
    a.out = out;
    a.out_bf16 = out_bf16;
    a.lengths = static_cast<const int*>(lengths);
    a.sidecar = static_cast<const uint16_t*>(scales);
    a.NK = NK;
    a.G = G;
    a.S = S;
    a.ks = inv_sqrt_h;
    return aeqt::split::launch(split, a, plan_of(split, R, G, S, H), R, st);
  }
  const size_t smem = one_block_smem(G, S, H);
  if (!aeqt::smem_fits(smem)) return aeqt::kShapeRefused;
  auto* kernel = int4_row_attention_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<R, kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const uint8_t*>(k),
      static_cast<const uint8_t*>(v), static_cast<const uint16_t*>(scales),
      static_cast<const int*>(lengths), out, out_bf16, NK, G, S, H,
      inv_sqrt_h);
  return (int)cudaGetLastError();
}

// The launch of a shape with 16-byte aligned scales
// (chip_smoke.SPLIT_PLAN_FIELDS); a shape on the one-block kernel gives
// cluster 0, R blocks of all S rows and its shared memory.
extern "C" int aeqt_attention_int4_row_plan(int R, int G, int S, int H,
                                            long long* fields) {
  if (!row_fits(R, 1, G, S, H)) return aeqt::kShapeRefused;
  const aeqt::split::Kernel kernel = split_kernel_for(R, G, S, H);
  if (kernel != nullptr) {
    aeqt::split::plan_fields(plan_of(kernel, R, G, S, H), R, fields);
    return 0;
  }
  const size_t smem = one_block_smem(G, S, H);
  if (!aeqt::smem_fits(smem)) return aeqt::kShapeRefused;
  fields[0] = 0;
  fields[1] = R;
  fields[2] = S;
  fields[3] = kThreads;
  fields[4] = (long long)smem;
  return 0;
}
