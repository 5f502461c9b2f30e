// Decode attention over per-group int4 K/V pools, masked by prefix lengths.
//
// Replaces: ai_edge_quantizer_tpu/kernels/pallas_attention.py
//   decode_attention_int4_group_lengths (body _ctx_prefix_len_int4_group).
//   The pools are [R, S, H/2] uint8 with R = B * NK, split-half along H
//   (byte i holds column i in its low nibble and column H/2 + i in its high
//   nibble); K codes are unsigned in [0, 15], V codes signed, (nib ^ 8) - 8.
//   The sidecar [R, 3 NG, S] bf16 holds per row and group of `group`
//   columns (NG = H / group) the K scale, the K min and the V scale. For
//   each row r with L = lengths[b] live cache rows:
//     qb[g]     = bf16(q[g])
//     K[j, h]   = bf16(kcode[j, h] * kscale[h / group, j])
//     s[g, j]   = (qb[g] . K[j] + sum_n qsum[g, n] * kmin[n, j]) * inv_sqrt_h,
//                 qsum[g, n] the f32 sum of qb[g] over group n, j < L
//     p[g, :]   = bf16(softmax(s[g, :]))
//     V[j, h]   = bf16(vcode[j, h] * vscale[h / group, j])
//     ctx[g]    = sum_j p[g, j] V[j]   (f32)
//   The TPU kernel scores all S rows and sets the scores of rows >= L to
//   -1e30; those rows then weigh exactly 0, so this kernel does not read
//   them. With L == 0 every TPU score is -1e30 and each of the S rows
//   weighs bf16(1/S): the kernel then reads all S rows with the score
//   -1e30, the same function.
//
// Bound on the H100: bytes. A live row costs 2 * H/2 bytes of codes and
//   6 * NG bytes of sidecar (352 B at H = 256, group 16); bench.py's decode
//   (B = 256, one KV head, 897 live rows) moves 80.8 MB, 0.024 ms at
//   3.35 TB/s, against 1.9 GFLOP of products (0.002 ms on the bf16 tensor
//   cores).
//
// Design: attention_split_tc.cuh's int4-group body (`attend_int4g`): the S
//   rows of a (batch, kv-head) row split across a cluster of CTAs sized by
//   the occupancy query; a CTA streams its live rows' packed codes and
//   sidecar strips through a two-stage ring of bulk copies (one for a
//   chunk's codes, one a strip); K and V widened to their bf16 operands in
//   registers (bf16(code * scale), rounded once), the scores, the offset
//   term and the context on the bf16 tensor cores (mma.sync m16n8k16, f32
//   sums); the softmax's maxima and sums, and the context partials, meet
//   in distributed shared memory in split order. The output is f32 or
//   bf16, rounded once at the write.
//
// Shapes the core does not take (H other than 64, 128 or 256, G > 16,
//   R > 65535, S % 8 != 0, a sidecar not 16-byte aligned, or a slice past
//   shared memory) go, by that fixed rule, to the first design's one-block
//   kernel below (SIMT): one block of 256 threads per (batch, kv-head) row,
//   laid out as attention_lengths.cu. bf16(q) and its per-group sums sit in
//   shared memory. Scores: one thread per live row, 16 packed bytes (32
//   columns) per load, each K value rounded to bf16 as the TPU kernel forms
//   its operand, one scale load per run of min(group, 16) columns (a
//   template parameter: five instantiations cover every power-of-two
//   group, so the build stays short). Softmax: one warp per query row, in
//   the TPU kernel's order (max, exp, sum, divide), then the probabilities
//   rounded to bf16. Context: 2 packed bytes (4 columns) and one row group
//   per thread, the row groups' partial sums added in a fixed order, so the
//   result does not depend on timing. Every product and sum is rounded on
//   its own (--fmad=false).
#include "attention_common.cuh"
#include "attention_split_tc.cuh"

namespace {

using aeqt::kGC;
using aeqt::kRedFloats;
constexpr int kThreads = aeqt::kAttnThreads;

// The one-block kernel's shared memory.
size_t one_block_smem(int G, int S, int H, int group) {
  return ((size_t)G * H + (size_t)G * S + kRedFloats +
          (size_t)G * (H / group)) * sizeof(float);
}

__device__ __forceinline__ float bf16_bits(uint16_t bits) {
  return __uint_as_float((uint32_t)bits << 16);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// kSub = min(group, 16): the columns of a 16-column run that share a scale.
template <int kSub>
__global__ void __launch_bounds__(kThreads)
int4_group_attention_kernel(const float* __restrict__ q,
                            const uint8_t* __restrict__ kp,
                            const uint8_t* __restrict__ vp,
                            const uint16_t* __restrict__ sidecar,
                            const int* __restrict__ lengths,
                            void* __restrict__ out, int out_bf16, int NK,
                            int G, int S, int H, int shift,
                            float inv_sqrt_h) {
  const int group = 1 << shift;
  extern __shared__ __align__(16) float sm[];
  const int NG = H >> shift;
  const int H2 = H / 2;
  float* qs = sm;                          // [G][H] bf16(q)
  float* sc = qs + (size_t)G * H;          // [G][S] scores, then probs
  float* red = sc + (size_t)G * S;         // [RG][kGC][H] context partials
  float* qsum = red + kRedFloats;          // [G][NG]
  const int row = blockIdx.x;
  const int b = row / NK;
  const int len = lengths[b];
  const bool none = len <= 0;  // every TPU score is -1e30
  const int L = none ? S : min(len, S);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const uint16_t* kscale = sidecar + (size_t)row * 3 * NG * S;
  const uint16_t* kmin = kscale + (size_t)NG * S;
  const uint16_t* vscale = kmin + (size_t)NG * S;

  const float* qr = q + (size_t)row * G * H;
  for (int i = threadIdx.x; i < G * H; i += blockDim.x)
    qs[i] = round_bf16(qr[i]);
  __syncthreads();
  // Per-group sums of bf16(q), columns in increasing order.
  for (int i = threadIdx.x; i < G * NG; i += blockDim.x) {
    const float* qq = qs + (size_t)(i / NG) * H + (i % NG) * group;
    float s = 0.0f;
    for (int e = 0; e < group; ++e) s = s + qq[e];
    qsum[i] = s;
  }
  __syncthreads();

  // Scores: one thread per live cache row.
  const uint8_t* kr = kp + (size_t)row * S * H2;
  for (int j = threadIdx.x; j < L; j += blockDim.x) {
    const uint8_t* krow = kr + (size_t)j * H2;
    for (int g0 = 0; g0 < G; g0 += kGC) {
      if (none) {
        for (int i = 0; i < kGC && g0 + i < G; ++i)
          sc[(size_t)(g0 + i) * S + j] = aeqt::kNegInf;
        continue;
      }
      float acc[kGC];
#pragma unroll
      for (int i = 0; i < kGC; ++i) acc[i] = 0.0f;
      for (int b0 = 0; b0 < H2; b0 += 16) {
        const uint4 w = __ldg(reinterpret_cast<const uint4*>(krow + b0));
        const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int c0 = half * H2 + b0;  // first unpacked column
#pragma unroll
          for (int e0 = 0; e0 < 16; e0 += kSub) {
            const float s =
                bf16_bits(__ldg(kscale + (size_t)((c0 + e0) >> shift) * S + j));
#pragma unroll
            for (int e = e0; e < e0 + kSub; ++e) {
              const uint32_t byte = (words[e >> 2] >> (8 * (e & 3))) & 0xFFu;
              const uint32_t code = half ? (byte >> 4) : (byte & 0xFu);
              const float kv = round_bf16((float)code * s);
#pragma unroll
              for (int i = 0; i < kGC; ++i)
                if (g0 + i < G)
                  acc[i] = acc[i] + qs[(size_t)(g0 + i) * H + c0 + e] * kv;
            }
          }
        }
      }
      // Offset term: the per-group sums of q against the K mins.
      float off[kGC];
#pragma unroll
      for (int i = 0; i < kGC; ++i) off[i] = 0.0f;
      for (int n = 0; n < NG; ++n) {
        const float m = bf16_bits(__ldg(kmin + (size_t)n * S + j));
#pragma unroll
        for (int i = 0; i < kGC; ++i)
          if (g0 + i < G) off[i] = off[i] + qsum[(size_t)(g0 + i) * NG + n] * m;
      }
#pragma unroll
      for (int i = 0; i < kGC; ++i)
        if (g0 + i < G)
          sc[(size_t)(g0 + i) * S + j] = (acc[i] + off[i]) * inv_sqrt_h;
    }
  }
  __syncthreads();

  // Softmax over the L live scores: one warp per query row; the
  // probabilities are rounded to bf16, the TPU kernel's context operand.
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
    for (int j = lane; j < L; j += 32) srow[j] = round_bf16(srow[j] / sum);
  }
  __syncthreads();

  // Context: 2 packed bytes (columns 2c, 2c + 1 in the low nibbles and
  // H/2 + 2c, H/2 + 2c + 1 in the high ones) and one row group per thread.
  const uint8_t* vr = vp + (size_t)row * S * H2;
  const int chunks = H / 4;
  const int RG = blockDim.x / chunks;
  const int c = threadIdx.x % chunks, rg = threadIdx.x / chunks;
  const int col[4] = {2 * c, 2 * c + 1, H2 + 2 * c, H2 + 2 * c + 1};
  const uint16_t* vs[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) vs[e] = vscale + (size_t)(col[e] >> shift) * S;
  for (int g0 = 0; g0 < G; g0 += kGC) {
    float acc[kGC][4];
#pragma unroll
    for (int i = 0; i < kGC; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
    for (int j = rg; j < L; j += RG) {
      const uint32_t w = __ldg(reinterpret_cast<const unsigned short*>(
          vr + (size_t)j * H2 + 2 * c));
      const uint32_t nib[4] = {w & 0xFu, (w >> 8) & 0xFu, (w >> 4) & 0xFu,
                               (w >> 12) & 0xFu};
      float vv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        vv[e] = round_bf16((float)((int)(nib[e] ^ 8u) - 8) *
                           bf16_bits(__ldg(vs[e] + j)));
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

template <int kSub>
int launch(const void* q, const void* k, const void* v, const void* sidecar,
           const void* lengths, void* out, int out_bf16, int R, int NK, int G,
           int S, int H, int shift, float inv_sqrt_h, cudaStream_t stream) {
  const size_t smem = one_block_smem(G, S, H, 1 << shift);
  if (!aeqt::smem_fits(smem)) return aeqt::kShapeRefused;
  auto* kernel = int4_group_attention_kernel<kSub>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<R, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const uint8_t*>(k),
      static_cast<const uint8_t*>(v), static_cast<const uint16_t*>(sidecar),
      static_cast<const int*>(lengths), out, out_bf16, NK, G, S, H, shift,
      inv_sqrt_h);
  return (int)cudaGetLastError();
}

template <int H, int NTS, int KG>
__global__ void __launch_bounds__(aeqt::split::kThreads, 2)
int4_group_attention_split_kernel(const aeqt::split::Args a) {
  aeqt::split::attend_int4g<H, NTS, KG>(a);
}

template <int H, int NTS>
aeqt::split::Kernel split_kernel_for(int group) {
  switch (group < 16 ? group : 16) {
    case 1: return &int4_group_attention_split_kernel<H, NTS, 1>;
    case 2: return &int4_group_attention_split_kernel<H, NTS, 2>;
    case 4: return &int4_group_attention_split_kernel<H, NTS, 4>;
    case 8: return &int4_group_attention_split_kernel<H, NTS, 8>;
    case 16: return &int4_group_attention_split_kernel<H, NTS, 16>;
  }
  return nullptr;
}

// The split kernel of a shape; nullptr for one the core does not take (the
// one-block kernel's). group is a power of two dividing H / 2.
aeqt::split::Kernel split_kernel_for(int R, int G, int S, int H, int group) {
  if (!aeqt::split::takes_int4g(R, G, S, H, group)) return nullptr;
  const bool two = G > 8;  // query rows in two n-tiles
  switch (H) {
    case 64:
      return two ? split_kernel_for<64, 2>(group)
                 : split_kernel_for<64, 1>(group);
    case 128:
      return two ? split_kernel_for<128, 2>(group)
                 : split_kernel_for<128, 1>(group);
    case 256:
      return two ? split_kernel_for<256, 2>(group)
                 : split_kernel_for<256, 1>(group);
  }
  return nullptr;
}

aeqt::split::Plan plan_of(aeqt::split::Kernel kernel, int R, int G, int S,
                          int H, int group) {
  return aeqt::split::choose_plan(
      kernel, aeqt::split::Int4GroupSmem{G, H, H / group}, S, R);
}

bool group_fits(int R, int NK, int G, int S, int H, int group) {
  return R > 0 && NK > 0 && G > 0 && S > 0 && H > 0 && group > 0 &&
         !(group & (group - 1)) && H % 32 == 0 && 1024 % H == 0 &&
         H % (2 * group) == 0;
}

}  // namespace

// q f32 [R, G, H] with R = B * NK; k, v uint8 [R, S, H/2]; sidecar bf16
// [R, 3 * (H / group), S]; lengths int32 [B]; out [R, G, H] f32 or bf16
// (out_bf16); inv_sqrt_h = f32(1 / sqrt(H)). The split core where it takes
// the shape, else the one-block kernel; returns aeqt::kShapeRefused
// unless group is a power of two dividing H / 2, H % 32 == 0,
// 1024 % H == 0 and one of the two takes the shape (the one-block kernel:
// the G x S scores fit in shared memory).
extern "C" int aeqt_attention_int4_group(const void* q, const void* k,
                                         const void* v, const void* sidecar,
                                         const void* lengths, void* out,
                                         int out_bf16, int R, int NK, int G,
                                         int S, int H, int group,
                                         float inv_sqrt_h, void* stream) {
  if (!group_fits(R, NK, G, S, H, group)) return aeqt::kShapeRefused;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int shift = __builtin_ctz((unsigned)group);
  const aeqt::split::Kernel kernel =
      reinterpret_cast<uintptr_t>(sidecar) % 16 == 0
          ? split_kernel_for(R, G, S, H, group)
          : nullptr;
  if (kernel != nullptr) {
    aeqt::split::Args a = {};
    a.q = static_cast<const float*>(q);
    a.k = static_cast<const int8_t*>(k);
    a.v = static_cast<const int8_t*>(v);
    a.out = out;
    a.out_bf16 = out_bf16;
    a.lengths = static_cast<const int*>(lengths);
    a.sidecar = static_cast<const uint16_t*>(sidecar);
    a.shift = shift;
    a.NK = NK;
    a.G = G;
    a.S = S;
    a.ks = inv_sqrt_h;
    return aeqt::split::launch(kernel, a, plan_of(kernel, R, G, S, H, group),
                               R, st);
  }
  switch (group < 16 ? group : 16) {
#define AEQT_SUB(n)                                                          \
  case n:                                                                    \
    return launch<n>(q, k, v, sidecar, lengths, out, out_bf16, R, NK, G, S, \
                     H, shift, inv_sqrt_h, st);
    AEQT_SUB(1) AEQT_SUB(2) AEQT_SUB(4) AEQT_SUB(8) AEQT_SUB(16)
#undef AEQT_SUB
  }
  return aeqt::kShapeRefused;
}

// The launch of a shape with a 16-byte aligned sidecar
// (chip_smoke.SPLIT_PLAN_FIELDS); a shape on the one-block kernel gives
// cluster 0, R blocks of all S rows and its shared memory.
extern "C" int aeqt_attention_int4_group_plan(int R, int G, int S, int H,
                                              int group, long long* fields) {
  if (!group_fits(R, 1, G, S, H, group)) return aeqt::kShapeRefused;
  const aeqt::split::Kernel kernel = split_kernel_for(R, G, S, H, group);
  if (kernel != nullptr) {
    aeqt::split::plan_fields(plan_of(kernel, R, G, S, H, group), R, fields);
    return 0;
  }
  const size_t smem = one_block_smem(G, S, H, group);
  if (!aeqt::smem_fits(smem)) return aeqt::kShapeRefused;
  fields[0] = 0;
  fields[1] = R;
  fields[2] = S;
  fields[3] = kThreads;
  fields[4] = (long long)smem;
  return 0;
}
