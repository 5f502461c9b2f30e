// Weight-only matmul over packed int4 weights, f32 sums:
//   y[M, N] = (sum over groups t of (x_lo_t . w_lo_t^T + x_hi_t . w_hi_t^T))
//             * s[N] (+ bias)
// The weight is uint8 [N, K/2]. Its K columns fall into groups of `group`
// columns; byte j of group t holds column t*group + j (low nibble) and
// column t*group + group/2 + j (high nibble). group = K is the split-half
// layout (pallas_qmatmul.pack_int4_split); group = bf is the MLP's down
// weight (pallas_mlp.pack_int4_split_grouped).
//
// Used by two fused kernels: qkv_rope.cu (#20) and head_argmax.cu (#4's
//   weight-only branch). The unfused weight-only and blockwise matmuls
//   (#12, #13), the MLP's weight-only branch (#3, mlp_int4_bf16.cu), the
//   norm-fused FC (#14, qmatmul_int4_rmsnorm.cu) and #19's weight-only
//   projection (attention_oproj.cu) run bf16 x on int4_bf16_tc_gemm.cuh
//   and f32 x on qmatmul_int4_simt.cuh.
//
// Arithmetic (the Pallas kernels'): x in its compute dtype (bf16 or f32)
//   and the sign-extended nibbles are f32 operands (a bf16 value times an
//   int4 value is exact in f32); within a group the low-nibble and the
//   high-nibble halves each sum in f32, the two partials are added, and the
//   groups add into an f32 accumulator in order; then y = acc * s (+ b),
//   each product and sum rounded on its own (the library is built with
//   --fmad=false; the FMAs of the contraction are explicit). Only the order
//   of the f32 sum within a half differs from the MXU's, so the result
//   matches the plain version to rounding.
//
// Two kernels, by x's dtype:
//   * f32 x (SIMT f32, qmatmul_int4_simt.cuh): a 128-thread block computes
//     a 32 x 64 tile of y, 4 x 4 outputs a thread, over steps of 32 packed
//     bytes (64 K columns).
//   * bf16 x (tensor cores, mma.sync m16n8k16 bf16 with f32 sums): every
//     operand is exact in bf16 (the nibbles are small integers), so only
//     the order of the f32 sums differs. A warp computes a 16 x 64 tile of
//     y (16 x rows, 8 n-tiles of 8 weight rows) with separate low-half and
//     high-half accumulators, over chunks of 64 packed bytes a weight row:
//     each lane loads 16 weight bytes of each n-tile's row and 32 bytes of
//     each of its two x rows for each half, straight from global memory (x
//     is small and stays in L1/L2). Within a chunk's four k-steps of 16 the
//     mma's k index is mapped onto the chunk's bytes so that those loads
//     are contiguous (lane tig holds bytes 16*tig .. +15): the same map on
//     both operands, so the sum is the same. The nibbles become bf16 by
//     the exponent trick (0x4300 | (u ^ 8) is 136 + value, minus 136).
//     Where the tiles alone give few warps (the MLP's down projection at
//     decode rows: K 16384 over 32 groups, N 2048), the groups are split
//     over the grid, one group a warp, each group's partial written to
//     scratch; a second launch adds them in group order, so the sum is the
//     same as in one pass.
#pragma once

#include <algorithm>
#include <type_traits>

#include "drq_common.cuh"
#include "qmatmul_int4_simt.cuh"

namespace aeqt {

// -- bf16 x: tensor cores -----------------------------------------------------

constexpr int kMmaNT = 8;          // n-tiles of 8 weight rows a warp
constexpr int kMmaBN = 8 * kMmaNT;  // 64 weight rows a warp
constexpr int kMmaBM = 16;          // x rows a warp
constexpr int kMmaWarps = 4;        // warps a block, along N
constexpr int kMmaChunk = 64;       // weight bytes a row per chunk
// Fewer warps than this in the tile grid: split the groups over the grid.
constexpr int kMmaSplitBelow = 1024;

__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two int4 values (the nibbles at bits 0-3 and 16-19 of v, v already
// XOR 0x88888888) as a bf16 pair: 0x4300 | u is the bf16 136 + value.
__device__ __forceinline__ uint32_t nibbles_bf16x2(uint32_t v) {
  const uint32_t biased = (v & 0x000F000Fu) | 0x43004300u;
  const __nv_bfloat162 r = __hsub2(
      *reinterpret_cast<const __nv_bfloat162*>(&biased),
      __floats2bfloat162_rn(136.0f, 136.0f));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// Two int8 values (bytes 0 and 2 of v) as a bf16 pair (exact).
__device__ __forceinline__ uint32_t bytes_bf16x2(uint32_t v) {
  const __nv_bfloat162 r = __floats2bfloat162_rn(
      (float)(int8_t)(v & 0xFFu), (float)(int8_t)((v >> 16) & 0xFFu));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// 16 bf16 values of row r of x [M, K] from column c (32 bytes), 0 past M.
__device__ __forceinline__ void load_x16(const __nv_bfloat16* __restrict__ x,
                                         int r, int M, int K, int c,
                                         uint32_t (&out)[8]) {
  uint4 a = make_uint4(0, 0, 0, 0), b = a;
  if (r < M) {
    const uint4* p = reinterpret_cast<const uint4*>(x + (size_t)r * K + c);
    a = __ldg(p);
    b = __ldg(p + 1);
  }
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// The A fragment of k-step s from a lane's 16 x values of rows gid and
// gid + 8: logical k 2*tig + {0, 1} are the lane's values 4s + {0, 2},
// logical k 2*tig + 8 + {0, 1} its values 4s + {1, 3}.
__device__ __forceinline__ void a_frag(const uint32_t (&r0)[8],
                                       const uint32_t (&r1)[8], int s,
                                       uint32_t (&a)[4]) {
  a[0] = __byte_perm(r0[2 * s], r0[2 * s + 1], 0x5410);
  a[1] = __byte_perm(r1[2 * s], r1[2 * s + 1], 0x5410);
  a[2] = __byte_perm(r0[2 * s], r0[2 * s + 1], 0x7632);
  a[3] = __byte_perm(r1[2 * s], r1[2 * s + 1], 0x7632);
}

// One warp's 16 x 64 tile of the contraction over the weight bytes
// [j_begin, j_end) of each row (whole groups), summed as the SIMT kernel
// sums: per group the low and the high halves in f32, added, and the
// groups into y in order. kPacked: w is packed int4 uint8 [N, K/2] in
// groups of `group` columns; else int8 [N, K] (one group, no high half).
// y[nt][e] is row m0 + gid + 8*(e >> 1), column n0 + 8*nt + 2*tig + (e & 1).
template <bool kPacked>
__device__ __forceinline__ void wo_mma_tile(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
    int M, int N, int K, int group, int m0, int n0, int j_begin, int j_end,
    float (&y)[kMmaNT][4]) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int kb = kPacked ? K / 2 : K;      // weight bytes a row
  const int g2 = kPacked ? group / 2 : K;  // bytes a group
  float lo[kMmaNT][4] = {}, hi[kMmaNT][4] = {};
#pragma unroll
  for (int nt = 0; nt < kMmaNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) y[nt][e] = 0.0f;
  for (int j = j_begin; j < j_end; j += kMmaChunk) {
    const int t = j / g2;
    const int klo = kPacked ? t * group + (j - t * g2) : j;
    uint32_t xl0[8], xl1[8], xh0[8], xh1[8];
    load_x16(x, m0 + gid, M, K, klo + 16 * tig, xl0);
    load_x16(x, m0 + gid + 8, M, K, klo + 16 * tig, xl1);
    if (kPacked) {
      load_x16(x, m0 + gid, M, K, klo + g2 + 16 * tig, xh0);
      load_x16(x, m0 + gid + 8, M, K, klo + g2 + 16 * tig, xh1);
    }
    uint4 wv[kMmaNT];
#pragma unroll
    for (int nt = 0; nt < kMmaNT; ++nt) {
      const int n = n0 + 8 * nt + gid;
      wv[nt] = n < N ? __ldg(reinterpret_cast<const uint4*>(
                           w + (size_t)n * kb + j + 16 * tig))
                     : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      uint32_t al[4], ah[4];
      a_frag(xl0, xl1, s, al);
      if (kPacked) a_frag(xh0, xh1, s, ah);
#pragma unroll
      for (int nt = 0; nt < kMmaNT; ++nt) {
        const uint32_t word = s == 0 ? wv[nt].x : s == 1 ? wv[nt].y
                            : s == 2 ? wv[nt].z : wv[nt].w;
        if (kPacked) {
          const uint32_t v = word ^ 0x88888888u;
          mma_bf16(lo[nt], al, nibbles_bf16x2(v), nibbles_bf16x2(v >> 8));
          mma_bf16(hi[nt], ah, nibbles_bf16x2(v >> 4),
                   nibbles_bf16x2(v >> 12));
        } else {
          mma_bf16(lo[nt], al, bytes_bf16x2(word), bytes_bf16x2(word >> 8));
        }
      }
    }
    if ((j + kMmaChunk) % g2 == 0) {  // the end of group t
#pragma unroll
      for (int nt = 0; nt < kMmaNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float part = kPacked ? lo[nt][e] + hi[nt][e] : lo[nt][e];
          y[nt][e] = y[nt][e] + part;
          lo[nt][e] = 0.0f;
          hi[nt][e] = 0.0f;
        }
    }
  }
}

// y = acc * s (+ b) into out [M, N], or, with splits > 1, the warp's
// groups' sum into part [splits][M][N] (blockIdx.z its group).
template <typename TOut>
__global__ void __launch_bounds__(kMmaWarps * 32)
qmatmul_int4_wo_mma_kernel(const __nv_bfloat16* __restrict__ x,
                           const uint8_t* __restrict__ w,
                           const float* __restrict__ scale,
                           const float* __restrict__ bias,
                           TOut* __restrict__ out, float* __restrict__ part,
                           int M, int N, int K, int group) {
  const int n0 = (blockIdx.y * kMmaWarps + (threadIdx.x >> 5)) * kMmaBN;
  if (n0 >= N) return;  // warp-uniform; no block-wide barrier below
  const int m0 = blockIdx.x * kMmaBM;
  const int splits = gridDim.z;
  const int g2 = group / 2;
  const int j_begin = splits > 1 ? blockIdx.z * g2 : 0;
  const int j_end = splits > 1 ? j_begin + g2 : K / 2;
  float y[kMmaNT][4];
  wo_mma_tile<true>(x, w, M, N, K, group, m0, n0, j_begin, j_end, y);
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int nt = 0; nt < kMmaNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m0 + gid + 8 * (e >> 1);
      const int n = n0 + 8 * nt + 2 * tig + (e & 1);
      if (m >= M || n >= N) continue;
      if (splits > 1) {
        part[((size_t)blockIdx.z * M + m) * N + n] = y[nt][e];
      } else {
        float v = y[nt][e] * scale[n];
        if (bias != nullptr) v = v + bias[n];
        store_f(out, (size_t)m * N + n, v);
      }
    }
}

// out = (sum over groups t in order of part[t]) * s (+ b).
template <typename TOut>
__global__ void __launch_bounds__(256)
wo_groups_sum_kernel(const float* __restrict__ part,
                     const float* __restrict__ scale,
                     const float* __restrict__ bias, TOut* __restrict__ out,
                     int M, int N, int splits) {
  const size_t mn = (size_t)M * N;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < mn;
       i += (size_t)gridDim.x * blockDim.x) {
    float acc = 0.0f;
    for (int t = 0; t < splits; ++t) acc = acc + part[t * mn + i];
    const int n = (int)(i % N);
    float v = acc * scale[n];
    if (bias != nullptr) v = v + bias[n];
    store_f(out, i, v);
  }
}

// The number of groups the bf16 kernel splits over the grid (1: none).
inline int wo_splits(int M, int N, int K, int group) {
  const int warps = ((M + kMmaBM - 1) / kMmaBM) * ((N + kMmaBN - 1) / kMmaBN);
  return (K / group > 1 && warps < kMmaSplitBelow) ? K / group : 1;
}

// f32 scratch the bf16 kernel needs for a shape (0: none).
inline size_t wo_scratch_floats(int M, int N, int K, int group) {
  const int splits = wo_splits(M, N, K, group);
  return splits > 1 ? (size_t)splits * M * N : 0;
}

// Whether the kernels take the shape: N % 64 == 0, group % 128 == 0 (whole
// chunks of 64 bytes, and whole steps of 32 bytes, in a group's half) and
// K % group == 0.
inline bool wo_shape_ok(int M, int N, int K, int group) {
  return M > 0 && N > 0 && K > 0 && group > 0 && N % kWpBN == 0 &&
         group % (2 * kMmaChunk) == 0 && K % group == 0;
}

// x [M, K] f32 -> the SIMT kernel; bf16 -> the tensor-core kernel, which
// needs `part` (wo_scratch_floats of the shape, f32) where it splits.
template <typename TIn, typename TOut>
int launch_wo(const void* x, const void* w, const void* scale,
              const void* bias, void* out, int M, int N, int K, int group,
              float* part, cudaStream_t stream) {
  if (!wo_shape_ok(M, N, K, group)) return kShapeRefused;
  if constexpr (std::is_same<TIn, float>::value) {
    const dim3 grid(N / kWpBN, (M + kWpBM - 1) / kWpBM);
    qmatmul_int4_wo_kernel<TIn, TOut><<<grid, kWpThreads, 0, stream>>>(
        static_cast<const TIn*>(x), static_cast<const uint8_t*>(w),
        static_cast<const float*>(scale), static_cast<const float*>(bias),
        static_cast<TOut*>(out), M, N, K, group, nullptr);
    return (int)cudaGetLastError();
  } else {
    const int splits = wo_splits(M, N, K, group);
    if (splits > 1 && part == nullptr) return kShapeRefused;
    // The row tiles of one weight tile are neighbours in launch order, so
    // they read it while it is in L2.
    const dim3 grid((M + kMmaBM - 1) / kMmaBM,
                    (N / kMmaBN + kMmaWarps - 1) / kMmaWarps, splits);
    qmatmul_int4_wo_mma_kernel<TOut><<<grid, kMmaWarps * 32, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(w),
        static_cast<const float*>(scale), static_cast<const float*>(bias),
        static_cast<TOut*>(out), part, M, N, K, group);
    int err = (int)cudaGetLastError();
    if (err != 0 || splits == 1) return err;
    const size_t mn = (size_t)M * N;
    const int blocks = (int)std::min<size_t>((mn + 255) / 256, 65536);
    wo_groups_sum_kernel<TOut><<<blocks, 256, 0, stream>>>(
        part, static_cast<const float*>(scale),
        static_cast<const float*>(bias), static_cast<TOut*>(out), M, N,
        splits);
    return (int)cudaGetLastError();
  }
}

}  // namespace aeqt
