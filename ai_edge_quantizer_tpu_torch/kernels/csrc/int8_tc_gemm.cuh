// Int8 tensor-core core of the DRQ matmuls (#15 qmatmul_int8_drq.cu, #6
// qmatmul_int4_drq_kblock.cu, #1 qmatmul_int4_drq.cu and, with a residual
// in the epilogue, #19's DRQ out projection, attention_oproj.cu; the DRQ
// MLP #3, mlp_int4_drq.cu, builds its own kernels from its pieces) on
// Hopper:
//   y[M, N] = (f32(xq[M, K] . B[N, K]^T) * xs[M]) * s[N] (+ b[N])
//
// Two launches on the caller's stream:
//   1. quantize_rows_kernel: one block per row of x, the row's DRQ codes
//      into int8 scratch xq [M, K] and its scale into xs [M]. Two formulas,
//      each the one its kernel's plain version uses: #15's and #1's
//      reciprocal (rint(x * (1 / xs)), drq_common.cuh's formula) and
//      #6's division (rint(x / xs)); xs = max(absmax, 1e-9) * (1/127) in
//      all three.
//   2. int8_tc_gemm_kernel: a 64 x 128 (one consumer warpgroup, M <= 64)
//      or 128 x 128 (two) output tile per block. One producer warp keeps a
//      ring of 3-8 stages in flight with TMA (cp.async.bulk.tensor, 128-byte
//      swizzle, an mbarrier per stage for "full" and one for "empty"); each
//      stage holds 128 bytes of K of the A rows (the codes) and of the B
//      rows. The consumers run wgmma.mma_async m64n128k32 s32.s8.s8 on the
//      swizzled tiles, both operands K-major from shared memory, sums in
//      int32 registers, and store the tile through shared memory.
//   Launch 2 is a programmatic dependent launch: its blocks start while
//   launch 1 runs, bring their first weight tiles, and wait for launch 1
//   (griddepcontrol.wait) only before the codes and the row scales.
//
// B comes through a loader policy:
//   Int8RowsB    (#15): int8 weight rows w [N, K], loaded as they are.
//   SplitNibbles (#6 SplitNibblesB with the division, #1
//     SplitNibblesRecipB with the reciprocal; the loads and the unpack are
//     the same): split-half packed rows w [N, K/2] (byte j holds
//     w[n, j] in its low nibble and w[n, j + K/2] in its high one). One
//     packed [128, 128-byte] tile per stage; the consumers unpack it, byte
//     for byte in place (the swizzle moves whole bytes, so a swizzled packed
//     tile unpacks to two swizzled s8 tiles with the same layout) into lo
//     and hi tiles (unpack_split_tile, each nibble sign-extended: the
//     bytes of ((v ^ 8) - 8)), and contract lo
//     against xq[:, kb:kb+128] and hi against xq[:, K/2+kb:K/2+kb+128].
//
// Exactness: |acc| <= K * 127 * 128 < 2^31 for every K the kernels are
//   given, so the int32 sum is exact in any order: tensor-core tiles, the
//   K order and split-K all give the plain versions' sums. The float
//   epilogue runs once on the whole sum, each product and the bias add
//   rounded on its own (--fmad=false), stored as bf16 for bf16 x, else
//   f32. TMA fills reads past the edges (rows past M or N, K past its end)
//   with zeros, which add nothing; rows past M and columns past N are never
//   stored. A packed tile past K/2 unpacks to zero weights, so the codes
//   its lo half meets (real hi-half codes) add nothing either.
//
// Split-K: where the output tiles are fewer than the SMs (decode: M = 64
//   gives one row of tiles), K's steps split over gridDim.z, and the splits
//   of a tile are one thread-block cluster (at most kMaxSplit blocks). Each
//   stages its int32 partial tile in its shared memory; after a cluster
//   barrier, block z sums its share of the tile's rows over every split's
//   staged tile (distributed shared memory, mapa) and stores them. Nothing
//   goes through global memory, and nothing carries over between calls.
#pragma once

#include <algorithm>

#include "drq_common.cuh"
#include "tc_ptx.cuh"

namespace aeqt {
namespace tc {

constexpr int kBK = 128;        // bytes of K in a stage: one 128-byte swizzle row
constexpr int kBN = 128;        // output columns of a tile (wgmma n128)
constexpr int kWgRows = 64;     // output rows of one consumer warpgroup (m64)
constexpr int kMaxStages = 8;
constexpr int kMinSplitSteps = 4;  // K steps a split takes at least
// ... under #1 (SplitNibblesRecipB) with one consumer warpgroup, whose K
// <= 8192 gives few steps (K 2048: 8): at decode a split of 4 (two steps
// each) streams the weights on 80 SMs, where 4 steps each would leave 40
// to do it. Two warpgroups keep kMinSplitSteps: at M 256 a split of 2
// beats one of 3 or 4 (PERF.md §6).
constexpr int kMinSplitStepsInt4Drq = 2;
constexpr int kMaxSplit = 4;       // blocks of a split tile: one cluster
constexpr int kQuantThreads = 256;
constexpr size_t kSmemBudget = 232448 - 1024;  // opt-in maximum less static

// ---------------------------------------------------------------- pass 1

// Sixteen bytes of x as eight bf16 or four f32 values, widened to floats.
__device__ __forceinline__ void to_floats(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ void to_floats(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

// One code of the row's DRQ, in the formula of kDivide.
template <bool kDivide>
__device__ __forceinline__ int8_t quantize(float v, float s, float inv) {
  return (int8_t)__float2int_rn(kDivide ? v / s : v * inv);
}

// The codes of 16 bytes of x, stored at vector v of the row's codes.
template <typename T, bool kDivide>
__device__ __forceinline__ void quantize_vec(const uint4& u, float s,
                                             float inv, int8_t* dst, int v) {
  constexpr int V = 16 / sizeof(T);
  float f[V];
  to_floats(u, f);
  uint32_t q[V / 4] = {};
#pragma unroll
  for (int i = 0; i < V; ++i)
    q[i / 4] |= (uint32_t)(uint8_t)quantize<kDivide>(f[i], s, inv)
                << (8 * (i % 4));
  if constexpr (V == 8)
    reinterpret_cast<uint2*>(dst)[v] = make_uint2(q[0], q[1]);
  else
    reinterpret_cast<uint32_t*>(dst)[v] = q[0];
}

template <typename T>
__device__ __forceinline__ float absmax_vec(float amax, const uint4& u) {
  float f[16 / sizeof(T)];
  to_floats(u, f);
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(T); ++i) amax = fmaxf(amax, fabsf(f[i]));
  return amax;
}

// Vectors of 16 bytes a thread keeps in registers between the two passes
// over its row (all of them up to K = 16384 bf16 or 8192 f32).
constexpr int kKeep = 8;

// Row m of x [M, K] -> xq[m, :] int8 and xs[m]: xs = max(absmax, 1e-9) *
// (1/127), xq = rint(x / xs) (kDivide, #6) or rint(x * (1 / xs)) (#15, #1).
// With vec (K a multiple of 16 bytes of x, x 16-byte aligned) a thread
// reads 16 bytes at a time and keeps up to kKeep of them for the second
// pass; the arithmetic is the same per element. kAfterPrior: launched as a
// programmatic dependent launch on the launch that writes x (#19's
// attention), it waits for that grid before it reads x.
template <typename T, bool kDivide, bool kAfterPrior = false>
__global__ void __launch_bounds__(kQuantThreads)
quantize_rows_kernel(const T* __restrict__ x, int K, int vec,
                     int8_t* __restrict__ xq, float* __restrict__ xs) {
  constexpr int V = 16 / sizeof(T);
  __shared__ float part[kQuantThreads / 32];
  // Launch 2 may start now: it waits for this grid before reading codes.
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  if constexpr (kAfterPrior) griddep_wait();
  const size_t m = blockIdx.x;
  const T* src = x + m * K;
  const uint4* src4 = reinterpret_cast<const uint4*>(src);
  const int nv = vec ? K / V : 0;
  uint4 keep[kKeep];
  float amax = 0.0f;
  if (vec) {
#pragma unroll
    for (int j = 0; j < kKeep; ++j) {
      const int v = threadIdx.x + j * kQuantThreads;
      if (v < nv) {
        keep[j] = __ldg(src4 + v);
        amax = absmax_vec<T>(amax, keep[j]);
      }
    }
    for (int v = threadIdx.x + kKeep * kQuantThreads; v < nv;
         v += kQuantThreads)
      amax = absmax_vec<T>(amax, __ldg(src4 + v));
  } else {
    for (int k = threadIdx.x; k < K; k += kQuantThreads)
      amax = fmaxf(amax, fabsf(load_f(src, k)));
  }
  amax = warp_max(amax);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) part[warp] = amax;
  __syncthreads();
  amax = part[0];
#pragma unroll
  for (int w = 1; w < kQuantThreads / 32; ++w) amax = fmaxf(amax, part[w]);
  const float s = fmaxf(amax, 1e-9f) * kInv127;
  const float inv = 1.0f / s;
  int8_t* dst = xq + m * K;
  if (vec) {
#pragma unroll
    for (int j = 0; j < kKeep; ++j) {
      const int v = threadIdx.x + j * kQuantThreads;
      if (v < nv) quantize_vec<T, kDivide>(keep[j], s, inv, dst, v);
    }
    for (int v = threadIdx.x + kKeep * kQuantThreads; v < nv;
         v += kQuantThreads)
      quantize_vec<T, kDivide>(__ldg(src4 + v), s, inv, dst, v);
  } else {
    for (int k = threadIdx.x; k < K; k += kQuantThreads)
      dst[k] = quantize<kDivide>(load_f(src, k), s, inv);
  }
  if (threadIdx.x == 0) xs[m] = s;
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns them.
__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d[64 x 128] (+)= A[64 x 32] . B[128 x 32]^T, s8 x s8 -> s32, both
// operands K-major in shared memory. Register d[4j + 2h + e] of thread t
// (warp w = t / 32 of the warpgroup, g = lane / 4, q = lane % 4) holds row
// 16w + g + 8h, column 8j + 2q + e.
__device__ __forceinline__ void wgmma_s8_m64n128k32(int (&d)[64],
                                                    uint64_t desc_a,
                                                    uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// The four k32 steps of one 128-byte stage: d += A[64 x 128] . B[128 x 128]^T.
__device__ __forceinline__ void wgmma_stage(int (&d)[64], const void* a,
                                            const void* b) {
  const uint64_t da = sw128_desc(a), db = sw128_desc(b);
#pragma unroll
  for (int kk = 0; kk < kBK / 32; ++kk)
    wgmma_s8_m64n128k32(d, da + 2 * kk, db + 2 * kk);  // + 32 bytes each
}

// Row stride of the epilogue's int32 tile: 136 makes the accumulator
// fragments' int2 writes conflict-free (each half-warp covers 32 banks).
// The tile of 128 rows, then its rows' scales, lie at the ring's start.
constexpr int kEpiStride = kBN + 8;
constexpr int kEpiBytes = 2 * kWgRows * kEpiStride * 4;

__device__ __forceinline__ void store4(float* p, const float (&y)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(y[0], y[1], y[2], y[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&y)[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(y[0], y[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(y[2], y[3]);
  uint2 v;
  v.x = *reinterpret_cast<uint32_t*>(&lo);
  v.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = v;
}

// ----------------------------------------------------------- loader policies

constexpr int kTileBytes = kBN * kBK;  // one [128, 128-byte] B tile

// #15: B is w [N, K] int8; a stage holds A [bm, 128] then B [128, 128].
struct Int8RowsB {
  static constexpr bool kDivide = false;
  static constexpr int kMinSteps = kMinSplitSteps;
  static constexpr size_t kUnpackBytes = 0;
  __host__ __device__ static int steps(int K) { return (K + kBK - 1) / kBK; }
  __host__ __device__ static size_t stage_bytes(int bm) {
    return (size_t)bm * kBK + kTileBytes;
  }
  __host__ static uint64_t b_cols(int K) { return (uint64_t)K; }

  __device__ static void load_a(const CUtensorMap* a_map, uint8_t* st,
                                int bm, uint64_t* bar, int step, int m0,
                                int K) {
    tma_load_2d(st, a_map, step * kBK, m0, bar);
  }
  __device__ static void load_b(const CUtensorMap* b_map, uint8_t* st,
                                int bm, uint64_t* bar, int step, int n0) {
    tma_load_2d(st + (size_t)bm * kBK, b_map, step * kBK, n0, bar);
  }

  __device__ static void mma(int (&d)[64], uint8_t* st, uint8_t* unpack,
                             int step, int wg, int bm, int consumers) {
    wgmma_fence();
    fence_acc(d);
    wgmma_stage(d, st + (size_t)wg * kWgRows * kBK, st + (size_t)bm * kBK);
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(d);
  }
};

// Four nibbles (one a byte, 0..15) sign-extended to int8 bytes, the
// value of nib_lo / nib_hi (drq_common.cuh): a byte with bit 3 set gains
// 0xF0 (b | 0xF0 is b - 16 mod 256), and (n & 0x08) * 0x1E is 0xF0 a
// byte with no carry between bytes. Four integer operations where
// nib_lo's __vsub4 form takes more (the two timed in turns:
// kernel_study.py variants, 'vsub4').
__device__ __forceinline__ uint32_t sign_extend_nibbles(uint32_t n) {
  return n | ((n & 0x08080808u) * 0x1Eu);
}

// The split-half unpack (#1, #6 and both contractions of #3): the packed
// [128, 128-byte] tile at `packed_tile` byte for byte into a lo and a hi
// s8 tile (lo, lo + kTileBytes), in place under the swizzle, by the
// block's `consumers` threads; then the fence that lets the async proxy
// (wgmma) read them. The caller's barrier makes both tiles whole.
__device__ __forceinline__ void unpack_split_tile(const uint8_t* packed_tile,
                                                  uint8_t* lo,
                                                  int consumers) {
  const uint4* packed = reinterpret_cast<const uint4*>(packed_tile);
  uint8_t* hi = lo + kTileBytes;
  for (int v = threadIdx.x; v < kTileBytes / 16; v += consumers) {
    const uint4 p = packed[v];
    const uint32_t w[4] = {p.x, p.y, p.z, p.w};
    uint32_t l[4], h[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      l[e] = sign_extend_nibbles(w[e] & 0x0F0F0F0Fu);
      h[e] = sign_extend_nibbles((w[e] >> 4) & 0x0F0F0F0Fu);
    }
    reinterpret_cast<uint4*>(lo)[v] = make_uint4(l[0], l[1], l[2], l[3]);
    reinterpret_cast<uint4*>(hi)[v] = make_uint4(h[0], h[1], h[2], h[3]);
  }
  fence_proxy_async();
}

// #6 and #1: B is w [N, K/2] split-half packed; a stage holds A lo [bm,
// 128] (codes at kb), A hi [bm, 128] (codes at K/2 + kb) and the packed
// [128, 128] tile; two unpack buffers of lo and hi s8 tiles alternate by
// step. kDiv picks the row-quantize formula of the kernel's plain version,
// kMinSteps the fewest K steps of a split.
template <bool kDiv, int kMin>
struct SplitNibbles {
  static constexpr bool kDivide = kDiv;
  static constexpr int kMinSteps = kMin;
  static constexpr size_t kUnpackBytes = 2 * 2 * kTileBytes;
  __host__ __device__ static int steps(int K) {
    return (K / 2 + kBK - 1) / kBK;
  }
  __host__ __device__ static size_t stage_bytes(int bm) {
    return 2 * (size_t)bm * kBK + kTileBytes;
  }
  __host__ static uint64_t b_cols(int K) { return (uint64_t)(K / 2); }

  __device__ static void load_a(const CUtensorMap* a_map, uint8_t* st,
                                int bm, uint64_t* bar, int step, int m0,
                                int K) {
    tma_load_2d(st, a_map, step * kBK, m0, bar);
    tma_load_2d(st + (size_t)bm * kBK, a_map, K / 2 + step * kBK, m0, bar);
  }
  __device__ static void load_b(const CUtensorMap* b_map, uint8_t* st,
                                int bm, uint64_t* bar, int step, int n0) {
    tma_load_2d(st + 2 * (size_t)bm * kBK, b_map, step * kBK, n0, bar);
  }

  __device__ static void mma(int (&d)[64], uint8_t* st, uint8_t* unpack,
                             int step, int wg, int bm, int consumers) {
    uint8_t* lo = unpack + (size_t)(step & 1) * 2 * kTileBytes;
    uint8_t* hi = lo + kTileBytes;
    unpack_split_tile(st + 2 * (size_t)bm * kBK, lo, consumers);
    bar_sync(1, consumers);  // both tiles whole before any warpgroup reads
    const uint8_t* a = st + (size_t)wg * kWgRows * kBK;
    wgmma_fence();
    fence_acc(d);
    wgmma_stage(d, a, lo);
    wgmma_stage(d, a + (size_t)bm * kBK, hi);
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(d);
  }
};

// #6: rint(x / xs); #1: rint(x * (1 / xs)).
using SplitNibblesB = SplitNibbles<true, kMinSplitSteps>;
using SplitNibblesRecipB = SplitNibbles<false, kMinSplitStepsInt4Drq>;

// ------------------------------------------------------------ pass 2

// kRes (#19's out projection, attention_oproj.cu): y = TOut(TOut(o) +
// res[m, n]), the residual res [M, N] added to the output rounded first.
template <class B, typename TOut, bool kRes = false>
__global__ void __launch_bounds__(2 * 128 + 32, 1)
int8_tc_gemm_kernel(__grid_constant__ const CUtensorMap a_map,
                    __grid_constant__ const CUtensorMap b_map,
                    const float* __restrict__ xs,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias,
                    const TOut* __restrict__ res, TOut* __restrict__ out,
                    int M, int N, int K, int wgs, int stages,
                    int steps_per_split, int steps) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[kMaxStages];
  __shared__ __align__(8) uint64_t empty_bar[kMaxStages];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* ring = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  const int bm = kWgRows * wgs;
  const size_t stage_bytes = B::stage_bytes(bm);
  uint8_t* unpack = ring + (size_t)stages * stage_bytes;
  const int consumers = 128 * wgs;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.x * bm, n0 = blockIdx.y * kBN;
  const int splits = gridDim.z;  // one cluster of `splits` blocks a tile
  const int first = blockIdx.z * steps_per_split;
  const int nk = min(steps, first + steps_per_split) - first;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full_bar[s], 1);
      mbar_init(&empty_bar[s], 4 * wgs);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * wgs) {  // the producer warp: one thread issues the loads
    if (lane == 0) {
      // The weights do not depend on launch 1: the first stages' weight
      // tiles are on their way before the codes are ready.
      const int early = min(nk, stages);
      for (int i = 0; i < early; ++i) {
        mbar_expect_tx(&full_bar[i], (uint32_t)stage_bytes);
        B::load_b(&b_map, ring + i * stage_bytes, bm, &full_bar[i],
                  first + i, n0);
      }
      griddep_wait();
      for (int i = 0; i < nk; ++i) {
        const int s = i % stages;
        uint8_t* st = ring + s * stage_bytes;
        if (i >= stages) {
          mbar_wait(&empty_bar[s], ((i / stages) - 1) & 1);
          mbar_expect_tx(&full_bar[s], (uint32_t)stage_bytes);
          B::load_b(&b_map, st, bm, &full_bar[s], first + i, n0);
        }
        B::load_a(&a_map, st, bm, &full_bar[s], first + i, m0, K);
      }
    }
    __syncwarp();
    if (splits > 1) {  // the consumers' two cluster barriers below
      cluster_sync();
      cluster_sync();
    }
    return;
  }

  // Scales and biases are weights: loaded before the codes are ready. Each
  // thread's epilogue columns are fixed (consumers % 32 == 0).
  const int c = n0 + 4 * lane;
  float sc[4], bi[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int cc = min(c + e, N - 1);  // clamped: loads need no guard
    sc[e] = scale[cc];
    bi[e] = bias != nullptr ? bias[cc] : 0.0f;
  }

  const int wg = warp >> 2;
  int d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0;
  for (int i = 0; i < nk; ++i) {
    const int s = i % stages;
    mbar_wait(&full_bar[s], (i / stages) & 1);
    __syncwarp();  // wgmma's .aligned instructions want the warp converged
    B::mma(d, ring + s * stage_bytes, unpack, i, wg, bm, consumers);
    if (lane == 0) mbar_arrive(&empty_bar[s]);
  }

  // The epilogue through shared memory (the ring is free: every stage was
  // consumed): the tile's sums as [bm][kEpiStride] int32 and its rows'
  // scales; then a warp takes a row at a time, a lane 4 adjacent columns,
  // so loads and stores are 16-byte or 8-byte vectors.
  int* tile_acc = reinterpret_cast<int*>(ring);
  float* row_scale = reinterpret_cast<float*>(ring + kEpiBytes);
  griddep_wait();  // xs comes from launch 1
  bar_sync(1, consumers);  // every warpgroup's wgmma has left the ring
  if (threadIdx.x < bm) row_scale[threadIdx.x] = xs[min(m0 + threadIdx.x, M - 1)];
  {
    const int row = wg * kWgRows + (warp & 3) * 16 + (lane >> 2);
    const int col = 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<int2*>(
            &tile_acc[(row + 8 * h) * kEpiStride + col + 8 * j]) =
            make_int2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
  }
  // Split-K: the tile's splits are one cluster; block z sums rows
  // [z * per, (z + 1) * per) of every split's staged tile through
  // distributed shared memory and stores them.
  int row_begin = 0, row_end = bm;
  if (splits > 1) {
    cluster_sync();  // every split's partial tile is staged
    const int per = (bm + splits - 1) / splits;
    row_begin = min(bm, (int)blockIdx.z * per);
    row_end = min(bm, row_begin + per);
  } else {
    bar_sync(1, consumers);
  }
  const bool vec = (N % 4 == 0) && c + 3 < N;
  for (int rr = row_begin + warp; rr < row_end; rr += consumers / 32) {
    const int* at_row = &tile_acc[rr * kEpiStride + 4 * lane];
    int4 a = *reinterpret_cast<const int4*>(at_row);
    for (int z = 0; z < splits; ++z) {
      if (z == (int)blockIdx.z) continue;
      const int4 v = *reinterpret_cast<const int4*>(cluster_map(at_row, z));
      a.x += v.x;
      a.y += v.y;
      a.z += v.z;
      a.w += v.w;
    }
    const int r = m0 + rr;
    if (r >= M || c >= N) continue;
    const int acc[4] = {a.x, a.y, a.z, a.w};
    const float xr = row_scale[rr];
    float y[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      y[e] = ((float)acc[e] * xr) * sc[e];
      if (bias != nullptr) y[e] = y[e] + bi[e];
    }
    const size_t at = (size_t)r * N + c;
    if constexpr (kRes) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c + e < N) y[e] = round_to(out, y[e]) + load_f(res, at + e);
    }
    if (vec) {
      store4(out + at, y);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c + e < N) store_f(out, at + e, y[e]);
    }
  }
  if (splits > 1) cluster_sync();  // no block leaves while others read it
}

// ------------------------------------------------------------------ host

// The launch a shape gets: consumer warpgroups, grid, ring depth, split-K
// (a cluster of `split` blocks a tile) and dynamic shared memory.
struct Plan {
  int wgs, m_tiles, n_tiles, split, steps_per_split, steps, stages;
  size_t smem;
};

inline int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return sms;
}

// Split K only while the tiles leave SMs idle (at most one block per SM),
// into at most kMaxSplit blocks (a portable cluster) of at least
// B::kMinSteps steps (kMinSplitSteps at two warpgroups), every split the
// same number of steps but the last.
// The ring takes the stages that fit; it always holds the epilogue's tile
// (kEpiBytes and the row scales).
template <class B>
inline Plan make_plan(int M, int N, int K) {
  Plan p;
  p.wgs = M <= kWgRows ? 1 : 2;
  const int bm = kWgRows * p.wgs;
  p.m_tiles = (M + bm - 1) / bm;
  p.n_tiles = (N + kBN - 1) / kBN;
  p.steps = B::steps(K);
  const int tiles = p.m_tiles * p.n_tiles;
  const int min_steps = p.wgs == 1 ? B::kMinSteps : kMinSplitSteps;
  const int want = std::max(
      1, std::min({p.steps / min_steps, sm_count() / tiles, kMaxSplit}));
  p.steps_per_split = (p.steps + want - 1) / want;
  p.split = (p.steps + p.steps_per_split - 1) / p.steps_per_split;
  const size_t stage = B::stage_bytes(bm);
  p.stages = (int)std::min((size_t)kMaxStages,
                           (kSmemBudget - 1024 - B::kUnpackBytes) / stage);
  p.smem = 1024 + p.stages * stage + B::kUnpackBytes;
  return p;
}

// A 2D map of a row-major uint8 matrix [rows, cols] (cols % 16 == 0, the
// base 16-byte aligned) with [box_rows, 128-byte] boxes, 128-byte swizzle
// and zero fill past the edges.
inline bool encode_2d(CUtensorMap* map, const void* base, uint64_t cols,
                      uint64_t rows, uint32_t box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launch 1 of a call under plan p; kAfterPrior: a programmatic dependent
// launch on the launch before it, which writes x.
template <class B, typename TIn, bool kAfterPrior = false>
int launch_quantize(const void* x, void* xq, void* xs, int M, int K,
                    cudaStream_t stream) {
  const int vec = K % (16 / (int)sizeof(TIn)) == 0 &&
                  reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if constexpr (kAfterPrior) {
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(M);
    config.blockDim = dim3(kQuantThreads);
    config.stream = stream;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr.val.programmaticStreamSerializationAllowed = 1;
    config.attrs = &attr;
    config.numAttrs = 1;
    return (int)cudaLaunchKernelEx(
        &config, quantize_rows_kernel<TIn, B::kDivide, true>,
        static_cast<const TIn*>(x), K, vec, static_cast<int8_t*>(xq),
        static_cast<float*>(xs));
  } else {
    quantize_rows_kernel<TIn, B::kDivide><<<M, kQuantThreads, 0, stream>>>(
        static_cast<const TIn*>(x), K, vec, static_cast<int8_t*>(xq),
        static_cast<float*>(xs));
    return (int)cudaGetLastError();
  }
}

// Launch 2 of a call under plan p: programmatic dependent launch on
// launch 1, and a cluster of the splits of each tile. res: kRes's
// residual [M, N] in TOut, else unused.
template <class B, typename TOut, bool kRes = false>
int launch_gemm(const void* w, const void* scale, const void* bias,
                void* out, const void* xq, const void* xs, int M, int N,
                int K, const Plan& p, cudaStream_t stream,
                const void* res = nullptr) {
  CUtensorMap a_map, b_map;
  if (!encode_2d(&a_map, xq, (uint64_t)K, (uint64_t)M,
                 (uint32_t)(kWgRows * p.wgs)) ||
      !encode_2d(&b_map, w, B::b_cols(K), (uint64_t)N, (uint32_t)kBN))
    return kTensorMapFailed;
  auto* kernel = int8_tc_gemm_kernel<B, TOut, kRes>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(p.m_tiles, p.n_tiles, p.split);
  config.blockDim = dim3(128 * p.wgs + 32);
  config.dynamicSmemBytes = p.smem;
  config.stream = stream;
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[0].val.programmaticStreamSerializationAllowed = 1;
  attrs[1].id = cudaLaunchAttributeClusterDimension;
  attrs[1].val.clusterDim.x = 1;
  attrs[1].val.clusterDim.y = 1;
  attrs[1].val.clusterDim.z = p.split;
  config.attrs = attrs;
  config.numAttrs = p.split > 1 ? 2 : 1;
  return (int)cudaLaunchKernelEx(
      &config, kernel, a_map, b_map, static_cast<const float*>(xs),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const TOut*>(res), static_cast<TOut*>(out), M, N, K, p.wgs,
      p.stages, p.steps_per_split, p.steps);
}

// The two launches of one call. Shapes are the caller's to check first.
template <class B, typename TIn, typename TOut>
int run(const void* x, const void* w, const void* scale, const void* bias,
        void* out, void* xq, void* xs, int M, int N, int K,
        cudaStream_t stream) {
  const Plan p = make_plan<B>(M, N, K);
  const int err = launch_quantize<B, TIn>(x, xq, xs, M, K, stream);
  if (err != 0) return err;
  return launch_gemm<B, TOut>(w, scale, bias, out, xq, xs, M, N, K, p,
                              stream);
}

// The plan as the Python wrapper reads it: grid x, y, z (split), threads,
// dynamic shared memory, ring stages.
template <class B>
void plan_fields(int M, int N, int K, long long* f) {
  const Plan p = make_plan<B>(M, N, K);
  f[0] = p.m_tiles;
  f[1] = p.n_tiles;
  f[2] = p.split;
  f[3] = 128 * p.wgs + 32;
  f[4] = (long long)p.smem;
  f[5] = p.stages;
}

}  // namespace tc
}  // namespace aeqt
