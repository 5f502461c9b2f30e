// Weight-only integer matmul: y[M, N] = sum_b (x_b . w_b^T) * s[N, b]
//   (+ bias), x [M, K] float, w [N, K] int8 container (int8, int4 or int2
//   values), s [N, K / bs] (blockwise) or [N] (channelwise, one block of
//   K), on Hopper's bf16 tensor cores.
//
// Replaces: ai_edge_quantizer_tpu/kernels/pallas_qmatmul.py qmatmul_pallas
//   (_channelwise_kernel, _blockwise_kernel). The executor reaches it for a
//   symmetric FC with blockwise scales (int4 blockwise-32 FFN and head FCs
//   of gemma_mixed48_b32: packed blockwise needs blocks of 128) and for a
//   non-DRQ channelwise one.
//
// Arithmetic (the Pallas kernel's function): each block's partial dot p_b =
//   x_b . w_b^T sums in f32, then y = y + p_b * s[n, b] in block order,
//   product and sum rounded on their own (--fmad=false), and the bias is
//   added after the last block. Channelwise is one block: y = p * s[n].
//   The operands are exact:
//   * every integer in [-128, 127] is a bf16 value, so the weight widens to
//     bf16 in registers with no rounding (widen_pair: 0x4300 | (b & 0x7F)
//     is the bf16 128 + (b & 0x7F), 0x4300 | (b & 0x80) the bf16 128 or
//     256, and their bf16 difference is the signed byte, exactly);
//   * bf16 x is one bf16 operand (its widening to f32, which the plain
//     version takes, is exact);
//   * f32 x is three bf16 parts (split_x_kernel: hi = x with its 16 low
//     bits cleared, mid the same of x - hi, lo = x - hi - mid, each step
//     exact), whose sum is x to all 24 bits for |x| >= 2^-110 (below that
//     only bits under 2^-133 are lost); x must be finite. The smallest part
//     goes into each block's accumulator first, window by window.
//   A bf16 value times an integer below 2^8 is exact in f32, so only the
//   order of the f32 sums differs from the plain version: within a block
//   the tensor cores' own accumulation over its k16 windows and parts; at
//   decode the splits of K (whole blocks each, channelwise any whole
//   steps) add their partial y (channelwise: their partial dots, scaled
//   after the sum) in split order. int_qmatmul.int_weights_tolerance
//   bounds both: bs unit roundoffs within a block, K / bs across blocks.
//
// Bound on the H100: at decode rows (M = 64) the int8 weights and their
//   scales, N*K + 4*N*K/bs bytes over 3.35 TB/s (24 us for gate/up, N 32768
//   and K 2048 at bs 32); at a prefill pass's rows (M = 1024) the
//   operations, 2*M*N*K at the bf16 tensor-core peak.
//
// Design: the structure of int4_bf16_tc_gemm.cuh (its wgmma, ring, barrier
//   and tensor-map helpers are shared; the kernel is this file's):
//   int_weights_tc_kernel computes the transposed tile y^T [64 * WGS weight
//   rows, NT tokens] a block: the weight rows are wgmma's M side (64 a
//   consumer warpgroup), the tokens its N side. One producer warp keeps a
//   ring of kMaxStages stages in flight with TMA; a stage holds kStepK (64)
//   columns of K: the weight tile [64 * WGS rows, 64 bytes] and the XP
//   x-part tiles [NT, 64 bf16] (128-byte swizzle). Each thread reads its
//   two rows' bytes of a k16 window and widens them into wgmma's A
//   fragments; wgmma m64nNTk16 f32.bf16.bf16 takes x from shared memory.
//   Scale policies:
//   * kBs32 (bs 32, gemma_mixed48_b32): a stage holds two blocks. At decode
//     rows the first block's wgmma go into one accumulator and the
//     second's into another, each group committed apart (wgmma's scale-d 0
//     starts each sum), and the first is flushed into y (y + p * s) while
//     the second's run. At 128 tokens y and one block sum fill the
//     registers: the two blocks in turn. (A software pipeline that flushed
//     each block while the next stage's wgmma ran made ptxas serialize
//     every wgmma, C7514, and ran slower; kBlocks' runtime block arithmetic
//     took 15 % more at prefill.)
//   * kBlocks (any other bs, a multiple of 32 dividing K): one accumulator,
//     a wait at every half stage (32 columns), flushed where a block ends.
//   * kChannel: one accumulator over the whole split; the epilogue scales.
//   Tokens a tile: 64 at decode rows (M <= 64, one consumer warpgroup, two
//   or three blocks an SM, make_plan); else 128 at two warpgroups (kNT2),
//   so that each weight tile's bytes and widening serve twice the tokens.
//   f32 x: split_x_kernel writes the three parts into bf16 scratch [3, M,
//   K] first; the matmul is its programmatic dependent launch, whose first
//   weight tiles load before it waits for the parts.
//   What bounds it (kernel_study.py times and variants on the H100):
//   at decode the stream of the x tiles, which every 64-row weight tile
//   reads again from L2 (twice its weight bytes), then the widening and
//   the flush, each some 10-20 % of the time; PERF.md §6.
//
// Split-K: where the tiles leave SMs idle (decode), K splits over
//   gridDim.z in whole units (a stage; for kBlocks whole blocks and whole
//   stages), and the splits of a tile are one thread-block cluster (at most
//   kMaxSplit blocks), their partial tiles added in distributed shared
//   memory in split order, as in int4_bf16_tc_gemm.cuh. No global scratch
//   but the f32 x parts.
//
// Shapes: N % 64 == 0 (N / 64 weight tiles within the grid's y limit), K %
//   64 == 0, and bs 0 (channelwise) or a multiple of 32 dividing K: every
//   shape the dispatcher (kernels/qmatmul.py) sends here at the quantizer's
//   granularities (32, 64, 128, 256); any other is kShapeRefused.
#include <type_traits>

#include "int4_bf16_tc_gemm.cuh"

namespace aeqt {
namespace wi {

using namespace tc;
using w4::kMaxSplit;
using w4::kWgRows;

constexpr int kStepK = 64;          // K columns (weight bytes) a stage
static_assert(kStepK == w4::kStepBytes, "w4::a_frags_int8 reads its rows");
constexpr int kMaxStages = 4;       // ring stages at most
constexpr int kMinSplitSteps = 4;   // stages a split takes at least
constexpr int kNT1 = 64;            // tokens a tile at decode rows (M <= 64)
constexpr int kNT2 = 128;           // tokens a tile at two warpgroups
constexpr int kSplitThreads = 256;  // split_x_kernel's block
constexpr int kXPartsF32 = 3;       // bf16 parts of an f32 x
// An SM's shared memory, and what each block takes beside its dynamic
// shared memory (1 KB reserved, the static barriers).
constexpr size_t kSmemSm = 233472, kSmemBlock = 1024 + 128;

enum Policy : int { kChannel = 0, kBs32 = 1, kBlocks = 2 };

// x [M, K] f32 -> xp [3, M, K] bf16: hi, mid, lo with x = hi + mid + lo.
// Four values a thread. Lets its dependent launch start at once.
__global__ void __launch_bounds__(kSplitThreads)
split_x_kernel(const float4* __restrict__ x, uint2* __restrict__ xp,
               size_t n4) {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const size_t i = (size_t)blockIdx.x * kSplitThreads + threadIdx.x;
  if (i >= n4) return;
  const float4 v = __ldg(x + i);
  const float e[4] = {v.x, v.y, v.z, v.w};
  uint32_t part[3][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float r = e[j];
#pragma unroll
    for (int p = 0; p < 3; ++p) {  // the high 16 bits: exact parts
      const uint32_t bits = __float_as_uint(r) & 0xFFFF0000u;
      part[p][j] = bits >> 16;
      r = r - __uint_as_float(bits);
    }
  }
#pragma unroll
  for (int p = 0; p < 3; ++p)
    xp[(size_t)p * n4 + i] = make_uint2(part[p][0] | part[p][1] << 16,
                                        part[p][2] | part[p][3] << 16);
}

__device__ __forceinline__ void wgmma_wait_1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}

// y += p * s: the product and the sum rounded on their own. A thread's
// register r holds weight row row + 8 ((r >> 1) & 1).
template <int N>
__device__ __forceinline__ void flush(float (&y)[N], const float (&p)[N],
                                      const float (&s)[2]) {
#pragma unroll
  for (int r = 0; r < N; ++r) {
    const float scaled = p[r] * s[(r >> 1) & 1];
    y[r] = y[r] + scaled;
  }
}

template <int XP, int NT, int WGS>
struct Geometry {
  static constexpr int kRows = kWgRows * WGS;
  static constexpr int kConsumers = 128 * WGS;
  static constexpr size_t kX = (size_t)NT * 128;  // one part's x tile
  static constexpr size_t kStage = XP * kX + (size_t)kRows * kStepK;
  static constexpr int kEpiStride = kRows + 4;    // f32 staged rows
  static constexpr size_t kEpi = (size_t)NT * kEpiStride * 4;
  static constexpr size_t kBudget =
      WGS == 1 ? w4::kSmemHalf : w4::kSmemBudget;
};

template <int XP, int P, int NT, int WGS, typename TOut>
__global__ void __launch_bounds__(WGS * 128 + 32, WGS == 1 ? 3 : 1)
int_weights_tc_kernel(const __grid_constant__ CUtensorMap x_map,
                      const __grid_constant__ CUtensorMap w_map,
                      const float* __restrict__ scale,
                      const float* __restrict__ bias,
                      TOut* __restrict__ out, int M, int N, int K, int nb,
                      int half_blocks, int stages, int steps_per_split,
                      int steps) {
  using G = Geometry<XP, NT, WGS>;
  constexpr int kConsumers = G::kConsumers;
  constexpr int kAcc = NT / 2;
  constexpr bool kBlock = P != kChannel;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[kMaxStages];
  __shared__ __align__(8) uint64_t empty_bar[kMaxStages];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* ring = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  const int lane = threadIdx.x & 31;
  const int m0 = blockIdx.x * NT, n0 = blockIdx.y * G::kRows;
  const int splits = gridDim.z;
  const int first = blockIdx.z * steps_per_split;
  const int nk = min(steps, first + steps_per_split) - first;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full_bar[s], 1);
      mbar_init(&empty_bar[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // the producer warp: one thread loads
    if (lane == 0) {
      // The weights do not depend on the x parts' launch: the first
      // stages' weight tiles are on their way before the parts are ready.
      const int early = min(nk, stages);
      for (int i = 0; i < early; ++i) {
        uint8_t* st = ring + (size_t)i * G::kStage;
        mbar_expect_tx(&full_bar[i], (uint32_t)G::kStage);
        tma_load_2d(st + XP * G::kX, &w_map, (first + i) * kStepK, n0,
                    &full_bar[i]);
      }
      if (XP > 1) griddep_wait();
      for (int i = 0; i < nk; ++i) {
        const int s = i % stages;
        uint8_t* st = ring + (size_t)s * G::kStage;
        const int k0 = (first + i) * kStepK;
        if (i >= stages) {
          mbar_wait(&empty_bar[s], ((i / stages) - 1) & 1);
          mbar_expect_tx(&full_bar[s], (uint32_t)G::kStage);
          tma_load_2d(st + XP * G::kX, &w_map, k0, n0, &full_bar[s]);
        }
#pragma unroll
        for (int p = 0; p < XP; ++p)
          tma_load_2d(st + p * G::kX, &x_map, k0, p * M + m0, &full_bar[s]);
      }
    }
    __syncwarp();
    if (splits > 1) {  // the consumers' two cluster barriers below
      cluster_sync();
      cluster_sync();
    }
    return;
  }

  const int wg = warp >> 2, g = lane >> 2, q = lane & 3;
  const int row = wg * kWgRows + (warp & 3) * 16 + g;  // and row + 8
  // kBs32 at decode rows keeps each stage's second block sum apart (pb).
  constexpr bool kTwoSums = P == kBs32 && NT == kNT1;
  float acc[kAcc], pb[kTwoSums ? kAcc : 1], y[kBlock ? kAcc : 1];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < (kBlock ? kAcc : 1); ++i) y[i] = 0.0f;
  // The scale rows of the thread's two weight rows (clamped: no guard).
  const float* srow[2];
#pragma unroll
  for (int u = 0; u < 2; ++u)
    srow[u] = scale + (size_t)min(n0 + row + 8 * u, N - 1) * nb;
  constexpr int kGroups = G::kRows / 4;  // 4 weight rows an item
  const int c4 = (threadIdx.x % kGroups) * 4, c = n0 + c4;
  float sc[4], bi[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int cc = min(c + e, N - 1);
    sc[e] = kBlock ? 1.0f : __ldg(scale + cc);
    bi[e] = bias != nullptr ? __ldg(bias + cc) : 0.0f;
  }

  for (int i = 0; i < nk; ++i) {
    const int s = i % stages;
    const int step = first + i;
    const uint8_t* st = ring + (size_t)s * G::kStage;
    // The scales this stage's flushes read, loaded before the wait.
    float s0[2] = {}, s1[2] = {};
    if constexpr (P == kBs32) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {  // blocks 2 step and 2 step + 1
        const float2 v =
            __ldg(reinterpret_cast<const float2*>(srow[u]) + step);
        s0[u] = v.x;
        s1[u] = v.y;
      }
    } else if constexpr (P == kBlocks) {  // the block of each half stage
      const int jb0 = 2 * step / half_blocks;
      const int jb1 = (2 * step + 1) / half_blocks;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        s0[u] = __ldg(srow[u] + jb0);
        s1[u] = __ldg(srow[u] + jb1);
      }
    }
    w4::wait_parity(&full_bar[s], (i / stages) & 1);
    uint32_t a[4][4];
#pragma unroll
    for (int cw = 0; cw < 4; ++cw)
      w4::a_frags_int8(st + XP * G::kX, row, cw, q, a[cw]);
    uint64_t dx[XP];
#pragma unroll
    for (int p = 0; p < XP; ++p) dx[p] = sw128_desc(st + p * G::kX);
    if constexpr (P == kChannel) {
      wgmma_fence();
      w4::fence_acc(acc);
#pragma unroll
      for (int cw = 0; cw < 4; ++cw)
#pragma unroll
        for (int p = XP - 1; p >= 0; --p)  // the smallest part first
          w4::wgmma_rs<NT>(acc, a[cw], dx[p] + 2 * cw);
      wgmma_commit();
      wgmma_wait_all();
      w4::fence_acc(acc);
      mbar_arrive(&empty_bar[s]);
    } else if constexpr (kTwoSums) {
      // Block 2 step in acc, block 2 step + 1 in pb, each from zero and
      // committed apart: acc is flushed while pb's wgmma run.
      wgmma_fence();
      w4::fence_acc(acc);
      w4::fence_acc(pb);
#pragma unroll
      for (int cw = 0; cw < 2; ++cw)
#pragma unroll
        for (int p = XP - 1; p >= 0; --p)  // the smallest part first
          w4::wgmma_rs<NT>(acc, a[cw], dx[p] + 2 * cw,
                           cw > 0 || p < XP - 1);
      wgmma_commit();
#pragma unroll
      for (int cw = 2; cw < 4; ++cw)
#pragma unroll
        for (int p = XP - 1; p >= 0; --p)
          w4::wgmma_rs<NT>(pb, a[cw], dx[p] + 2 * cw,
                           cw > 2 || p < XP - 1);
      wgmma_commit();
      wgmma_wait_1();
      w4::fence_acc(acc);
      flush(y, acc, s0);
      wgmma_wait_all();
      w4::fence_acc(pb);
      mbar_arrive(&empty_bar[s]);
      flush(y, pb, s1);
    } else if constexpr (P == kBs32) {
      // 128 tokens: the two blocks of a stage in turn, in acc.
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        wgmma_fence();
        w4::fence_acc(acc);
#pragma unroll
        for (int cw = 2 * h; cw < 2 * h + 2; ++cw)
#pragma unroll
          for (int p = XP - 1; p >= 0; --p)
            w4::wgmma_rs<NT>(acc, a[cw], dx[p] + 2 * cw,
                             cw > 2 * h || p < XP - 1);
        wgmma_commit();
        wgmma_wait_all();
        w4::fence_acc(acc);
        if (h == 1) mbar_arrive(&empty_bar[s]);
        if (h) flush(y, acc, s1);
        else flush(y, acc, s0);
      }
    } else {
      // Half stages: a block starts and ends on them.
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int hx = 2 * step + h;
        const int fresh = hx % half_blocks != 0;  // 0: the block's first
        wgmma_fence();
        w4::fence_acc(acc);
#pragma unroll
        for (int cw = 2 * h; cw < 2 * h + 2; ++cw)
#pragma unroll
          for (int p = XP - 1; p >= 0; --p)
            w4::wgmma_rs<NT>(acc, a[cw], dx[p] + 2 * cw,
                             fresh | (cw > 2 * h) | (p < XP - 1));
        wgmma_commit();
        wgmma_wait_all();
        w4::fence_acc(acc);
        if (h == 1) mbar_arrive(&empty_bar[s]);
        if ((hx + 1) % half_blocks == 0) {
          if (h) flush(y, acc, s1);
          else flush(y, acc, s0);
        }
      }
    }
  }

  // The epilogue through shared memory (every stage was consumed): the
  // staged f32 tile [NT tokens][kEpiStride].
  float* tile = reinterpret_cast<float*>(ring);
  constexpr int S = G::kEpiStride;
  bar_sync(1, kConsumers);
#pragma unroll
  for (int r = 0; r < kAcc; ++r) {
    const int tok = 8 * (r >> 2) + 2 * q + (r & 1);
    float* at = tile + tok * S + row + 8 * ((r >> 1) & 1);
    if constexpr (kBlock) *at = y[r];
    else *at = acc[r];
  }
  // Split-K: block z takes tokens [z * per, (z + 1) * per) of the tile and
  // sums them over every split's staged tile, in split order.
  int tok_begin = 0, tok_end = NT;
  if (splits > 1) {
    cluster_sync();
    const int per = (NT + splits - 1) / splits;
    tok_begin = min(NT, (int)blockIdx.z * per);
    tok_end = min(NT, tok_begin + per);
  } else {
    bar_sync(1, kConsumers);
  }
  for (int it = threadIdx.x; it < (tok_end - tok_begin) * kGroups;
       it += kConsumers) {
    const int tt = tok_begin + it / kGroups;
    const float* at = tile + tt * S + c4;
    float4 t;
    if (splits == 1) {
      t = *reinterpret_cast<const float4*>(at);
    } else {
      float4 part[kMaxSplit];
#pragma unroll
      for (int z = 0; z < kMaxSplit; ++z)
        if (z < splits)
          part[z] = *reinterpret_cast<const float4*>(cluster_map(at, z));
      t = part[0];
#pragma unroll
      for (int z = 1; z < kMaxSplit; ++z)
        if (z < splits) t = w4::add4(t, part[z]);
    }
    const int m = m0 + tt;
    if (m >= M || c >= N) continue;  // N % 4 == 0: c < N covers c + 3
    const float tv[4] = {t.x, t.y, t.z, t.w};
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] = kBlock ? tv[e] : tv[e] * sc[e];
      if (bias != nullptr) v[e] = v[e] + bi[e];
    }
    TOut* dst = out + (size_t)m * N + c;
    if constexpr (sizeof(TOut) == 4) {
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      const __nv_bfloat162 v01 = __floats2bfloat162_rn(v[0], v[1]);
      const __nv_bfloat162 v23 = __floats2bfloat162_rn(v[2], v[3]);
      uint2 pk;
      pk.x = *reinterpret_cast<const uint32_t*>(&v01);
      pk.y = *reinterpret_cast<const uint32_t*>(&v23);
      *reinterpret_cast<uint2*>(dst) = pk;
    }
  }
  if (splits > 1) cluster_sync();  // no block leaves while others read it
}

// ------------------------------------------------------------------ host

inline bool takes(int M, int N, int K, int bs) {
  return M > 0 && N > 0 && K > 0 && N % 64 == 0 && N / 64 <= 65535 &&
         K % kStepK == 0 &&
         (bs == 0 || (bs > 0 && bs % 32 == 0 && K % bs == 0));
}

inline int policy_of(int bs) {
  return bs == 0 ? kChannel : (bs == 32 ? kBs32 : kBlocks);
}

struct Plan {
  int policy, parts, wgs, nt, m_tiles, n_tiles, split, steps_per_split,
      steps, stages, half_blocks, per_sm;
  size_t smem;
};

template <int XP, int NT, int WGS>
inline void fit_ring(Plan& p) {
  using G = Geometry<XP, NT, WGS>;
  const size_t fit = (G::kBudget - 1024) / G::kStage;
  p.stages = (int)std::min(
      {(size_t)kMaxStages, (size_t)p.steps_per_split, fit});
  p.smem = 1024 + std::max((size_t)p.stages * G::kStage, G::kEpi);
}

template <int XP>
inline void size_ring(Plan& p) {
  if (p.wgs == 2) fit_ring<XP, kNT2, 2>(p);
  else fit_ring<XP, kNT1, 1>(p);
}

// One consumer warpgroup (64 weight rows a block, kNT1 tokens) for M <= 64,
// else two (kNT2 tokens). K splits only while the tiles leave block slots
// idle (three an SM at one warpgroup), into at most kMaxSplit blocks of at
// least kMinSplitSteps stages, in whole units: a stage (kBlocks: the
// fewest stages that hold whole blocks), every split the same number of
// units but the last. At one warpgroup (128 registers a thread, the
// __launch_bounds__ of three blocks an SM) a grid takes three blocks an SM
// where that needs fewer waves than two or its splits form clusters (a
// cluster's blocks must find free slots in one GPC at once: at two an SM
// the decode down projection's clusters of 8 did not all fit,
// kernel_study.py times); else two, its shared memory padded past a third
// of the SM's (three a slower wave of the same count: gate/up's 512).
inline Plan make_plan(int M, int N, int K, int bs, int parts) {
  Plan p;
  p.parts = parts;
  p.wgs = M <= kNT1 ? 1 : 2;
  p.nt = p.wgs == 1 ? kNT1 : kNT2;
  p.policy = policy_of(bs);
  p.m_tiles = (M + p.nt - 1) / p.nt;
  p.n_tiles = (N + kWgRows * p.wgs - 1) / (kWgRows * p.wgs);
  p.steps = K / kStepK;
  p.half_blocks = bs > 0 ? bs / 32 : 1;  // half stages a block
  const int unit = p.policy == kBlocks
                       ? (p.half_blocks % 2 == 0 ? p.half_blocks / 2
                                                 : p.half_blocks)
                       : 1;
  const int units = p.steps / unit;
  const int min_units = std::max(1, kMinSplitSteps / unit);
  const int tiles = p.m_tiles * p.n_tiles;
  const int sms = w4::sm_count();
  const int slots = sms * (p.wgs == 1 ? 3 : 1);  // blocks at once
  const int want =
      std::max(1, std::min({units / min_units, slots / tiles, kMaxSplit}));
  const int per = (units + want - 1) / want;
  p.split = (units + per - 1) / per;
  p.steps_per_split = per * unit;
  if (parts > 1) size_ring<kXPartsF32>(p);
  else size_ring<1>(p);
  p.per_sm = 1;
  if (p.wgs == 1) {
    const int blocks = tiles * p.split;
    const auto waves = [&](int per_sm) {
      return (blocks + per_sm * sms - 1) / std::max(1, per_sm * sms);
    };
    const bool three_fit = 3 * (p.smem + kSmemBlock) <= kSmemSm;  // not f32 x
    p.per_sm = three_fit && (p.split > 1 || waves(3) < waves(2)) ? 3 : 2;
    if (p.per_sm == 2) p.smem = std::max(p.smem, kSmemSm / 3);
  }
  return p;
}

template <int XP, int P, int NT, int WGS>
int launch(const void* xp, const void* w, const void* scale,
           const void* bias, void* out, int M, int N, int K, int nb,
           const Plan& p, cudaStream_t stream) {
  using G = Geometry<XP, NT, WGS>;
  using TOut = typename std::conditional<XP == 1, __nv_bfloat16, float>::type;
  CUtensorMap x_map, w_map;
  if (!w4::encode_2d(&x_map, xp, 2, (uint64_t)K, (uint64_t)XP * M, 64,
                     (uint32_t)NT, true) ||
      !w4::encode_2d(&w_map, w, 1, (uint64_t)K, (uint64_t)N, kStepK,
                     (uint32_t)G::kRows, false))
    return kTensorMapFailed;
  auto* kernel = int_weights_tc_kernel<XP, P, NT, WGS, TOut>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(p.m_tiles, p.n_tiles, p.split);
  config.blockDim = dim3(128 * WGS + 32);
  config.dynamicSmemBytes = p.smem;
  config.stream = stream;
  cudaLaunchAttribute attrs[2];
  int n = 0;
  if (XP > 1) {  // the dependent launch of split_x_kernel
    attrs[n].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attrs[n++].val.programmaticStreamSerializationAllowed = 1;
  }
  if (p.split > 1) {
    attrs[n].id = cudaLaunchAttributeClusterDimension;
    attrs[n].val.clusterDim.x = 1;
    attrs[n].val.clusterDim.y = 1;
    attrs[n++].val.clusterDim.z = p.split;
  }
  config.attrs = attrs;
  config.numAttrs = n;
  return (int)cudaLaunchKernelEx(
      &config, kernel, x_map, w_map, static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<TOut*>(out), M, N, K, nb,
      p.half_blocks, p.stages, p.steps_per_split, p.steps);
}

template <int XP, int P>
int launch(const void* xp, const void* w, const void* scale,
           const void* bias, void* out, int M, int N, int K, int nb,
           const Plan& p, cudaStream_t stream) {
  if (p.wgs == 2)
    return launch<XP, P, kNT2, 2>(xp, w, scale, bias, out, M, N, K, nb, p,
                                  stream);
  return launch<XP, P, kNT1, 1>(xp, w, scale, bias, out, M, N, K, nb, p,
                                stream);
}

template <int XP>
int run(const void* xp, const void* w, const void* scale, const void* bias,
        void* out, int M, int N, int K, int bs, cudaStream_t stream) {
  const Plan p = make_plan(M, N, K, bs, XP);
  const int nb = bs > 0 ? K / bs : 1;
  switch (p.policy) {
    case kChannel:
      return launch<XP, kChannel>(xp, w, scale, bias, out, M, N, K, nb, p,
                                  stream);
    case kBs32:
      return launch<XP, kBs32>(xp, w, scale, bias, out, M, N, K, nb, p,
                               stream);
    default:
      return launch<XP, kBlocks>(xp, w, scale, bias, out, M, N, K, nb, p,
                                 stream);
  }
}

}  // namespace wi
}  // namespace aeqt

// x [M, K]: bf16 (x_bf16, 16-byte aligned; out bf16) or f32 (16-byte
// aligned; xp bf16 scratch [3, M, K] for its parts; out f32); w [N, K]
// int8, 16-byte aligned; scale [N, K / bs] f32 (bs = 0: [N]); bias [N] f32
// or null; out [M, N]. Refuses the shapes `takes` refuses with
// kShapeRefused before any launch.
extern "C" int aeqt_qmatmul_int_weights(const void* x, int x_bf16, void* xp,
                                        const void* w, const void* scale,
                                        const void* bias, void* out, int M,
                                        int N, int K, int bs, void* stream) {
  using namespace aeqt::wi;
  if (!takes(M, N, K, bs)) return aeqt::kShapeRefused;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) return run<1>(x, w, scale, bias, out, M, N, K, bs, s);
  const size_t n4 = (size_t)M * K / 4;
  split_x_kernel<<<(unsigned)((n4 + kSplitThreads - 1) / kSplitThreads),
                   kSplitThreads, 0, s>>>(static_cast<const float4*>(x),
                                          static_cast<uint2*>(xp), n4);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return run<kXPartsF32>(xp, w, scale, bias, out, M, N, K, bs, s);
}

// The launch of a shape (int_qmatmul.INT_WEIGHTS_PLAN_FIELDS): grid x
// (token tiles), y (weight tiles), z (split), threads, dynamic shared
// memory, ring stages, tokens a tile, bf16 parts of x, the scale policy
// (0 kChannel, 1 kBs32, 2 kBlocks), blocks an SM, or kShapeRefused.
extern "C" int aeqt_qmatmul_int_weights_plan(int M, int N, int K, int bs,
                                             int x_bf16, long long* f) {
  using namespace aeqt::wi;
  if (!takes(M, N, K, bs)) return aeqt::kShapeRefused;
  const Plan p = make_plan(M, N, K, bs, x_bf16 ? 1 : kXPartsF32);
  f[0] = p.m_tiles;
  f[1] = p.n_tiles;
  f[2] = p.split;
  f[3] = 128 * p.wgs + 32;
  f[4] = (long long)p.smem;
  f[5] = p.stages;
  f[6] = p.nt;
  f[7] = p.parts;
  f[8] = p.policy;
  f[9] = p.per_sm;
  return 0;
}
