// Greedy head: ids[m] = argmax_n (int8(x[m]) . w[n] * xs[m] * s[n]),
// without writing the [M, N] logits.
//
// Replaces: ai_edge_quantizer_tpu/kernels/pallas_head.py head_argmax_pallas
//   (_head_argmax_kernel), DRQ branches: int8 weights [N, K] (the tied
//   Gemma embedding head) and split-half packed int4 weights [N, K/2].
//
// Bound on the H100: the weight stream. Gemma-2B's head is 256128 x 2048
//   int8 = 525 MB, about 157 us at 3.35 TB/s; the int8 work at M = 64 is
//   67 GOP, 34 us at the 1,979 TOP/s peak.
//
// Design: three launches on the int8 tensor-core core (int8_tc_gemm.cuh),
//   deterministic:
//   1. the core's quantize_rows_kernel, once: xq [M, K] int8 and xs [M]
//      (the reciprocal formula of pallas_head.py:50-55, the port's
//      quantize_rows_drq);
//   2. head_tc_kernel, a programmatic dependent launch (its first weight
//      tiles load while launch 1 runs): the core's wgmma m64n128k32 s8
//      tiles fed by a TMA ring, B through the core's loader policies
//      (Int8RowsB for int8 rows [N, K], SplitNibblesRecipB for split-half
//      packed rows [N, K/2], unpacked in shared memory, the next step's
//      tile while this step's wgmma run), with an argmax
//      epilogue in place of the tile store: each logit (f32(acc) * xs) *
//      s, rounded to the activation dtype and back (the Pallas kernel's
//      cast_dt, so bf16 runs agree with the unfused path), -3.4e38 for
//      columns >= true_n; each row's 128 columns of the tile reduce in
//      registers and by shuffles over the row's four lanes to one (max,
//      first index) pair. The grid is persistent, one block an SM: block i
//      takes the column tiles i, i + grid, ..., and its ring runs on across
//      tiles (the loads of the next tile overlap the epilogue of this one).
//      Above 128 rows each consumer warpgroup keeps two 64-row
//      accumulators, so that a stage's weight tile serves 256 rows; the
//      row tiles of larger M come in turn on the same column tile (from
//      L2). The weights stream from HBM once (525 MB at Gemma-2B, int8);
//   3. one block per row reduces the per-tile pairs: the larger value
//      wins, and among equal values the smaller index, so ties go to the
//      first index across tiles as jnp.argmax does (and inside a tile, by
//      the same rule).
//   Any K % 32 == 0 is taken (TMA's 16-byte row pitch, packed too); rows
//   past M and columns past N load as zeros and are never written.
//
// The weight-only (bf16) branches, drq=False (the JAX executor's default,
//   AEQT_INT4_DRQ=0, for the packed int4 head; int8 weights by direct call):
//   x is rounded to bf16 whatever its dtype (by the caller), the weights
//   are taken as bf16 values (int4 and int8 values are exact there), and
//   the products sum in f32 (pallas_head.py:77-91: a packed row's
//   low-nibble and high-nibble halves each in f32, then added). Each logit
//   is acc * s, rounded to the activation dtype, and compared as above.
//   Bound: the weight stream (the packed head, 256128 x 1024 bytes = 262 MB,
//   about 78 us; int8 525 MB, 157 us) or, at M = 256, the bf16 work
//   (2*M*N*K = 269 GFLOP, 272 us at the bf16 tensor-core peak).
//   Design: head_wo_kernel, a persistent grid (one block an SM, block i
//   taking the vocab tiles i, i + grid, ...) on the bf16 core's pieces
//   (int4_bf16_tc_gemm.cuh): a producer warp keeps a TMA ring that runs on
//   across tiles; a stage holds two 64-byte K steps of a weight tile, one
//   [rows, 128 bytes] box (256 K columns packed, 128 int8), and the x
//   tiles they meet, [tokens, 64 bf16] a step (packed at kb and K/2 + kb),
//   128-byte swizzle; a stage past K loads zeros. The weight rows are
//   wgmma's M side, widened from the stage's bytes in registers
//   (w4::a_frags for nibbles, w4::a_frags_int8 for int8 bytes, both
//   exact), the tokens its N side (m64n64k16 f32.bf16.bf16, x from shared
//   memory): one commit group a stage (int8) or a step (packed, whose two
//   steps' A fragments do not fit the registers together). Every token
//   tile of a pass takes its wgmma from the same stage. At M <= 64 four
//   consumer warpgroups of one 64-row tile each make a 256-row vocab tile
//   (each x tile read from L2 serves 256 rows), one pass: the weights
//   stream from HBM once. Above 64 rows two warpgroups (128 rows a tile)
//   and passes of 128 tokens (two token tiles); a tile's later passes
//   read its 128 KB of packed weights again from L2 (four token tiles in
//   one pass spill their 128 accumulator registers and ptxas serializes
//   the wgmma, C7512: slower, 'head_r4'). The lo and hi windows sum into
//   one f32 accumulator (the registers do not hold two at two token
//   tiles): the f32 sums differ from the plain version's in order only,
//   and its ids are judged by the top-2 margin. The argmax epilogue in
//   place of the tile store: each logit acc * s, rounded to the
//   activation dtype, -3.4e38 past true_n; each token's column of the
//   transposed tile reduces over the thread's rows and the 8 lanes of
//   the row's quad by the rule of `better`, then over the block's warps
//   as 64-bit (value, first index) keys in shared memory that order as
//   `better` does (-0 taken as +0), the largest in warp order; one pair a
//   (token, vocab tile) goes to pmax / pidx. Then the DRQ branch's
//   reduction launch.
//   What bounds it (kernel_study.py variants on the H100, packed, M 64):
//   the ring's stream alone of weight and x tiles takes about 0.11 ms of
//   the 0.19, and the consumers' wgmma and widening add to it rather than
//   overlap it; halving x's bytes from L2 changed nothing (PERF.md §6-7).
#include <limits.h>

#include "int4_bf16_tc_gemm.cuh"
#include "int8_tc_gemm.cuh"

namespace {

namespace tc = aeqt::tc;
namespace w4 = aeqt::w4;

constexpr int kDrqBN = tc::kBN;     // vocab columns of a DRQ tile (n128)
constexpr float kNegInf = -3.4e38f;  // pallas_head._NEG_INF

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// The DRQ branch's launch 2 (see the header): a persistent grid over the
// column tiles, wgs consumer warpgroups of R row tiles of 64 each (R
// accumulators, all sharing the stage's B tile) and a producer warp. Local
// step j of a block is step j % steps of row tile (j / steps) % m_tiles of
// its column tile j / (m_tiles * steps).
template <class Ld, int R>
__global__ void __launch_bounds__(2 * 128 + 32, 1)
head_tc_kernel(__grid_constant__ const CUtensorMap a_map,
               __grid_constant__ const CUtensorMap b_map,
               const float* __restrict__ xs, const float* __restrict__ scale,
               float* __restrict__ pmax, int* __restrict__ pidx, int M,
               int N, int true_n, int cast_bf16, int K, int wgs, int stages,
               int steps, int m_tiles, int n_tiles) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[tc::kMaxStages];
  __shared__ __align__(8) uint64_t empty_bar[tc::kMaxStages];
  const uint32_t raw = tc::smem_u32(smem_raw);
  uint8_t* ring = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  const int bm = tc::kWgRows * R * wgs;
  const size_t stage_bytes = Ld::stage_bytes(bm);
  uint8_t* unpack = ring + (size_t)stages * stage_bytes;
  const int consumers = 128 * wgs;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles = (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                    (int)gridDim.x * m_tiles;  // (column, row) tiles here
  auto col0 = [&](int t) {  // the first vocab column of local tile t
    return ((int)blockIdx.x + (t / m_tiles) * (int)gridDim.x) * kDrqBN;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      tc::mbar_init(&full_bar[s], 1);
      tc::mbar_init(&empty_bar[s], 4 * wgs);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * wgs) {  // the producer warp: one thread issues the loads
    if (lane == 0) {
      const int total = tiles * steps;
      // The weights do not depend on launch 1: the first stages' weight
      // tiles are on their way before the codes are ready.
      const int early = min(total, stages);
      for (int j = 0; j < early; ++j) {
        tc::mbar_expect_tx(&full_bar[j], (uint32_t)stage_bytes);
        Ld::load_b(&b_map, ring + j * stage_bytes, bm, &full_bar[j],
                   j % steps, col0(j / steps));
      }
      tc::griddep_wait();
      for (int j = 0; j < total; ++j) {
        const int s = j % stages, t = j / steps;
        uint8_t* st = ring + s * stage_bytes;
        if (j >= stages) {
          tc::mbar_wait(&empty_bar[s], ((j / stages) - 1) & 1);
          tc::mbar_expect_tx(&full_bar[s], (uint32_t)stage_bytes);
          Ld::load_b(&b_map, st, bm, &full_bar[s], j % steps, col0(t));
        }
        Ld::load_a(&a_map, st, bm, &full_bar[s], j % steps,
                   (t % m_tiles) * bm, K);
      }
    }
    return;
  }

  tc::griddep_wait();  // xs comes from launch 1
  const int wg = warp >> 2, g = lane >> 2, qd = lane & 3;
  // Packed weights: step j's tile unpacks into buffer j & 1 while step j -
  // 1's wgmma run (mlp_int4_drq.cuh's overlap), a barrier after each step
  // (its tiles whole before any wgmma reads them, and every warp's wgmma of
  // a buffer done before the buffer is unpacked into again). The stage's
  // int8 B tile, or the unpacked lo and hi tiles, serve all R row tiles.
  constexpr bool kPacked = Ld::kUnpackBytes > 0;
  const int total = tiles * steps;
  auto buffer = [&](int j) {
    return unpack + (size_t)(j & 1) * 2 * tc::kTileBytes;
  };
  auto unpack_step = [&](int j) {
    const int s = j % stages;
    // Inside one asm block: this wait runs between a wgmma and its wait.
    tc::wait_parity(&full_bar[s], (j / stages) & 1);
    tc::unpack_split_tile(ring + s * stage_bytes + 2 * (size_t)bm * tc::kBK,
                          buffer(j), consumers);
  };
  if (kPacked && total > 0) {
    unpack_step(0);
    tc::bar_sync(1, consumers);
  }
  int d[R][64];
  for (int t = 0; t < tiles; ++t) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int i = 0; i < 64; ++i) d[r][i] = 0;
    for (int i = 0; i < steps; ++i) {
      const int j = t * steps + i, s = j % stages;
      const uint8_t* st = ring + s * stage_bytes;
      if (!kPacked) tc::mbar_wait(&full_bar[s], (j / stages) & 1);
      __syncwarp();  // wgmma's .aligned instructions want the warp converged
      const uint8_t* bt = kPacked ? buffer(j) : st + (size_t)bm * tc::kBK;
      tc::wgmma_fence();
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const uint8_t* a = st + (size_t)(wg * R + r) * tc::kWgRows * tc::kBK;
        tc::fence_acc(d[r]);
        tc::wgmma_stage(d[r], a, bt);
        if (kPacked)
          tc::wgmma_stage(d[r], a + (size_t)bm * tc::kBK, bt + tc::kTileBytes);
      }
      tc::wgmma_commit();
      if (kPacked && j + 1 < total) unpack_step(j + 1);
      tc::wgmma_wait_all();
#pragma unroll
      for (int r = 0; r < R; ++r) tc::fence_acc(d[r]);
      if (lane == 0) tc::mbar_arrive(&empty_bar[s]);
      if (kPacked && j + 1 < total) tc::bar_sync(1, consumers);
    }
    // The argmax epilogue. Register d[r][4jj + 2h + e] holds row 16 (warp
    // % 4) + g + 8h of row tile wg * R + r and column 8jj + 2qd + e: a
    // thread's 32 columns of a row rise with (jj, e), and the row's four
    // lanes qd hold the rest.
    const int n0 = col0(t);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = (t % m_tiles) * bm + (wg * R + r) * tc::kWgRows +
                        (warp & 3) * 16 + g + 8 * h;
        const float xr = xs[min(row, M - 1)];
        float bv = -INFINITY;
        int bi = INT_MAX;
#pragma unroll
        for (int jj = 0; jj < 16; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = n0 + 8 * jj + 2 * qd + e;
            if (n >= N) continue;
            float v = ((float)d[r][4 * jj + 2 * h + e] * xr) * scale[n];
            if (cast_bf16) v = __bfloat162float(__float2bfloat16_rn(v));
            if (n >= true_n) v = kNegInf;
            if (better(v, n, bv, bi)) {
              bv = v;
              bi = n;
            }
          }
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {  // the row's four lanes
          const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
          const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
          if (better(ov, oi, bv, bi)) {
            bv = ov;
            bi = oi;
          }
        }
        if (qd == 0 && row < M) {
          pmax[(size_t)row * n_tiles + n0 / kDrqBN] = bv;
          pidx[(size_t)row * n_tiles + n0 / kDrqBN] = bi;
        }
      }
  }
}

// ------------------------------------------------ the weight-only branch

constexpr int kWoRows = w4::kWgRows;  // weight rows of a row tile (m64)
constexpr int kWoTok = 64;            // tokens of a token tile (n64)
constexpr int kWoMaxStages = 8;
constexpr size_t kWoXTile = (size_t)kWoTok * 128;  // [64 tokens, 64 bf16]
// 64-byte K steps of the weight rows a ring stage holds: one 128-byte box
// a row (an L2 line), half the stages' waits and releases (int8 M 64 0.264
// ms against 0.288 at one step a stage, packed 1 % faster, on the H100:
// kernel_study.py variants, 'head_sub1').
constexpr int kWoSub = 2;

// (v, i) as a key whose unsigned order is `better`'s: the value's bits
// made monotonic (-0 taken as +0, as == takes them), then the index
// reversed so that the smaller wins a tie.
__device__ __forceinline__ unsigned long long pair_key(float v, int i) {
  uint32_t u = __float_as_uint(v == 0.0f ? 0.0f : v);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (0xFFFFFFFFu - (uint32_t)i);
}

__device__ __forceinline__ void key_pair(unsigned long long key, float* v,
                                         int* i) {
  uint32_t u = (uint32_t)(key >> 32);
  u = (u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u;
  *v = __uint_as_float(u);
  *i = (int)(0xFFFFFFFFu - (uint32_t)key);
}

// The weight-only branch's pairs (see the header): WGS consumer
// warpgroups of one 64-row tile each (kRows vocab rows a tile) and R token
// tiles a pass, one accumulator each; a producer warp. Local step j of a
// block is K step j % steps of pass (j / steps) % passes of its vocab
// tile j / (steps * passes).
template <bool kPacked, int WGS, int R>
__global__ void __launch_bounds__(WGS * 128 + 32, 1)
head_wo_kernel(const __grid_constant__ CUtensorMap x_map,
               const __grid_constant__ CUtensorMap w_map,
               const float* __restrict__ scale, float* __restrict__ pmax,
               int* __restrict__ pidx, int M, int N, int K, int true_n,
               int cast_bf16, int stages, int steps, int passes,
               int n_tiles) {
  constexpr int kConsumers = 128 * WGS;
  constexpr int kRows = WGS * kWoRows;
  constexpr int kTok = R * kWoTok;
  constexpr int kXTiles = kPacked ? 2 : 1;  // x at kb (and K/2 + kb)
  constexpr size_t kX = (size_t)R * kWoXTile;
  constexpr int kWRow = kWoSub * w4::kStepBytes;  // a weight row's bytes
  constexpr size_t kStage =
      kWoSub * kXTiles * kX + (size_t)kRows * kWRow;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[kWoMaxStages];
  __shared__ __align__(8) uint64_t empty_bar[kWoMaxStages];
  // A pass's best key of each warp for each token, the passes in turns
  // (one barrier a pass: a buffer is written again two passes on).
  __shared__ unsigned long long keys[2][kConsumers / 32][kTok];
  const uint32_t raw = tc::smem_u32(smem_raw);
  uint8_t* ring = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  // The warp index through a shuffle (no divergent path around a wgmma).
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  const int lane = threadIdx.x & 31;
  const int tiles = (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                    (int)gridDim.x;  // vocab tiles of this block
  const int total = tiles * passes * steps;
  auto tile_of = [&](int t) { return (int)blockIdx.x + t * (int)gridDim.x; };

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      tc::mbar_init(&full_bar[s], 1);
      tc::mbar_init(&empty_bar[s], kConsumers);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // the producer warp: one thread loads
    if (lane == 0) {
      for (int j = 0; j < total; ++j) {
        const int s = j % stages;
        uint8_t* st = ring + (size_t)s * kStage;
        if (j >= stages) tc::mbar_wait(&empty_bar[s], ((j / stages) - 1) & 1);
        tc::mbar_expect_tx(&full_bar[s], (uint32_t)kStage);
        const int i = j % steps, p = (j / steps) % passes;
        for (int u = 0; u < kWoSub; ++u) {  // x tiles of sub-step u
          const int k0 = (i * kWoSub + u) * w4::kStepBytes;  // low half
          uint8_t* xt = st + (size_t)u * kXTiles * kX;
          tc::tma_load_2d(xt, &x_map, k0, p * kTok, &full_bar[s]);
          if constexpr (kPacked)
            tc::tma_load_2d(xt + kX, &x_map, K / 2 + k0, p * kTok,
                            &full_bar[s]);
        }
        tc::tma_load_2d(st + kWoSub * kXTiles * kX, &w_map, i * kWRow,
                        tile_of(j / (steps * passes)) * kRows, &full_bar[s]);
      }
    }
    return;
  }

  const int wg = warp >> 2, g = lane >> 2, q = lane & 3;
  float d[R][32];
  int j = 0;  // the local step
  for (int t = 0; t < tiles; ++t) {
    const int n0 = tile_of(t) * kRows;
    // The thread's vocab rows n0 + row + 8 h.
    const int row = wg * kWoRows + (warp & 3) * 16 + g;
    float sc[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      sc[h] = __ldg(scale + min(n0 + row + 8 * h, N - 1));
    for (int p = 0; p < passes; ++p) {
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int i = 0; i < 32; ++i) d[r][i] = 0.0f;
      // A stage's K steps in kGroups wgmma commit groups (gr) of kPer steps
      // each: the packed steps one a group (the A fragments of two do not
      // fit the registers beside the accumulator), the int8 ones together.
      constexpr int kGroups = kPacked ? kWoSub : 1;
      constexpr int kPer = kWoSub / kGroups;
      // The A fragments of group gr of a stage's weight tile, widened in
      // registers.
      using Lo = uint32_t[kPer][4][4];
      using Hi = uint32_t[kPer][kPacked ? 4 : 1][4];
      auto widen = [&](int jj, int gr, Lo& alo, Hi& ahi) {
        const uint8_t* wt = ring + (size_t)(jj % stages) * kStage +
                            kWoSub * kXTiles * kX;
#pragma unroll
        for (int u = 0; u < kPer; ++u)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const uint8_t* wu = wt + (gr * kPer + u) * w4::kStepBytes;
            if constexpr (kPacked)
              w4::a_frags(wu, row, c, q, alo[u][c], ahi[u][c], kWRow);
            else
              w4::a_frags_int8(wu, row, c, q, alo[u][c], kWRow);
          }
      };
      // Group gr's wgmma, one commit group: every token tile against the
      // warpgroup's rows, the k16 windows in order, lo then hi.
      auto mma = [&](int jj, int gr, const Lo& alo, const Hi& ahi) {
        const uint8_t* st = ring + (size_t)(jj % stages) * kStage;
        tc::wgmma_fence();
#pragma unroll
        for (int u = 0; u < kPer; ++u)
#pragma unroll
          for (int c = 0; c < 4; ++c)  // + 32 bytes of K a window
#pragma unroll
            for (int r = 0; r < R; ++r) {
              const uint8_t* xt =
                  st + (size_t)(gr * kPer + u) * kXTiles * kX;
              const uint64_t dlo = tc::sw128_desc(xt + r * kWoXTile) + 2 * c;
              const uint64_t dhi =
                  tc::sw128_desc(xt + kX + r * kWoXTile) + 2 * c;
              w4::wgmma_rs<64>(d[r], alo[u][c], dlo);
              if constexpr (kPacked) w4::wgmma_rs<64>(d[r], ahi[u][c], dhi);
            }
        tc::wgmma_commit();
      };
      // Every consumer thread arrives: no branch on the lane near a wgmma.
      auto release = [&](int jj) { tc::mbar_arrive(&empty_bar[jj % stages]); };
#pragma unroll
      for (int r = 0; r < R; ++r) w4::fence_acc(d[r]);
      for (int i = 0; i < steps; ++i, ++j) {
        // Inside one asm block: no C++ spin loop near a wgmma.
        tc::wait_parity(&full_bar[j % stages], (j / stages) & 1);
#pragma unroll
        for (int gr = 0; gr < kGroups; ++gr) {
          Lo alo;
          Hi ahi;
          widen(j, gr, alo, ahi);
          mma(j, gr, alo, ahi);
          tc::wgmma_wait_all();
        }
        release(j);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) w4::fence_acc(d[r]);
      // The argmax epilogue. Register d[r][4jj + 2h + e] holds vocab row
      // n0 + row + 8h and token p * kTok + 64r + 8jj + 2q + e: the token's
      // rows in this thread are h 0 and 1, and the 8 lanes of its
      // quad q hold the warp's other rows.
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float bv = -INFINITY;
            int bi = INT_MAX;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int n = n0 + row + 8 * h;
              if (n >= N) continue;
              float v = d[r][4 * jj + 2 * h + e] * sc[h];
              if (cast_bf16) v = __bfloat162float(__float2bfloat16_rn(v));
              if (n >= true_n) v = kNegInf;
              if (better(v, n, bv, bi)) {
                bv = v;
                bi = n;
              }
            }
#pragma unroll
            for (int o = 4; o < 32; o <<= 1) {  // the quad's 8 lanes
              const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
              const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
              if (better(ov, oi, bv, bi)) {
                bv = ov;
                bi = oi;
              }
            }
            if (g == 0)  // 0: no row of this warp below N
              keys[(t * passes + p) & 1][warp]
                  [r * kWoTok + 8 * jj + 2 * q + e] =
                      bi == INT_MAX ? 0ull : pair_key(bv, bi);
          }
      tc::bar_sync(1, kConsumers);  // every warp's keys are in
      for (int tok = threadIdx.x; tok < kTok; tok += kConsumers) {
        const int m = p * kTok + tok;
        const auto& kb = keys[(t * passes + p) & 1];
        unsigned long long key = kb[0][tok];
#pragma unroll
        for (int w = 1; w < kConsumers / 32; ++w)
          key = max(key, kb[w][tok]);
        if (m < M) {
          float v;
          int i;
          key_pair(key, &v, &i);
          pmax[(size_t)m * n_tiles + tile_of(t)] = v;
          pidx[(size_t)m * n_tiles + tile_of(t)] = i;
        }
      }
    }
  }
}

__global__ void __launch_bounds__(256)
head_reduce_kernel(const float* __restrict__ pmax, const int* __restrict__ pidx,
                   int nblk, int* __restrict__ ids) {
  __shared__ float sv[256];
  __shared__ int si[256];
  const int m = blockIdx.x;
  float bv = -INFINITY;
  int bi = INT_MAX;
  for (int j = threadIdx.x; j < nblk; j += blockDim.x) {
    const float v = pmax[(size_t)m * nblk + j];
    const int i = pidx[(size_t)m * nblk + j];
    if (better(v, i, bv, bi)) {
      bv = v;
      bi = i;
    }
  }
  sv[threadIdx.x] = bv;
  si[threadIdx.x] = bi;
  __syncthreads();
  for (int o = blockDim.x / 2; o > 0; o >>= 1) {
    if (threadIdx.x < o &&
        better(sv[threadIdx.x + o], si[threadIdx.x + o], sv[threadIdx.x],
               si[threadIdx.x])) {
      sv[threadIdx.x] = sv[threadIdx.x + o];
      si[threadIdx.x] = si[threadIdx.x + o];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) ids[m] = si[0] == INT_MAX ? 0 : si[0];
}

// The DRQ branch's launch 2: consumer warpgroups (one at M <= 64), row
// tiles of 64 a warpgroup (two above 128 rows: a stage's B tile then
// serves 256 rows, read and unpacked once), row and column tiles, K steps
// a tile, ring stages (as many as fit, at most the core's kMaxStages),
// blocks (one an SM, at most one a column tile) and dynamic shared memory.
constexpr int kTwoRowTilesAbove = 128;

struct HeadPlan {
  int wgs, rows, m_tiles, n_tiles, steps, stages, blocks;
  size_t smem;
};

template <class Ld>
HeadPlan head_plan(int M, int N, int K) {
  HeadPlan p;
  p.wgs = M <= tc::kWgRows ? 1 : 2;
  p.rows = M > kTwoRowTilesAbove ? 2 : 1;
  const int bm = tc::kWgRows * p.rows * p.wgs;
  p.m_tiles = (M + bm - 1) / bm;
  p.n_tiles = (N + kDrqBN - 1) / kDrqBN;
  p.steps = Ld::steps(K);
  const size_t stage = Ld::stage_bytes(bm);
  p.stages = (int)std::min((size_t)tc::kMaxStages,
                           (tc::kSmemBudget - 1024 - Ld::kUnpackBytes) / stage);
  p.smem = 1024 + p.stages * stage + Ld::kUnpackBytes;
  p.blocks = std::max(1, std::min(p.n_tiles, tc::sm_count()));
  return p;
}

template <class Ld, typename T>
int launch_drq(const void* x, const void* w, const void* scale, void* xq,
               void* xs, void* pmax, void* pidx, void* ids, int M, int N,
               int K, int true_n, int cast_bf16, cudaStream_t stream) {
  const HeadPlan p = head_plan<Ld>(M, N, K);
  int err = tc::launch_quantize<Ld, T>(x, xq, xs, M, K, stream);
  if (err != 0) return err;
  CUtensorMap a_map, b_map;
  if (!tc::encode_2d(&a_map, xq, (uint64_t)K, (uint64_t)M,
                     (uint32_t)(tc::kWgRows * p.rows * p.wgs)) ||
      !tc::encode_2d(&b_map, w, Ld::b_cols(K), (uint64_t)N,
                     (uint32_t)kDrqBN))
    return tc::kTensorMapFailed;
  auto* kernel = p.rows == 2 ? head_tc_kernel<Ld, 2> : head_tc_kernel<Ld, 1>;
  err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != 0) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(p.blocks);
  config.blockDim = dim3(128 * p.wgs + 32);
  config.dynamicSmemBytes = p.smem;
  config.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  config.attrs = &attr;
  config.numAttrs = 1;
  err = (int)cudaLaunchKernelEx(
      &config, kernel, a_map, b_map, static_cast<const float*>(xs),
      static_cast<const float*>(scale), static_cast<float*>(pmax),
      static_cast<int*>(pidx), M, N, true_n, cast_bf16, K, p.wgs, p.stages,
      p.steps, p.m_tiles, p.n_tiles);
  if (err != 0) return err;
  head_reduce_kernel<<<M, 256, 0, stream>>>(static_cast<const float*>(pmax),
                                            static_cast<const int*>(pidx),
                                            p.n_tiles, static_cast<int*>(ids));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_drq_branch(int packed, const void* x, const void* w,
                      const void* scale, void* xq, void* xs, void* pmax,
                      void* pidx, void* ids, int M, int N, int K, int true_n,
                      int cast_bf16, cudaStream_t s) {
  if (packed)
    return launch_drq<tc::SplitNibblesRecipB, T>(x, w, scale, xq, xs, pmax,
                                                 pidx, ids, M, N, K, true_n,
                                                 cast_bf16, s);
  return launch_drq<tc::Int8RowsB, T>(x, w, scale, xq, xs, pmax, pidx, ids, M,
                                      N, K, true_n, cast_bf16, s);
}

}  // namespace

// x [M, K] f32 or bf16 (x_bf16); w int8 [N, K] or packed uint8 [N, K/2]
// (packed); scale [N] f32; scratch xq int8 [M, K], xs f32 [M], pmax f32 /
// pidx int32 [M, ceil(N / 128)]; ids int32 [M]. Takes K % 32 == 0 (16-byte
// aligned rows), else kShapeRefused (nothing launched).
extern "C" int aeqt_head_argmax(const void* x, int x_bf16, const void* w,
                                int packed, const void* scale, void* xq,
                                void* xs, void* pmax, void* pidx, void* ids,
                                int M, int N, int K, int true_n,
                                int cast_bf16, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 32 != 0) return aeqt::kShapeRefused;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return launch_drq_branch<__nv_bfloat16>(packed, x, w, scale, xq, xs, pmax,
                                            pidx, ids, M, N, K, true_n,
                                            cast_bf16, s);
  return launch_drq_branch<float>(packed, x, w, scale, xq, xs, pmax, pidx,
                                  ids, M, N, K, true_n, cast_bf16, s);
}

// The DRQ branch's launch 2 (kernels/head.py DRQ_PLAN_FIELDS): blocks, row
// tiles, column tiles, threads, dynamic shared memory, ring stages; or
// kShapeRefused.
extern "C" int aeqt_head_argmax_plan(int M, int N, int K, int packed,
                                     long long* fields) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 32 != 0) return aeqt::kShapeRefused;
  const HeadPlan p = packed ? head_plan<tc::SplitNibblesRecipB>(M, N, K)
                            : head_plan<tc::Int8RowsB>(M, N, K);
  fields[0] = p.blocks;
  fields[1] = p.m_tiles;
  fields[2] = p.n_tiles;
  fields[3] = 128 * p.wgs + 32;
  fields[4] = (long long)p.smem;
  fields[5] = p.stages;
  return 0;
}

namespace {

// The weight-only branch's launch: consumer warpgroups (64 vocab rows
// each), token tiles a pass, vocab rows a tile, tokens a pass, passes,
// vocab tiles, stages a pass, ring stages (as many as fit, at most
// kWoMaxStages), blocks (one an SM, at most one a vocab tile) and dynamic
// shared memory.
struct WoPlan {
  int wgs, r, rows, tok, passes, n_tiles, steps, stages, blocks;
  size_t smem;
};

WoPlan wo_plan(int M, int N, int K, bool packed) {
  WoPlan p;
  p.wgs = M <= kWoTok ? 4 : 2;
  p.r = M <= kWoTok ? 1 : 2;
  p.rows = p.wgs * kWoRows;
  p.tok = p.r * kWoTok;
  p.passes = (M + p.tok - 1) / p.tok;
  p.n_tiles = (N + p.rows - 1) / p.rows;
  p.steps = ((packed ? K / 2 : K) / w4::kStepBytes + kWoSub - 1) / kWoSub;
  const size_t stage = (size_t)kWoSub * (packed ? 2 : 1) * p.r * kWoXTile +
                       (size_t)p.rows * kWoSub * w4::kStepBytes;
  // The opt-in maximum less the static keys and barriers and the ring's
  // 1024-byte alignment.
  const size_t budget =
      232448 - 1024 - 2 * (size_t)(4 * p.wgs) * p.tok * 8 - 256;
  p.stages = (int)std::min((size_t)kWoMaxStages, budget / stage);
  p.smem = 1024 + p.stages * stage;
  p.blocks = std::max(1, std::min(p.n_tiles, w4::sm_count()));
  return p;
}

bool wo_takes(int M, int N, int K, bool packed) {
  return M > 0 && N > 0 && K > 0 &&
         K % (packed ? 2 * w4::kStepBytes : w4::kStepBytes) == 0;
}

template <bool kPacked, int WGS, int R>
int launch_wo_kernel(const WoPlan& p, const void* x, const void* w,
                     const void* scale, void* pmax, void* pidx, int M, int N,
                     int K, int true_n, int cast_bf16, cudaStream_t stream) {
  CUtensorMap x_map, w_map;
  if (!w4::encode_2d(&x_map, x, 2, (uint64_t)K, (uint64_t)M, 64,
                     (uint32_t)p.tok, true) ||
      !w4::encode_2d(&w_map, w, 1, (uint64_t)(kPacked ? K / 2 : K),
                     (uint64_t)N, kWoSub * w4::kStepBytes, (uint32_t)p.rows,
                     false))
    return tc::kTensorMapFailed;
  auto* kernel = head_wo_kernel<kPacked, WGS, R>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<p.blocks, WGS * 128 + 32, p.smem, stream>>>(
      x_map, w_map, static_cast<const float*>(scale),
      static_cast<float*>(pmax), static_cast<int*>(pidx), M, N, K, true_n,
      cast_bf16, p.stages, p.steps, p.passes, p.n_tiles);
  return (int)cudaGetLastError();
}

template <bool kPacked>
int launch_wo(const WoPlan& p, const void* x, const void* w,
              const void* scale, void* pmax, void* pidx, int M, int N, int K,
              int true_n, int cast_bf16, cudaStream_t s) {
  if (p.wgs == 4)
    return launch_wo_kernel<kPacked, 4, 1>(p, x, w, scale, pmax, pidx, M, N,
                                           K, true_n, cast_bf16, s);
  return launch_wo_kernel<kPacked, 2, 2>(p, x, w, scale, pmax, pidx, M, N, K,
                                         true_n, cast_bf16, s);
}

}  // namespace

// The weight-only branch (drq=False): x [M, K] bf16 (rounded by the
// caller; 16-byte aligned); w int8 [N, K] or packed uint8 [N, K/2]
// (16-byte aligned rows); scale [N] f32; pmax f32 / pidx int32 [M,
// ceil(N / 128)] at least (the pairs of M <= 64 take ceil(N / 256));
// ids int32 [M]; cast_bf16 rounds each logit to bf16. Takes K % 128 == 0
// (packed) or K % 64 == 0 (int8), else kShapeRefused (nothing launched).
extern "C" int aeqt_head_argmax_bf16(const void* x, const void* w, int packed,
                                     const void* scale, void* pmax,
                                     void* pidx, void* ids, int M, int N,
                                     int K, int true_n, int cast_bf16,
                                     void* stream) {
  if (!wo_takes(M, N, K, packed != 0)) return aeqt::kShapeRefused;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const WoPlan p = wo_plan(M, N, K, packed != 0);
  const int err = packed ? launch_wo<true>(p, x, w, scale, pmax, pidx, M, N,
                                           K, true_n, cast_bf16, s)
                         : launch_wo<false>(p, x, w, scale, pmax, pidx, M, N,
                                            K, true_n, cast_bf16, s);
  if (err != 0) return err;
  head_reduce_kernel<<<M, 256, 0, s>>>(static_cast<const float*>(pmax),
                                       static_cast<const int*>(pidx),
                                       p.n_tiles, static_cast<int*>(ids));
  return (int)cudaGetLastError();
}

// The weight-only branch's pairs launch (kernels/head.py WO_PLAN_FIELDS):
// blocks, vocab rows a tile, vocab tiles, tokens a pass, passes, threads,
// dynamic shared memory, ring stages; or kShapeRefused.
extern "C" int aeqt_head_argmax_bf16_plan(int M, int N, int K, int packed,
                                          long long* fields) {
  if (!wo_takes(M, N, K, packed != 0)) return aeqt::kShapeRefused;
  const WoPlan p = wo_plan(M, N, K, packed != 0);
  fields[0] = p.blocks;
  fields[1] = p.rows;
  fields[2] = p.n_tiles;
  fields[3] = p.tok;
  fields[4] = p.passes;
  fields[5] = 128 * p.wgs + 32;
  fields[6] = (long long)p.smem;
  fields[7] = p.stages;
  return 0;
}
