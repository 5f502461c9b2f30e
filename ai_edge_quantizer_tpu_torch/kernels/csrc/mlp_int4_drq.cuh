// The kernels of the DRQ MLP (#3, mlp_int4_drq.cu, whose header gives
// their arithmetic and design) on the int8 tensor-core core, shared with the
// fused decode block (#5, fused_block.cu), which runs them with two more
// epilogues:
//   kDown with a residual (BlockEpilogue::x): y = x + R * s_d, stored in
//     f32 (xf) and in x's dtype, instead of R * s_d;
//   kQkv: the QKV projection's pair tile. Tile y of a head holds rows e0 ..
//     e0 + 63 and e0 + H/2 .. e0 + H/2 + 63 of the head (e0 = 64 * (y %
//     (H / 128))), the gate/up layout again, so that one thread holds both
//     halves x1 = qkv[e] and x2 = qkv[e + H/2] of a rotation; the epilogue
//     applies half-split RoPE (r1 = x1 c - x2 s, r2 = x2 c + x1 s, each
//     product and the sum rounded on its own) and writes q f32 [M, NQ, H],
//     or the new row's codes clip(rint(v * inv), -127, 127) of K (rotated,
//     kq_inv) and V (vq_inv) into k_new, v_new int8 [M, H]. H % 128 == 0.
// The attention prologue (#20, qkv_rope.cu) runs the pair tile with one
// more epilogue:
//   kQkvRope: kQkv's pair tile over NQ query and NK key/value heads. Its
//     projection (f32(acc) * xs) * s is rounded to TOut first (the plain
//     version's cast), then the query and key heads (head < NQ + NK) are
//     rotated in f32 and q, k and v stored in TOut into [M, NQ * H],
//     [M, NK * H] and [M, NK * H]. kQkv keeps its f32 q, which it does not
//     round, and takes one KV head (head <= NQ); this kind takes any NK.
#pragma once

#include "int8_tc_gemm.cuh"

namespace aeqt {
namespace mlp {

namespace tc = aeqt::tc;
using Loader = tc::SplitNibblesRecipB;

constexpr int kGateCols = 64;  // h columns a gate/up tile (64 gate, 64 up rows)
constexpr int kHQuantThreads = 256;
constexpr int kDownOneWgRows = 256;  // the down: 64-row tiles up to these rows
constexpr int kMaxChain = 8;         // blocks of a down tile's chain
// At one warpgroup the gate/up keeps two ring stages and one unpack
// buffer, so that two blocks share an SM (256 tiles at decode in one wave).
constexpr int kGateUpStages1 = 2;

// The contractions of mlp_tc_kernel: the gate/up, the down, and the QKV
// projection (a pair tile like the gate/up's) of the fused block and of
// the attention prologue.
enum Kind : int { kGateUp = 0, kDown = 1, kQkv = 2, kQkvRope = 3 };

// The operands of the down's and the QKV's epilogues (the fused block's;
// kQkvRope's for the attention prologue).
struct BlockEpilogue {
  const void* x;     // kDown: the residual [M, D] in TOut; nullptr: none
  float* xf;         // kDown: x + y in f32 [M, D]
  const float* cos;  // kQkv, kQkvRope: [M, H/2]
  const float* sin;  // kQkv, kQkvRope: [M, H/2]
  float* q;          // kQkv: the rotated query heads [M, NQ, H]
  int8_t* k_new;     // kQkv: [M, H]
  int8_t* v_new;     // kQkv: [M, H]
  void* k;           // kQkvRope: the rotated key heads [M, NK * H] in TOut
  void* v;           // kQkvRope: the value heads [M, NK * H] in TOut
  int H, NQ, NK;     // NK: kQkvRope's key/value heads
  float kq_inv, vq_inv;
};

// Narrow-range symmetric int8 code of v (already multiplied by 1/scale).
__device__ __forceinline__ int8_t row_code(float v) {
  return (int8_t)(int)fminf(fmaxf(rintf(v), -127.0f), 127.0f);
}

// The launch of one of the contractions: grid (m_tiles, n_tiles, chain).
// Unpack buffers: 2, alternating by step (two warpgroups, or one that
// overlaps: step i + 1's tile unpacks while step i's wgmma run, the down
// and the QKV at one warpgroup), or 1 (the gate/up at one warpgroup, so
// that two blocks share an SM and overlap each other instead: 256 tiles at
// decode in one wave; a barrier after each step's wgmma lets the next
// unpack reuse the buffer). chain > 1 (the down): the blocks of a tile's
// cluster, each with an inbox of the tile's f32 sums.
struct Gemm {
  int wgs, m_tiles, n_tiles, steps, stages, chain, unpack_buffers, overlap;
  size_t smem;
};

inline Gemm size_gemm(int M, int wgs, int n_tiles, int steps, int chain,
                      int max_stages, int unpack_buffers, int overlap) {
  Gemm g;
  g.wgs = wgs;
  g.m_tiles = (M + tc::kWgRows * wgs - 1) / (tc::kWgRows * wgs);
  g.n_tiles = n_tiles;
  g.steps = steps;
  g.chain = chain;
  g.unpack_buffers = unpack_buffers;
  g.overlap = overlap;
  const size_t unpack = (size_t)unpack_buffers * 2 * tc::kTileBytes;
  const size_t boxes = chain > 1 ? (size_t)64 * 128 * wgs * 4 : 0;
  const size_t stage = Loader::stage_bytes(tc::kWgRows * wgs);
  g.stages = (int)std::min((size_t)max_stages,
                           (tc::kSmemBudget - 1024 - unpack - boxes) / stage);
  g.stages = std::min(g.stages, std::max(steps, 2));
  g.smem = 1024 + g.stages * stage + unpack + boxes;
  return g;
}

inline Gemm gate_up_plan(int M, int D, int F) {
  const int wgs = M <= tc::kWgRows ? 1 : 2;
  return size_gemm(M, wgs, (F + kGateCols - 1) / kGateCols,
                   (D / 2 + tc::kBK - 1) / tc::kBK, 1,
                   wgs == 1 ? kGateUpStages1 : tc::kMaxStages, wgs == 1 ? 1 : 2,
                   0);
}

// The fused block's QKV, N = (NQ + 2) H output columns in pair tiles of
// 2 * kGateCols: one warpgroup at every M (four times the blocks of two
// at M 256: 80 at the bench shape), overlapping its unpack.
inline Gemm qkv_plan(int M, int D, int N) {
  return size_gemm(M, 1, N / (2 * kGateCols), (D / 2 + tc::kBK - 1) / tc::kBK,
                   1, tc::kMaxStages, 2, 1);
}

// Whether the contractions take a shape (#3's and the fused block's
// terms; the MLP adds its scratch layout's).
inline bool shape_ok(int M, int D, int F, int bf) {
  return M > 0 && D > 0 && D % 32 == 0 && bf > 0 && bf % 256 == 0 &&
         F % bf == 0 && bf <= 8192 &&
         (F + kGateCols - 1) / kGateCols <= 65535 &&
         (D + tc::kBN - 1) / tc::kBN <= 65535;
}

// The shared::cluster address of `p` (this block's shared memory) in block
// `rank` of the cluster.
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(a)
               : "r"(tc::smem_u32(p)), "r"(rank));
  return a;
}

// Sixteen bytes into block-cluster address dst (another block's shared
// memory), completing them on the barrier at cluster address bar there.
__device__ __forceinline__ void store_to_cluster(uint32_t dst, float4 v,
                                                 uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32"
      " [%0], {%1, %2, %3, %4}, [%5];" ::"r"(dst),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

// The B rows of pair tile y: the first half's r0 and the second's r1
// (the gate/up: gate rows 64y.., up rows F + 64y..; the QKV: rows e0.. and
// e0 + H/2.. of head 64y / (H/2)).
__device__ __forceinline__ int2 pair_rows(int kind, int y, int F, int H) {
  if (kind == kGateUp) return make_int2(kGateCols * y, F + kGateCols * y);
  const int per_head = H / (2 * kGateCols);
  const int r0 = (y / per_head) * H + (y % per_head) * kGateCols;
  return make_int2(r0, r0 + H / 2);
}

// Contraction 2 (kGateUp), 4 (kDown) or the fused block's QKV (kQkv); see
// mlp_int4_drq.cu's header.
//   gate/up: a_map xq [M, D], b_map wgu [2F, D/2] in boxes of 64 rows,
//     row_s xs [M], col_s s_gu [2F], out h [M, F] f32, N = F.
//   down: a_map hq [M, F], b_map wd [D, F/2] in boxes of 128 rows, row_s
//     hs [M, F/bf], col_s s_d [D], out y [M, D], N = D; a tile's groups
//     round-robin over the gridDim.z blocks of its cluster (the chain).
//   QKV: a_map xq [M, D], b_map wqkv [N, D/2] in boxes of 64 rows, row_s
//     xs [M], col_s s_qkv [N], N = (NQ + 2) H; out unused (ep.q, k_new,
//     v_new). kQkvRope: N = (NQ + 2 NK) H, out q [M, NQ H] (ep.k, ep.v).
template <int kKind, typename TOut>
__global__ void __launch_bounds__(2 * 128 + 32, 1)
mlp_tc_kernel(__grid_constant__ const CUtensorMap a_map,
              __grid_constant__ const CUtensorMap b_map,
              const float* __restrict__ row_s,
              const float* __restrict__ col_s, TOut* __restrict__ out,
              int M, int N, int D, int F, int bf, int wgs, int stages,
              int unpack_buffers, int overlap, int act_silu,
              const BlockEpilogue ep) {
  constexpr bool kIsDown = kKind == kDown;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[tc::kMaxStages];
  __shared__ __align__(8) uint64_t empty_bar[tc::kMaxStages];
  __shared__ __align__(8) uint64_t inbox_bar;  // the chain's messages
  const uint32_t raw = tc::smem_u32(smem_raw);
  uint8_t* ring = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  const int bm = tc::kWgRows * wgs;
  const size_t stage_bytes = Loader::stage_bytes(bm);
  uint8_t* unpack = ring + (size_t)stages * stage_bytes;
  const int consumers = 128 * wgs;
  const uint32_t box_bytes = 64 * 4 * consumers;  // the tile's f32 sums
  float4* inbox = reinterpret_cast<float4*>(
      unpack + (size_t)unpack_buffers * 2 * tc::kTileBytes);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.x * bm;
  const int n0 = blockIdx.y * (kIsDown ? tc::kBN : kGateCols);
  // The pair tile's B rows (gate/up, QKV).
  const int2 pr =
      kIsDown ? make_int2(n0, 0) : pair_rows(kKind, blockIdx.y, F, ep.H);
  // The down's groups and this block's share: groups z, z + chain, ...
  const int group_steps = kIsDown ? bf / 2 / tc::kBK : 1;  // stages a group
  const int groups = kIsDown ? F / bf : 1;
  const int chain = kIsDown ? (int)gridDim.z : 1, z = blockIdx.z;
  const int my_groups = kIsDown ? (groups - z + chain - 1) / chain : 1;
  const int nk = kIsDown ? my_groups * group_steps
                         : (D / 2 + tc::kBK - 1) / tc::kBK;
  auto step_of = [=](int i) {  // the K step of local step i
    return kIsDown ? (z + (i / group_steps) * chain) * group_steps +
                         i % group_steps
                   : i;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      tc::mbar_init(&full_bar[s], 1);
      tc::mbar_init(&empty_bar[s], 4 * wgs);  // lane 0 of every consumer warp
    }
    tc::mbar_init(&inbox_bar, 1);
    // A block whose first group is not group 0 waits for R[g - 1] first.
    if (chain > 1 && z > 0) tc::mbar_expect_tx(&inbox_bar, box_bytes);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (chain > 1) tc::cluster_sync();  // every block's barriers are ready

  if (warp == 4 * wgs) {  // the producer warp: one thread issues the loads
    if (lane == 0) {
      const CUtensorMap* am = &a_map;
      const CUtensorMap* bmap = &b_map;
      auto load_b = [=](uint8_t* st, uint64_t* bar, int step) {
        uint8_t* bt = st + 2 * (size_t)bm * tc::kBK;
        if constexpr (kIsDown) {
          tc::tma_load_2d(bt, bmap, step * tc::kBK, n0, bar);
        } else {  // the pair's first rows into the tile's first half
          tc::tma_load_2d(bt, bmap, step * tc::kBK, pr.x, bar);
          tc::tma_load_2d(bt + kGateCols * tc::kBK, bmap, step * tc::kBK,
                          pr.y, bar);
        }
      };
      auto load_a = [=](uint8_t* st, uint64_t* bar, int step) {
        int lo = step * tc::kBK, hi = D / 2 + lo;  // gate/up: split-half rows
        if constexpr (kIsDown) {  // group-split: the stage's group g
          lo = lo + (step / group_steps) * (bf / 2);
          hi = lo + bf / 2;
        }
        tc::tma_load_2d(st, am, lo, m0, bar);
        tc::tma_load_2d(st + (size_t)bm * tc::kBK, am, hi, m0, bar);
      };
      // The weights do not depend on the launch before: the first stages'
      // weight tiles are on their way before its output is ready.
      const int early = min(nk, stages);
      for (int i = 0; i < early; ++i) {
        tc::mbar_expect_tx(&full_bar[i], (uint32_t)stage_bytes);
        load_b(ring + i * stage_bytes, &full_bar[i], step_of(i));
      }
      tc::griddep_wait();
      for (int i = 0; i < nk; ++i) {
        const int s = i % stages;
        uint8_t* st = ring + s * stage_bytes;
        if (i >= stages) {
          tc::mbar_wait(&empty_bar[s], ((i / stages) - 1) & 1);
          tc::mbar_expect_tx(&full_bar[s], (uint32_t)stage_bytes);
          load_b(st, &full_bar[s], step_of(i));
        }
        load_a(st, &full_bar[s], step_of(i));
      }
    }
    __syncwarp();
    if (chain > 1) tc::cluster_sync();  // the consumers' last barrier
    return;
  }

  const int wg = warp >> 2;
  const int row = wg * tc::kWgRows + (warp & 3) * 16 + (lane >> 2);  // and + 8
  // Column scales are weights: loaded before the main loop. The pair
  // epilogue gives lane l (of a half-warp) columns 4l .. 4l + 3 of each
  // half of the tile, the down's lane l columns 4l .. 4l + 3 of its 128.
  const int c = kIsDown ? n0 + 4 * lane : pr.x + 4 * (lane & 15);
  const int c2 = pr.y + 4 * (lane & 15);  // the pair's second half
  const int b_rows = kKind == kGateUp ? 2 * F : N;  // rows of col_s
  float sc[4], su[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    sc[e] = col_s[min(c + e, b_rows - 1)];  // clamped: loads need no guard
    su[e] = kIsDown ? 0.0f : col_s[min(c2 + e, b_rows - 1)];
  }
  if constexpr (kIsDown) tc::griddep_wait();  // hs comes from launch 3

  int d[64];
  float acc[kIsDown ? 64 : 1];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0;
#pragma unroll
  for (int i = 0; i < (kIsDown ? 64 : 1); ++i) acc[i] = 0.0f;
  float hs_row[2] = {0.0f, 0.0f};  // down: the group's hs of rows row, row + 8
  int received = 0;                // down: messages of the chain read
  // The tiles of step i unpack into buffer i & 1 (one buffer: 0). With
  // overlap, step i + 1's unpack runs while step i's wgmma do; without,
  // unpack, then wgmma, then wait.
  auto buffer = [=](int i) {
    return unpack + (unpack_buffers == 2 ? (i & 1) * 2 * tc::kTileBytes : 0);
  };
  auto unpack_step = [&](int i) {
    const int s = i % stages;
    // Inside one asm block: this wait runs between a wgmma and its wait.
    tc::wait_parity(&full_bar[s], (i / stages) & 1);
    tc::unpack_split_tile(ring + s * stage_bytes + 2 * (size_t)bm * tc::kBK,
                          buffer(i), consumers);
  };
  if (overlap && nk > 0) {
    unpack_step(0);
    tc::bar_sync(1, consumers);  // both tiles whole before any wgmma
  }
  for (int i = 0; i < nk; ++i) {
    const int step = step_of(i);
    if constexpr (kIsDown) {
      if (i % group_steps == 0) {
        const int g = step / group_steps;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          hs_row[h] = row_s[(size_t)min(m0 + row + 8 * h, M - 1) * groups + g];
      }
    }
    const int s = i % stages;
    if (!overlap) {
      unpack_step(i);
      tc::bar_sync(1, consumers);  // both tiles whole before any wgmma
    }
    __syncwarp();  // wgmma's .aligned instructions want the warp converged
    {
      const uint8_t* lo = buffer(i);
      const uint8_t* a =
          ring + s * stage_bytes + (size_t)wg * tc::kWgRows * tc::kBK;
      tc::wgmma_fence();
      tc::fence_acc(d);
      tc::wgmma_stage(d, a, lo);
      tc::wgmma_stage(d, a + (size_t)bm * tc::kBK, lo + tc::kTileBytes);
      tc::wgmma_commit();
    }
    if (overlap && i + 1 < nk) unpack_step(i + 1);
    tc::wgmma_wait_all();
    tc::fence_acc(d);
    // The stage's codes (this wgmma) and packed tile (its unpack) are read.
    if (lane == 0) tc::mbar_arrive(&empty_bar[s]);
    // Every warp's wgmma of a buffer is done before the buffer is unpacked
    // into again (a warp's wait covers only its own part of the warpgroup's
    // wgmma): overlap, step i + 2 into buffer i & 1 (and step i + 1's tiles
    // are whole); one buffer, step i + 1 into it. Two buffers without
    // overlap need no barrier here: step i + 1's barrier comes after every
    // warp's wait of step i, before step i + 2 unpacks.
    if ((overlap || unpack_buffers == 1) && i + 1 < nk)
      tc::bar_sync(1, consumers);
    if constexpr (kIsDown) {
      if ((i + 1) % group_steps == 0) {
        // Group g's end: R[g] = R[g - 1] + f32(part) * hs, R[-1] = 0, in
        // group order. R[g - 1] is in acc, or comes from the block before
        // in the chain, which holds group g - 1.
        const int g = step / group_steps;
        if (chain > 1 && g > 0) {
          tc::mbar_wait(&inbox_bar, received & 1);
          ++received;
#pragma unroll
          for (int k4 = 0; k4 < 16; ++k4) {
            const float4 v = inbox[k4 * consumers + threadIdx.x];
            acc[4 * k4] = v.x;
            acc[4 * k4 + 1] = v.y;
            acc[4 * k4 + 2] = v.z;
            acc[4 * k4 + 3] = v.w;
          }
        }
#pragma unroll
        for (int k = 0; k < 64; ++k) {
          acc[k] = acc[k] + (float)d[k] * hs_row[(k >> 1) & 1];
          d[k] = 0;
        }
        if (chain > 1 && g < groups - 1) {
          // R[g] straight from the registers into the inbox of the block of
          // g + 1, each thread its own sixteen bytes. This block's next
          // message (R[g + chain - 1]) arrives only after this one went
          // round the chain, which needs every thread's bytes here: the
          // expect goes first, and no thread still reads the inbox then.
          if (threadIdx.x == 0 && g + chain < groups)
            tc::mbar_expect_tx(&inbox_bar, box_bytes);
          const int next = (z + 1) % chain;
          const uint32_t dst = cluster_addr(inbox + threadIdx.x, next);
          const uint32_t bar = cluster_addr(&inbox_bar, next);
#pragma unroll
          for (int k4 = 0; k4 < 16; ++k4)
            store_to_cluster(dst + k4 * consumers * 16,
                             make_float4(acc[4 * k4], acc[4 * k4 + 1],
                                         acc[4 * k4 + 2], acc[4 * k4 + 3]),
                             bar);
        }
      }
    }
  }

  // The epilogue through shared memory (the ring is free once every
  // warpgroup's wgmma has left it): the tile's sums [bm][kEpiStride]. In
  // a chain, the block of the last group stores the tile.
  constexpr int S = tc::kEpiStride;
  if (kIsDown && (groups - 1) % chain != z) {
    tc::cluster_sync();  // no block leaves while its stores are in flight
    return;
  }
  tc::bar_sync(1, consumers);
  {
    const int col = 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int at = (row + 8 * h) * S + col + 8 * j;
        if constexpr (kIsDown)
          *reinterpret_cast<float2*>(reinterpret_cast<float*>(ring) + at) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        else
          *reinterpret_cast<int2*>(reinterpret_cast<int*>(ring) + at) =
              make_int2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
      }
  }
  if constexpr (kIsDown) {
    tc::bar_sync(1, consumers);
    const float* tile = reinterpret_cast<const float*>(ring);
    for (int rr = warp; rr < bm; rr += consumers / 32) {
      const int r = m0 + rr;
      if (r >= M || c >= N) continue;  // N % 4 == 0: c < N covers c + 3
      const float4 a =
          *reinterpret_cast<const float4*>(&tile[rr * S + 4 * lane]);
      float y[4] = {a.x * sc[0], a.y * sc[1], a.z * sc[2], a.w * sc[3]};
      const size_t at = (size_t)r * N + c;
      if (ep.x != nullptr) {  // the fused block: x + y, kept in f32 too
        const TOut* x = static_cast<const TOut*>(ep.x) + at;
#pragma unroll
        for (int e = 0; e < 4; ++e) y[e] = aeqt::load_f(x, e) + y[e];
        tc::store4(ep.xf + at, y);
      }
      tc::store4(out + at, y);
    }
    if (chain > 1) tc::cluster_sync();  // no block leaves while others store
  } else {
    // The pair's first-half columns 0-63 and second-half 64-127 of a row;
    // a half-warp takes a row, lane l its columns 4l .. 4l + 3 of both.
    float* row_scale = reinterpret_cast<float*>(ring) + bm * S;
    tc::griddep_wait();  // xs comes from the launch before
    if (threadIdx.x < bm)
      row_scale[threadIdx.x] = row_s[min(m0 + threadIdx.x, M - 1)];
    tc::bar_sync(1, consumers);
    const int* tile = reinterpret_cast<const int*>(ring);
    const int l = lane & 15;
    for (int rr = 2 * warp + (lane >> 4); rr < bm; rr += consumers / 16) {
      const int r = m0 + rr;
      if (r >= M || c >= N) continue;  // N % 4 == 0: c < N covers c + 3
      const int4 ag = *reinterpret_cast<const int4*>(&tile[rr * S + 4 * l]);
      const int4 au =
          *reinterpret_cast<const int4*>(&tile[rr * S + kGateCols + 4 * l]);
      const int g4[4] = {ag.x, ag.y, ag.z, ag.w};
      const int u4[4] = {au.x, au.y, au.z, au.w};
      const float xr = row_scale[rr];
      float x1[4], x2[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x1[e] = ((float)g4[e] * xr) * sc[e];
        x2[e] = ((float)u4[e] * xr) * su[e];
      }
      if constexpr (kKind == kGateUp) {
        float hv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float a = act_silu ? aeqt::silu(x1[e]) : aeqt::gelu_tanh(x1[e]);
          hv[e] = a * x2[e];
        }
        tc::store4(out + (size_t)r * N + c, hv);
      } else if constexpr (kKind == kQkvRope) {
        // Head `head`, elements e0 .. e0 + 3 of its first half: the
        // projection in TOut, then the rotation of a query or key head.
        const int H = ep.H, half = H / 2, head = pr.x / H;
        const int e0 = pr.x % H + 4 * l;
        const TOut* tag = nullptr;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          x1[e] = aeqt::round_to(tag, x1[e]);
          x2[e] = aeqt::round_to(tag, x2[e]);
        }
        float y1[4], y2[4];
        if (head < ep.NQ + ep.NK) {
          const float4 cv = *reinterpret_cast<const float4*>(
              ep.cos + (size_t)r * half + e0);
          const float4 sv = *reinterpret_cast<const float4*>(
              ep.sin + (size_t)r * half + e0);
          const float cs[4] = {cv.x, cv.y, cv.z, cv.w};
          const float sn[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            y1[e] = x1[e] * cs[e] - x2[e] * sn[e];
            y2[e] = x2[e] * cs[e] + x1[e] * sn[e];
          }
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            y1[e] = x1[e];
            y2[e] = x2[e];
          }
        }
        TOut* dst = out;  // q, k or v and the head's index there
        int heads = ep.NQ, at = head;
        if (head >= ep.NQ + ep.NK) {
          dst = static_cast<TOut*>(ep.v);
          heads = ep.NK;
          at = head - ep.NQ - ep.NK;
        } else if (head >= ep.NQ) {
          dst = static_cast<TOut*>(ep.k);
          heads = ep.NK;
          at = head - ep.NQ;
        }
        TOut* p = dst + ((size_t)r * heads + at) * H + e0;
        tc::store4(p, y1);
        tc::store4(p + half, y2);
      } else {
        // The QKV: head `head`, elements e0 .. e0 + 3 of its first half.
        const int H = ep.H, half = H / 2, head = pr.x / H;
        const int e0 = pr.x % H + 4 * l;
        float y1[4], y2[4];  // rotated (a query head, K) or not (V)
        if (head <= ep.NQ) {
          const float4 cv = *reinterpret_cast<const float4*>(
              ep.cos + (size_t)r * half + e0);
          const float4 sv = *reinterpret_cast<const float4*>(
              ep.sin + (size_t)r * half + e0);
          const float cs[4] = {cv.x, cv.y, cv.z, cv.w};
          const float sn[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            y1[e] = x1[e] * cs[e] - x2[e] * sn[e];
            y2[e] = x2[e] * cs[e] + x1[e] * sn[e];
          }
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            y1[e] = x1[e];
            y2[e] = x2[e];
          }
        }
        if (head < ep.NQ) {
          float* qr = ep.q + ((size_t)r * ep.NQ + head) * H + e0;
          tc::store4(qr, y1);
          tc::store4(qr + half, y2);
        } else {  // K or V: the new row's codes
          const float inv = head == ep.NQ ? ep.kq_inv : ep.vq_inv;
          int8_t* dst = (head == ep.NQ ? ep.k_new : ep.v_new) + (size_t)r * H;
          uint32_t lo = 0, hi = 0;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            lo |= (uint32_t)(uint8_t)row_code(y1[e] * inv) << (8 * e);
            hi |= (uint32_t)(uint8_t)row_code(y2[e] * inv) << (8 * e);
          }
          *reinterpret_cast<uint32_t*>(dst + e0) = lo;
          *reinterpret_cast<uint32_t*>(dst + e0 + half) = hi;
        }
      }
    }
  }
}

// Launch 3: one block a (row m, group t): h[m, t*bf .. +bf] -> hq, hs[m, t].
__global__ void __launch_bounds__(kHQuantThreads)
hquant_kernel(const float* __restrict__ h, int8_t* __restrict__ hq,
              float* __restrict__ hs, int F, int bf) {
  extern __shared__ float4 hbuf[];  // [bf / 4]
  __shared__ float wmax[kHQuantThreads / 32];
  // Launch 4 may start now: it waits for this grid before reading hq, hs.
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const size_t m = blockIdx.x;
  const int t = blockIdx.y;
  const size_t at = m * F + (size_t)t * bf;
  const float4* src = reinterpret_cast<const float4*>(h + at);
  float amax = 0.0f;
  for (int v = threadIdx.x; v < bf / 4; v += kHQuantThreads) {
    const float4 x = src[v];
    hbuf[v] = x;
    amax = fmaxf(fmaxf(amax, fabsf(x.x)), fabsf(x.y));
    amax = fmaxf(fmaxf(amax, fabsf(x.z)), fabsf(x.w));
  }
  amax = aeqt::warp_max(amax);
  if ((threadIdx.x & 31) == 0) wmax[threadIdx.x >> 5] = amax;
  __syncthreads();
  float bmax = wmax[0];
#pragma unroll
  for (int w = 1; w < kHQuantThreads / 32; ++w) bmax = fmaxf(bmax, wmax[w]);
  const float s = fmaxf(bmax, 1e-9f) * aeqt::kInv127;
  const float inv = 1.0f / s;
  uint32_t* dst = reinterpret_cast<uint32_t*>(hq + at);
  for (int v = threadIdx.x; v < bf / 4; v += kHQuantThreads) {
    const float4 x = hbuf[v];
    const float f[4] = {x.x, x.y, x.z, x.w};
    uint32_t q = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      q |= (uint32_t)(uint8_t)(int8_t)__float2int_rn(f[e] * inv) << (8 * e);
    dst[v] = q;
  }
  if (threadIdx.x == 0) hs[m * (F / bf) + t] = s;
}

// Launch 3 on the stream.
inline int launch_hquant(const float* h, int8_t* hq, float* hs, int M, int F,
                         int bf, cudaStream_t stream) {
  const size_t smem = (size_t)bf * sizeof(float);
  const int err = (int)cudaFuncSetAttribute(
      hquant_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != 0) return err;
  hquant_kernel<<<dim3(M, F / bf), kHQuantThreads, smem, stream>>>(h, hq, hs,
                                                                  F, bf);
  return (int)cudaGetLastError();
}

// The down's chain: where its tiles leave SMs idle, the F-groups of a tile
// go round-robin to `chain` blocks of a cluster (group g to block g %
// chain): the most blocks, at most kMaxChain and the groups, whose
// clusters of all tiles the device holds at once (the occupancy query; a
// cluster lies in one GPC, so 16 tiles take 8 blocks only where 16
// clusters of 8 fit), kept per shape of the launch.
template <typename TOut>
Gemm down_plan(int M, int D, int F, int bf) {
  const int wgs = M <= kDownOneWgRows ? 1 : 2;
  const int m_tiles = (M + tc::kWgRows * wgs - 1) / (tc::kWgRows * wgs);
  const int n_tiles = (D + tc::kBN - 1) / tc::kBN;
  const int tiles = m_tiles * n_tiles;
  int chain = std::max(
      1, std::min({tc::sm_count() / tiles, kMaxChain, F / bf}));
  struct Known {
    int wgs, tiles, want, chain;
  };
  static Known known[16];
  static int n_known = 0;
  const int want = chain;
  for (int k = 0; k < n_known; ++k)
    if (known[k].wgs == wgs && known[k].tiles == tiles &&
        known[k].want == want)
      return size_gemm(M, wgs, n_tiles, F / 2 / tc::kBK, known[k].chain,
                       tc::kMaxStages, 2, wgs == 1);
  auto* kernel = mlp_tc_kernel<kDown, TOut>;
  for (; chain > 1; --chain) {
    const Gemm g = size_gemm(M, wgs, n_tiles, F / 2 / tc::kBK, chain,
                             tc::kMaxStages, 2, wgs == 1);
    if (cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)g.smem) != cudaSuccess)
      continue;
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(g.m_tiles, g.n_tiles, chain);
    config.blockDim = dim3(128 * wgs + 32);
    config.dynamicSmemBytes = g.smem;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = 1;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = chain;
    config.attrs = &attr;
    config.numAttrs = 1;
    int clusters = 0;
    if (cudaOccupancyMaxActiveClusters(&clusters, kernel, &config) ==
            cudaSuccess &&
        clusters >= tiles)
      break;
  }
  cudaGetLastError();  // a refused query leaves no error behind
  if (n_known < 16) known[n_known++] = {wgs, tiles, want, chain};
  return size_gemm(M, wgs, n_tiles, F / 2 / tc::kBK, chain, tc::kMaxStages,
                   2, wgs == 1);
}

// A contraction under plan g, a programmatic dependent launch (the down: a
// cluster of g.chain blocks a tile).
template <int kKind, typename TOut>
int launch_gemm(const Gemm& g, const void* a, int a_cols, const void* w,
                int w_cols, int w_rows, const float* row_s,
                const float* col_s, TOut* out, int M, int N, int D, int F,
                int bf, int act_silu, cudaStream_t stream,
                const BlockEpilogue& ep = BlockEpilogue{}) {
  CUtensorMap a_map, b_map;
  if (!tc::encode_2d(&a_map, a, (uint64_t)a_cols, (uint64_t)M,
                     (uint32_t)(tc::kWgRows * g.wgs)) ||
      !tc::encode_2d(&b_map, w, (uint64_t)w_cols, (uint64_t)w_rows,
                     (uint32_t)(kKind == kDown ? tc::kBN : kGateCols)))
    return tc::kTensorMapFailed;
  auto* kernel = mlp_tc_kernel<kKind, TOut>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)g.smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(g.m_tiles, g.n_tiles, g.chain);
  config.blockDim = dim3(128 * g.wgs + 32);
  config.dynamicSmemBytes = g.smem;
  config.stream = stream;
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[0].val.programmaticStreamSerializationAllowed = 1;
  attrs[1].id = cudaLaunchAttributeClusterDimension;
  attrs[1].val.clusterDim.x = 1;
  attrs[1].val.clusterDim.y = 1;
  attrs[1].val.clusterDim.z = g.chain;
  config.attrs = attrs;
  config.numAttrs = g.chain > 1 ? 2 : 1;
  return (int)cudaLaunchKernelEx(&config, kernel, a_map, b_map, row_s, col_s,
                                 out, M, N, D, F, bf, g.wgs, g.stages,
                                 g.unpack_buffers, g.overlap, act_silu, ep);
}

// A plan's six fields (kernels/mlp.py DRQ_PLAN_FIELDS, one contraction):
// grid x (row tiles), grid y (column tiles), grid z (the down's chain),
// threads, ring stages, dynamic shared memory.
inline void gemm_fields(const Gemm& g, long long* f) {
  f[0] = g.m_tiles;
  f[1] = g.n_tiles;
  f[2] = g.chain;
  f[3] = 128 * g.wgs + 32;
  f[4] = g.stages;
  f[5] = (long long)g.smem;
}

}  // namespace mlp
}  // namespace aeqt
