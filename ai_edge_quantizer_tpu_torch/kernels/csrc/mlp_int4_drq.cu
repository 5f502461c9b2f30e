// GeGLU MLP with packed int4 weights and DRQ activations:
//   y[M, D] = down(act(gate(x)) * up(x))
//
// Replaces: ai_edge_quantizer_tpu/kernels/pallas_mlp.py
//   mlp_pallas_int4_packed, DRQ branch (_mlp_drq_kernel).
//
// Arithmetic (the Pallas kernel's, pallas_mlp.py:93-146; the plain
//   version kernels/mlp.py mlp_int4_packed_plain), every product and sum
//   rounded on its own (--fmad=false):
//   1. x quantized per row: xs = max(absmax, 1e-9) * (1/127),
//      xq = rint(x * (1 / xs));
//   2. gate = (f32(xq . wg) * xs) * s_g, up = (f32(xq . wu) * xs) * s_u,
//      the int32 sums exact; h = act(gate) * up in f32 (gelu-tanh term by
//      term, or silu);
//   3. per (row, group t of bf columns): hs = max(absmax(h), 1e-9) *
//      (1/127), hq = rint(h * (1 / hs));
//   4. per group in order, the exact int32 partial of hq against the
//      group's down weights, acc = acc + f32(part) * hs[row, t]; then
//      y = acc * s_d, stored in x's dtype.
//   The kernels compute this function bit for bit (up to the card's tanh
//   or exp): the int32 sums are exact in any order, every float operation
//   is the plain version's, and the group sum runs in group order in one
//   thread.
//
// Bound on the H100: at Gemma-2B (D 2048, F 16384) the 48 MiB of packed
//   weights (gate/up 32 MiB, down 16 MiB), about 15 us at 3.35 TB/s, up to
//   a few hundred rows; at a prefill pass (M 1024) the 3 * 2*M*F*D = 206 G
//   int8 operations, about 0.10 ms at the 1,979 TOP/s tensor-core peak.
//
// Design: four launches on the int8 tensor-core core's pieces
//   (int8_tc_gemm.cuh: its row quantize, wgmma m64n128k32 s8 tiles fed by
//   a TMA ring, the split-half unpack), each a programmatic dependent
//   launch where it can start before its predecessor ends:
//   1. the core's quantize_rows_kernel: xq [M, D] int8 and xs [M];
//   2. gate/up: one block a 64 x 64-column (or 128 x 64) tile of h. Its B
//      tile of a stage is the packed [128 rows, 128 bytes] of gate rows
//      f0 .. f0 + 63 and up rows F + f0 .. F + f0 + 63, two TMA boxes of
//      64 rows into the halves of one 128-row swizzled tile (the halves
//      start 1024-byte aligned, so the swizzle is the one a single box
//      gives). The accumulator's columns 0-63 are then gate and 64-127 up
//      of the same F columns, and the epilogue forms h = act(gate) * up
//      from the two halves of the staged int32 tile: gu [M, 2F] never
//      goes to memory, h [M, F] f32 does (the group's absmax spans bf
//      columns, more than a tile). At one warpgroup (M <= 64) a block
//      keeps two ring stages and one unpack buffer (99 KB), so two blocks
//      share an SM: the 256 tiles at decode run in one wave, one block's
//      unpack beside the other's wgmma. With one buffer, every warp's
//      wgmma of step i ends (a barrier) before step i + 1 unpacks into it.
//      D splits into no K slices.
//   3. hquant_kernel: one block a (row, group): the group's h read once
//      into shared memory, its absmax (a maximum: any order gives the
//      plain version's), hs and hq [M, F] int8.
//   4. down: the core's tile over hq [M, F] against the group-split down
//      weight [D, F/2] (pack_int4_split_grouped: byte j of group g holds
//      column g*bf + j in its low nibble and g*bf + bf/2 + j in its high
//      one). A stage's 128 packed bytes at P lie in one group (bf % 256 ==
//      0), so its lo codes are hq columns P + g*bf/2 .. + 127 and its hi
//      codes those + bf/2: only the A tiles' TMA coordinates differ from
//      the core's split-half loader, the unpack is the same. At the end of
//      each group (bf/256 stages) the int32 sums are flushed into an f32
//      accumulator with the group's hs (|part| <= bf * 127 * 8 < 2^24:
//      f32(part) is exact) and zeroed: R[g] = R[g - 1] + f32(part) * hs,
//      the plain version's association, which chip_smoke.py's fused-block
//      check holds bit for bit (the block's x_ffn against this kernel).
//      Where the tiles leave SMs idle (16 at decode, 64 at M 256), a
//      tile's groups go round-robin to the `chain` blocks of a cluster
//      (group g to block g % chain; as many blocks as the SMs take, at
//      most 8, and whose clusters all fit at once by the occupancy query:
//      6 at decode on the H100): each block forms f32(part) * hs of its
//      groups on its own, and R[g - 1] comes from the block before it in
//      the chain, each thread's 64 sums stored straight from its
//      registers into that block's inbox (st.async, completing on its
//      barrier); the block of the last group stores y = R * s_d. The
//      chain's hops are serial, one a group, so many small groups (bf
//      512) gain less than few large ones. At one warpgroup step i + 1's
//      tile unpacks while step i's wgmma run (two unpack buffers).
//   Both contractions unpack with the core's `unpack_split_tile`. No float
//   atomics and no global scratch beyond the caller's: h, xq and xs live in
//   the caller's gu buffer ([M, 2F] f32), hq and hs in its own.
//
// Shapes: D % 32 == 0, bf % 256 == 0 (a stage of the down lies in one
//   group; the TPU kernel's (d, bf/2) block needs bf/2 % 128 == 0 too),
//   bf <= 8192, F % bf == 0 and room for xq and xs beside h in gu; else
//   kShapeRefused.
#include "int8_tc_gemm.cuh"

namespace {

namespace tc = aeqt::tc;
using Loader = tc::SplitNibblesRecipB;

constexpr int kGateCols = 64;  // h columns a gate/up tile (64 gate, 64 up rows)
constexpr int kHQuantThreads = 256;
constexpr int kDownOneWgRows = 256;  // the down: 64-row tiles up to these rows
constexpr int kMaxChain = 8;         // blocks of a down tile's chain
// At one warpgroup the gate/up keeps two ring stages and one unpack
// buffer, so that two blocks share an SM (256 tiles at decode in one wave).
constexpr int kGateUpStages1 = 2;

// The launch of one of the two contractions: grid (m_tiles, n_tiles,
// chain). Unpack buffers: 2, alternating by step (two warpgroups, or one
// that overlaps: step i + 1's tile unpacks while step i's wgmma run, the
// down at one warpgroup), or 1 (the gate/up at one warpgroup, so that two
// blocks share an SM and overlap each other instead: 256 tiles at decode
// in one wave; a barrier after each step's wgmma lets the next unpack
// reuse the buffer). chain > 1 (the down): the blocks of a tile's
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

// The byte offsets of h, xq and xs in the caller's f32 scratch gu [M, 2F].
inline size_t xq_offset(int M, int F) { return (size_t)M * F * 4; }
inline size_t xs_offset(int M, int D, int F) {
  return xq_offset(M, F) + (((size_t)M * D + 15) & ~(size_t)15);
}

bool takes(int M, int D, int F, int bf) {
  return M > 0 && D > 0 && D % 32 == 0 && bf > 0 && bf % 256 == 0 &&
         F % bf == 0 && bf <= 8192 &&
         xs_offset(M, D, F) + (size_t)M * 4 <= (size_t)M * F * 8 &&
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

// Contraction 2 (kDown false) or 4 (kDown true); see the header.
//   gate/up: a_map xq [M, D], b_map wgu [2F, D/2] in boxes of 64 rows,
//     row_s xs [M], col_s s_gu [2F], out h [M, F] f32, N = F.
//   down: a_map hq [M, F], b_map wd [D, F/2] in boxes of 128 rows, row_s
//     hs [M, F/bf], col_s s_d [D], out y [M, D], N = D; a tile's groups
//     round-robin over the gridDim.z blocks of its cluster (the chain).
template <bool kDown, typename TOut>
__global__ void __launch_bounds__(2 * 128 + 32, 1)
mlp_tc_kernel(__grid_constant__ const CUtensorMap a_map,
              __grid_constant__ const CUtensorMap b_map,
              const float* __restrict__ row_s,
              const float* __restrict__ col_s, TOut* __restrict__ out,
              int M, int N, int D, int F, int bf, int wgs, int stages,
              int unpack_buffers, int overlap, int act_silu) {
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
  const int n0 = blockIdx.y * (kDown ? tc::kBN : kGateCols);
  // The down's groups and this block's share: groups z, z + chain, ...
  const int group_steps = kDown ? bf / 2 / tc::kBK : 1;  // stages a group
  const int groups = kDown ? F / bf : 1;
  const int chain = kDown ? (int)gridDim.z : 1, z = blockIdx.z;
  const int my_groups = kDown ? (groups - z + chain - 1) / chain : 1;
  const int nk = kDown ? my_groups * group_steps
                       : (D / 2 + tc::kBK - 1) / tc::kBK;
  auto step_of = [=](int i) {  // the K step of local step i
    return kDown ? (z + (i / group_steps) * chain) * group_steps +
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
        if constexpr (kDown) {
          tc::tma_load_2d(bt, bmap, step * tc::kBK, n0, bar);
        } else {  // gate rows into the tile's first half, up rows the second
          tc::tma_load_2d(bt, bmap, step * tc::kBK, n0, bar);
          tc::tma_load_2d(bt + kGateCols * tc::kBK, bmap, step * tc::kBK,
                          F + n0, bar);
        }
      };
      auto load_a = [=](uint8_t* st, uint64_t* bar, int step) {
        int lo = step * tc::kBK, hi = D / 2 + lo;  // gate/up: split-half rows
        if constexpr (kDown) {  // group-split: the stage's group g
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
  // Column scales are weights: loaded before the main loop. The gate/up
  // epilogue gives lane l (of a half-warp) columns 4l .. 4l + 3 of the
  // tile's 64, the down's lane l columns 4l .. 4l + 3 of its 128.
  const int c = n0 + 4 * (kDown ? lane : (lane & 15));
  float sc[4], su[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int cc = min(c + e, N - 1);  // clamped: loads need no guard
    sc[e] = col_s[cc];
    su[e] = kDown ? 0.0f : col_s[F + cc];
  }
  if constexpr (kDown) tc::griddep_wait();  // hs comes from launch 3

  int d[64];
  float acc[kDown ? 64 : 1];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0;
#pragma unroll
  for (int i = 0; i < (kDown ? 64 : 1); ++i) acc[i] = 0.0f;
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
    if constexpr (kDown) {
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
    if constexpr (kDown) {
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
  if (kDown && (groups - 1) % chain != z) {
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
        if constexpr (kDown)
          *reinterpret_cast<float2*>(reinterpret_cast<float*>(ring) + at) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        else
          *reinterpret_cast<int2*>(reinterpret_cast<int*>(ring) + at) =
              make_int2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
      }
  }
  if constexpr (kDown) {
    tc::bar_sync(1, consumers);
    const float* tile = reinterpret_cast<const float*>(ring);
    for (int rr = warp; rr < bm; rr += consumers / 32) {
      const int r = m0 + rr;
      if (r >= M || c >= N) continue;  // N % 4 == 0: c < N covers c + 3
      const float4 a =
          *reinterpret_cast<const float4*>(&tile[rr * S + 4 * lane]);
      const float y[4] = {a.x * sc[0], a.y * sc[1], a.z * sc[2], a.w * sc[3]};
      tc::store4(out + (size_t)r * N + c, y);
    }
    if (chain > 1) tc::cluster_sync();  // no block leaves while others store
  } else {
    // Gate columns 0-63 and up columns 64-127 of a row; a half-warp takes
    // a row, lane l its columns 4l .. 4l + 3 of both.
    float* row_scale = reinterpret_cast<float*>(ring) + bm * S;
    tc::griddep_wait();  // xs comes from launch 1
    if (threadIdx.x < bm)
      row_scale[threadIdx.x] = row_s[min(m0 + threadIdx.x, M - 1)];
    tc::bar_sync(1, consumers);
    const int* tile = reinterpret_cast<const int*>(ring);
    const int l = lane & 15;
    for (int rr = 2 * warp + (lane >> 4); rr < bm; rr += consumers / 16) {
      const int r = m0 + rr;
      if (r >= M || c >= N) continue;  // F % 4 == 0: c < F covers c + 3
      const int4 ag = *reinterpret_cast<const int4*>(&tile[rr * S + 4 * l]);
      const int4 au =
          *reinterpret_cast<const int4*>(&tile[rr * S + kGateCols + 4 * l]);
      const int g4[4] = {ag.x, ag.y, ag.z, ag.w};
      const int u4[4] = {au.x, au.y, au.z, au.w};
      const float xr = row_scale[rr];
      float hv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float gate = ((float)g4[e] * xr) * sc[e];
        const float up = ((float)u4[e] * xr) * su[e];
        const float a = act_silu ? aeqt::silu(gate) : aeqt::gelu_tanh(gate);
        hv[e] = a * up;
      }
      tc::store4(out + (size_t)r * N + c, hv);
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
  auto* kernel = mlp_tc_kernel<true, TOut>;
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

// Launch 2 or 4 under plan g, a programmatic dependent launch (the down: a
// cluster of g.chain blocks a tile).
template <bool kDown, typename TOut>
int launch_gemm(const Gemm& g, const void* a, int a_cols, const void* w,
                int w_cols, int w_rows, const float* row_s,
                const float* col_s, TOut* out, int M, int N, int D, int F,
                int bf, int act_silu, cudaStream_t stream) {
  CUtensorMap a_map, b_map;
  if (!tc::encode_2d(&a_map, a, (uint64_t)a_cols, (uint64_t)M,
                     (uint32_t)(tc::kWgRows * g.wgs)) ||
      !tc::encode_2d(&b_map, w, (uint64_t)w_cols, (uint64_t)w_rows,
                     (uint32_t)(kDown ? tc::kBN : kGateCols)))
    return tc::kTensorMapFailed;
  auto* kernel = mlp_tc_kernel<kDown, TOut>;
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
                                 g.unpack_buffers, g.overlap, act_silu);
}

template <typename TIn>
int launch_all(const void* x, const void* wgu, const void* sgu,
               const void* wd, const void* sd, void* gu, void* hq, void* hs,
               void* out, int M, int D, int F, int bf, int act_silu,
               cudaStream_t stream) {
  float* h = static_cast<float*>(gu);
  uint8_t* base = static_cast<uint8_t*>(gu);
  int8_t* xq = reinterpret_cast<int8_t*>(base + xq_offset(M, F));
  float* xs = reinterpret_cast<float*>(base + xs_offset(M, D, F));
  int err = tc::launch_quantize<Loader, TIn>(x, xq, xs, M, D, stream);
  if (err != 0) return err;
  err = launch_gemm<false, float>(
      gate_up_plan(M, D, F), xq, D, wgu, D / 2, 2 * F, xs,
      static_cast<const float*>(sgu), h, M, F, D, F, bf, act_silu, stream);
  if (err != 0) return err;
  const size_t smem = (size_t)bf * sizeof(float);
  err = (int)cudaFuncSetAttribute(
      hquant_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != 0) return err;
  hquant_kernel<<<dim3(M, F / bf), kHQuantThreads, smem, stream>>>(
      h, static_cast<int8_t*>(hq), static_cast<float*>(hs), F, bf);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  return launch_gemm<true, TIn>(
      down_plan<TIn>(M, D, F, bf), hq, F, wd, F / 2, D,
      static_cast<const float*>(hs), static_cast<const float*>(sd),
      static_cast<TIn*>(out), M, D, D, F, bf, act_silu, stream);
}

}  // namespace

// x [M, D] f32 or bf16 (x_bf16); wgu [2F, D/2] uint8 split-half packed;
// sgu [2F] f32; wd [D, F/2] uint8 group-split packed (group bf); sd [D] f32;
// scratch gu f32 [M, 2F] (h, xq and xs), hq int8 [M, F], hs f32 [M, F/bf];
// out [M, D] in x's dtype. Takes D % 32 == 0, bf % 256 == 0 (at most
// 8192), F % bf == 0; refuses any other shape with kShapeRefused before
// any launch.
extern "C" int aeqt_mlp_int4_drq(const void* x, int x_bf16, const void* wgu,
                                 const void* sgu, const void* wd,
                                 const void* sd, void* gu, void* hq, void* hs,
                                 void* out, int M, int D, int F, int bf,
                                 int act_silu, void* stream) {
  if (!takes(M, D, F, bf)) return aeqt::kShapeRefused;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return launch_all<__nv_bfloat16>(x, wgu, sgu, wd, sd, gu, hq, hs, out, M,
                                     D, F, bf, act_silu, s);
  return launch_all<float>(x, wgu, sgu, wd, sd, gu, hq, hs, out, M, D, F, bf,
                           act_silu, s);
}

// The two contractions' launches (kernels/mlp.py DRQ_PLAN_FIELDS): for
// gate/up, then down, grid x (row tiles), grid y (column tiles), grid z
// (the down's chain: blocks of a cluster), threads, ring stages and
// dynamic shared memory; or kShapeRefused.
extern "C" int aeqt_mlp_int4_drq_plan(int M, int D, int F, int bf,
                                      long long* fields) {
  if (!takes(M, D, F, bf)) return aeqt::kShapeRefused;
  const Gemm gs[2] = {gate_up_plan(M, D, F),
                      down_plan<__nv_bfloat16>(M, D, F, bf)};
  for (int i = 0; i < 2; ++i) {
    long long* f = fields + 6 * i;
    f[0] = gs[i].m_tiles;
    f[1] = gs[i].n_tiles;
    f[2] = gs[i].chain;
    f[3] = 128 * gs[i].wgs + 32;
    f[4] = gs[i].stages;
    f[5] = (long long)gs[i].smem;
  }
  return 0;
}
