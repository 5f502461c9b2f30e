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
//   the products sum in f32: a packed row's low-nibble and high-nibble
//   halves each in f32, then added (pallas_head.py:77-91). Each logit is
//   acc * s, rounded to the activation dtype, and compared as above.
//   Bound: the weight stream again (the packed head, 256128 x 1024 bytes =
//   262 MB, about 78 us; the bf16 work of M = 64 rows, 2*M*N*K = 67 GFLOP,
//   68 us at the bf16 tensor-core peak).
//   Design: a warp takes 16 rows x 64 vocab columns on tensor cores, the
//   weight-only matmul's tile (aeqt::wo_mma_tile, mma.sync with f32 sums,
//   qmatmul_int4_weight_only.cuh), rounds its logits, and reduces each
//   row's 64 to one (max, first index) pair by shuffles; then the
//   reduction launch of the DRQ branch.
#include <limits.h>

#include "int8_tc_gemm.cuh"
#include "qmatmul_int4_weight_only.cuh"

namespace {

namespace tc = aeqt::tc;

constexpr int kBN = aeqt::kMmaBN;   // vocab columns of a weight-only tile
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

// The weight-only branch's tiles: warp `tile` of the grid takes vocab
// columns [64 * tile, +64) of rows [16 * blockIdx.x, +16) and writes each
// row's best (logit, first index) to pmax/pidx [M, tiles].
template <bool kPacked>
__global__ void __launch_bounds__(aeqt::kMmaWarps * 32)
head_tiles_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                       const uint8_t* __restrict__ w,
                       const float* __restrict__ scale,
                       float* __restrict__ pmax, int* __restrict__ pidx,
                       int M, int N, int K, int true_n, int cast_bf16,
                       int tiles) {
  const int tile = blockIdx.y * aeqt::kMmaWarps + (threadIdx.x >> 5);
  const int n0 = tile * aeqt::kMmaBN;
  if (n0 >= N) return;  // warp-uniform; no block-wide barrier below
  const int m0 = blockIdx.x * aeqt::kMmaBM;
  float y[aeqt::kMmaNT][4];
  aeqt::wo_mma_tile<kPacked>(x, w, M, N, K, K, m0, n0, 0,
                             kPacked ? K / 2 : K, y);
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {  // rows gid and gid + 8
    float bv = -INFINITY;
    int bi = INT_MAX;
#pragma unroll
    for (int nt = 0; nt < aeqt::kMmaNT; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {  // columns rise with (nt, c)
        const int n = n0 + 8 * nt + 2 * tig + c;
        if (n >= N) continue;
        float v = y[nt][2 * half + c] * scale[n];
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
    const int m = m0 + gid + 8 * half;
    if (tig == 0 && m < M) {
      pmax[(size_t)m * tiles + tile] = bv;
      pidx[(size_t)m * tiles + tile] = bi;
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

// The weight-only branch (drq=False): x [M, K] bf16 (rounded by the
// caller); w, scale, pmax, pidx, ids as above; cast_bf16 rounds each logit
// to bf16. Takes K % 128 == 0 (packed) or K % 64 == 0 (int8), else
// kShapeRefused (nothing launched).
extern "C" int aeqt_head_argmax_bf16(const void* x, const void* w, int packed,
                                     const void* scale, void* pmax,
                                     void* pidx, void* ids, int M, int N,
                                     int K, int true_n, int cast_bf16,
                                     void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 ||
      K % (packed ? 2 * aeqt::kMmaChunk : aeqt::kMmaChunk) != 0)
    return aeqt::kShapeRefused;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (N + kBN - 1) / kBN;  // kBN == aeqt::kMmaBN
  const dim3 grid((M + aeqt::kMmaBM - 1) / aeqt::kMmaBM,
                  (tiles + aeqt::kMmaWarps - 1) / aeqt::kMmaWarps);
  auto* kernel = packed ? head_tiles_bf16_kernel<true>
                        : head_tiles_bf16_kernel<false>;
  kernel<<<grid, aeqt::kMmaWarps * 32, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(w),
      static_cast<const float*>(scale), static_cast<float*>(pmax),
      static_cast<int*>(pidx), M, N, K, true_n, cast_bf16, tiles);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  head_reduce_kernel<<<M, 256, 0, s>>>(static_cast<const float*>(pmax),
                                       static_cast<const int*>(pidx), tiles,
                                       static_cast<int*>(ids));
  return (int)cudaGetLastError();
}
