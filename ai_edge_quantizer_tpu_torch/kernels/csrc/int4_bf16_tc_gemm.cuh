// Bf16 tensor-core core of the weight-only packed int4 matmuls (#12
// qmatmul_int4_weight_only.cu, #13 qmatmul_int4_blockwise.cu; the MLP's
// weight-only branch #3, mlp_int4_bf16.cu, policies GateUpScale and
// GroupSum; the norm-fused FC #14, qmatmul_int4_rmsnorm.cu,
// ChannelScaleAfterNorm; the attention epilogue's weight-only projection
// #19, attention_oproj.cu, ChannelScaleResidual; the attention prologue's
// weight-only QKV #20, qkv_rope.cu, QkvRopePairs) on Hopper:
//   y[M, N] = x[M, K] (bf16) . unpack(w[N, K/2])^T, f32 sums, one scale
//   policy, y stored as bf16.
// The weight is split-half packed: byte j of a row holds column j in its
// low nibble and column K/2 + j in its high one. The weight-only int8
// matmul (#16, qmatmul_int_weights.cu) builds its own kernel of the same
// structure from this header's wgmma, barrier, fragment and tensor-map
// helpers.
//
// Scale policies (each its Pallas kernel's arithmetic, as the plain
// versions in kernels/packed_qmatmul.py state it):
//   ChannelScale (#12, _int4_channelwise_kernel): the low-nibble half
//     (x columns [0, K/2)) and the high-nibble half ([K/2, K)) sum into two
//     f32 accumulators; then acc = lo + hi, y = acc * s[n] (+ b[n]).
//   BlockScale (#13, _int4_blockwise_2d_kernel): byte block jb (bs bytes of
//     each row) holds K-block jb in its low nibbles and K-block nb/2 + jb in
//     its high ones; its lo and hi accumulators start at zero, and at its
//     end y += lo * s[n, jb] + hi * s[n, nb/2 + jb]; after the last block
//     the bias is added. The scales are never folded into the weights.
//   Each product and sum rounds on its own (the library is built with
//   --fmad=false). A bf16 value times an int4 value is exact in f32, so
//   only the order of the f32 sums differs from the plain versions.
//
// One launch a call: int4_bf16_tc_kernel computes the transposed tile
//   y^T[64 * WGS weight rows, NT tokens] a block, NT 64 or 128: the weight
//   rows are wgmma's M side (64 a consumer warpgroup), the tokens its N
//   side. One producer warp keeps a ring of stages in flight with TMA
//   (cp.async.bulk.tensor, an mbarrier per stage for "full" and one for
//   "empty"); a stage holds kStepBytes (64) packed bytes of K: the packed
//   weight tile [64 * WGS rows, 64 bytes] and the two x tiles it meets,
//   [NT, 64 bf16] at column kb and at K/2 + kb (one 128-byte swizzle row a
//   token). TMA fills rows past M and N with zeros, which add nothing; they
//   are never stored.
//   The packed weights never pass through shared memory as bf16: each
//   thread reads its rows' bytes of the packed tile and widens them in
//   registers into the A fragments of wgmma.mma_async m64nNTk16
//   f32.bf16.bf16 (A from registers, B = x from shared memory, K-major):
//   the nibble u goes to bf16 as 0x4300 | (u ^ 8), which is 136 + value,
//   less 136 (exact). The low nibbles contract against x lo into the lo
//   accumulator, the high ones against x hi into the hi one. A step's eight
//   wgmma run in one group; the warpgroup waits for it, then frees the
//   stage. The warpgroups of a block share the x tiles and nothing else (no
//   barrier between them in the main loop), and at decode two blocks share
//   an SM: one warpgroup's fragment building overlaps the other's wgmma.
//   The spin on a stage's barrier lives inside one asm block and the warp
//   index goes through a shuffle, so that the compiler sees no divergent
//   path around a wgmma (where it would serialize every wgmma). BlockScale
//   scales its accumulators into y at each byte block's end (every bs/64
//   steps); a thread's accumulators cover two weight rows, so its block
//   scales are four registers.
//
// Split-K: where the tiles leave SMs idle (decode), K splits over
//   gridDim.z in whole steps (BlockScale: whole byte blocks), and the
//   splits of a tile are one thread-block cluster (at most kMaxSplit
//   blocks). Each stages its f32 partial tiles, token-major, in its shared
//   memory (lo and hi for ChannelScale, y for BlockScale); after a cluster
//   barrier, block z sums its share of the tile's tokens over every split's
//   staged tiles in split order (distributed shared memory, mapa), runs the
//   epilogue and stores bf16. No global scratch; nothing carries over
//   between calls.
#pragma once

#include <algorithm>

#include "drq_common.cuh"
#include "tc_ptx.cuh"

namespace aeqt {
namespace w4 {

using namespace tc;

constexpr int kStepBytes = 64;   // packed bytes of K a stage (64 lo, 64 hi columns)
constexpr int kWgRows = 64;      // weight rows of one consumer warpgroup (m64)
constexpr int kMaxStages = 4;
constexpr int kMaxSplit = 8;     // blocks of a split tile: one cluster
constexpr int kMinSplitSteps = 2;  // K steps a split takes at least
constexpr int kNT1 = 64;         // tokens a tile at decode rows (M <= 64)
constexpr size_t kSmemBudget = 232448 - 1024;  // opt-in maximum less static
// Dynamic shared memory of a block where two share an SM (one warpgroup).
constexpr size_t kSmemHalf = 114688 - 1024;

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x NT] += A[64 x 16] . B[NT x 16]^T, bf16 x bf16 -> f32: A from
// registers (a[0]: row g, k 2q, 2q + 1; a[1]: row g + 8; a[2], a[3]: k 8
// further, of warp w's rows 16w .. 16w + 15), B K-major in shared memory
// (128-byte swizzle). Register d[4j + 2h + e] of thread t (warp w = t / 32
// of the warpgroup, g = lane / 4, q = lane % 4) holds row 16w + g + 8h,
// column 8j + 2q + e. With accumulate 0 the product replaces d (wgmma's
// scale-d predicate): a fresh sum needs no zeroing.
template <int NT>
__device__ __forceinline__ void wgmma_rs(float (&d)[NT / 2],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int accumulate = 1);

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db,
                                               int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// Four packed bytes as bf16 pairs: lo01 the low nibbles of bytes 0 and 1
// (byte 0 in the low half), lo23 of bytes 2 and 3; hi01, hi23 the high
// nibbles. A nibble u becomes the bf16 0x4300 | (u ^ 8) = 136 + value, less
// 136: exact.
__device__ __forceinline__ void widen_word(uint32_t w, uint32_t& lo01,
                                           uint32_t& lo23, uint32_t& hi01,
                                           uint32_t& hi23) {
  const uint32_t t01 = __byte_perm(w, 0, 0x4140);  // byte 0 | byte 1 << 16
  const uint32_t t23 = __byte_perm(w, 0, 0x4342);  // byte 2 | byte 3 << 16
  const __nv_bfloat162 bias = __floats2bfloat162_rn(136.0f, 136.0f);
  const uint32_t in[4] = {(t01 & 0x000F000Fu) ^ 0x43084308u,
                          (t23 & 0x000F000Fu) ^ 0x43084308u,
                          ((t01 >> 4) & 0x000F000Fu) ^ 0x43084308u,
                          ((t23 >> 4) & 0x000F000Fu) ^ 0x43084308u};
  uint32_t o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 r =
        __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&in[i]), bias);
    o[i] = *reinterpret_cast<const uint32_t*>(&r);
  }
  lo01 = o[0];
  lo23 = o[1];
  hi01 = o[2];
  hi23 = o[3];
}

// A thread's four bytes of a k16 window of one packed row (16 bytes, v):
// bytes 2q, 2q + 1 (k 2q, 2q + 1) and 2q + 8, 2q + 9 (k 2q + 8, 2q + 9).
__device__ __forceinline__ uint32_t window_bytes(const uint4& v, int q) {
  const uint32_t w0 = (q >> 1) ? v.y : v.x;  // bytes 4 (q / 2) ..
  const uint32_t w1 = (q >> 1) ? v.w : v.z;  // bytes 8 + 4 (q / 2) ..
  return __byte_perm(w0, w1, (q & 1) ? 0x7632 : 0x5410);
}

// The lo and hi A fragments of k16 window c of a stage, for the rows
// r (a[0], a[2]) and r + 8 (a[1], a[3]) of the packed tile (plain rows of
// `stride` bytes, kStepBytes unless a stage holds more).
__device__ __forceinline__ void a_frags(const uint8_t* packed, int r, int c,
                                        int q, uint32_t (&lo)[4],
                                        uint32_t (&hi)[4],
                                        int stride = kStepBytes) {
  const uint4 v0 =
      *reinterpret_cast<const uint4*>(packed + r * stride + 16 * c);
  const uint4 v1 =
      *reinterpret_cast<const uint4*>(packed + (r + 8) * stride + 16 * c);
  widen_word(window_bytes(v0, q), lo[0], lo[2], hi[0], hi[2]);
  widen_word(window_bytes(v1, q), lo[1], lo[3], hi[1], hi[3]);
}

// Two int8 bytes (bits 0-7 and 16-23 of t) as a bf16 pair, exactly:
// (0x4300 | low 7 bits) - (0x4300 | sign bit) is 128 + low7 - 128 (or 256).
// For the int8-weight kernels (#16 qmatmul_int_weights.cu, #4's
// weight-only head in head_argmax.cu).
__device__ __forceinline__ uint32_t widen_pair(uint32_t t) {
  const uint32_t a = (t & 0x007F007Fu) | 0x43004300u;
  const uint32_t b = (t & 0x00800080u) | 0x43004300u;
  const __nv_bfloat162 r =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a),
              *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// The A fragments of k16 window c of a stage of int8 weights for the rows
// r (a[0], a[2]) and r + 8 (a[1], a[3]) of the weight tile (plain rows of
// `stride` bytes, one K column a byte): bytes 2q, 2q + 1 (a[0]) and
// 2q + 8, 2q + 9 (a[2]) of the window.
__device__ __forceinline__ void a_frags_int8(const uint8_t* w, int r, int c,
                                             int q, uint32_t (&a)[4],
                                             int stride = kStepBytes) {
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const uint4 v = *reinterpret_cast<const uint4*>(
        w + (r + 8 * u) * stride + 16 * c);
    const uint32_t word = window_bytes(v, q);
    a[u] = widen_pair(__byte_perm(word, 0, 0x4140));
    a[2 + u] = widen_pair(__byte_perm(word, 0, 0x4342));
  }
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// ------------------------------------------------------------ policies

// #12: one scale per weight row; lo and hi staged apart.
struct ChannelScale {
  static constexpr bool kBlocks = false;
  static constexpr bool kGateUp = false;
  static constexpr bool kGrouped = false;
  // A programmatic dependent launch on the launch before it: the first
  // stages' weights load before griddepcontrol.wait, x after it.
  static constexpr bool kDependent = false;
  // y = bf16(bf16(acc * s) + res[m, n]): the residual added in the
  // epilogue to the output rounded first.
  static constexpr bool kResidual = false;
  static constexpr bool kRope = false;  // QkvRopePairs' pair tile and RoPE
  static constexpr int kEpiTiles = 2;  // lo and hi sums staged
  // Tokens a tile at two warpgroups (prefill rows). Two accumulators of
  // 128 and the A fragments crowd the 168 registers a thread of a
  // 288-thread block may hold, and ptxas serializes the wgmma; 128 still
  // measured faster than 64.
  static constexpr int kNT2 = 128;
};

// #13: one scale per weight row and block of bs K-columns; y staged.
struct BlockScale {
  static constexpr bool kBlocks = true;
  static constexpr bool kGateUp = false;
  static constexpr bool kGrouped = false;
  static constexpr bool kDependent = false;
  static constexpr bool kResidual = false;
  static constexpr bool kRope = false;
  static constexpr int kEpiTiles = 1;
  // 64: three accumulators (y, lo, hi) of 128 tokens would not fit the 168
  // registers a thread of a 288-thread block may hold.
  static constexpr int kNT2 = 64;
};

// #3's gate/up (mlp_int4_bf16.cu): N = 2F weight rows, gate rows then up
// rows. A block's weight tile holds gate rows f0 .. f0 + kRows/2 - 1 in its
// first half and up rows F + f0 .. in its second (two TMA boxes), so the
// epilogue finds gate and up of one column in its staged lo and hi tiles
// and stores h = bf16(act(gate) * up) [M, F], gate = (lo + hi) * s_g, up
// = (lo + hi) * s_u. The activation comes in `nb` (1: silu, else
// gelu-tanh). K never splits (make_plan): at F 16384 there are 512 tiles.
// ChannelScale's tiles: two warpgroups of 64 tokens at every M (half the
// x tiles' reads from L2 at decode) were no faster at decode and slower
// at M 256 and 1024 on the H100.
struct GateUpScale : ChannelScale {
  static constexpr bool kGateUp = true;
};

// #14 (qmatmul_int4_rmsnorm.cu): ChannelScale over the rows its norm
// launch writes, a programmatic dependent launch on it.
struct ChannelScaleAfterNorm : ChannelScale {
  static constexpr bool kDependent = true;
};

// #19's weight-only out projection (attention_oproj.cu): ChannelScale over
// the context rows its attention launch writes, a programmatic dependent
// launch on it, with the residual stream added in the epilogue.
struct ChannelScaleResidual : ChannelScale {
  static constexpr bool kDependent = true;
  static constexpr bool kResidual = true;
};

// #20's weight-only QKV with bf16 x (qkv_rope.cu): ChannelScale over the
// rows its norm launch writes (a programmatic dependent launch on it), in
// GateUpScale's pair tiles: a block's first kRows/2 weight rows are rows
// e0 .. of one head and its last kRows/2 rows e0 + H/2 .. (pair_rows, two
// TMA boxes), so that one epilogue item holds both halves x1 = y[e] and
// x2 = y[e + H/2] of a rotation. The epilogue: x = bf16((lo + hi) * s),
// then for the query and key heads the half-split RoPE in f32 (x1 c - x2
// s, x2 c + x1 s, each product and sum rounded on its own), q, k and v
// stored as bf16 (RopeOut). H % 128 == 0 (the caller's to check). K
// splits as ChannelScale's. Tokens a tile at two warpgroups: 64, where
// ChannelScale keeps 128 (whose two accumulators of 128 ptxas serializes,
// C7512): at #20's bench shape (M 256, N 2560) 0.023 ms against 0.038
// (kernel_study.py variants, 'pairs_nt128'; PERF.md §6).
struct QkvRopePairs : ChannelScale {
  static constexpr int kNT2 = 64;
  static constexpr bool kDependent = true;
  static constexpr bool kRope = true;
};

// QkvRopePairs' operands: cos and sin [M, H/2] f32; the outputs q [M, NQ
// H] (the kernel's `out`), k and v [M, NK H], bf16; NQ query and NK
// key/value heads of H.
struct RopeOut {
  const float* cos;
  const float* sin;
  void* k;
  void* v;
  int H, NQ, NK;
};

// #3's down (mlp_int4_bf16.cu): group-split packed weights (byte j of
// group g, bs = bf/2 bytes a group, holds column g*bf + j in its low
// nibble and g*bf + bf/2 + j in its high one): the x tiles of a step come
// from columns j0 + g*bf/2 and that + bf/2, and at each group's end y +=
// lo + hi (BlockScale's flush with unit scales: lo * 1 + hi * 1 is lo +
// hi), then y * s[n]. K splits in whole groups.
struct GroupSum {
  static constexpr bool kBlocks = true;
  static constexpr bool kGateUp = false;
  static constexpr bool kGrouped = true;
  static constexpr bool kDependent = true;  // on the gate/up
  static constexpr bool kResidual = false;
  static constexpr bool kRope = false;
  static constexpr int kEpiTiles = 1;
  static constexpr int kNT2 = 64;
};

// Shared-memory geometry of a launch: a ring stage (x lo, x hi, packed w)
// and the epilogue's staged f32 tiles, token-major, which reuse the ring
// once it is done.
template <class P, int NT, int WGS>
struct Geometry {
  static constexpr int kRows = kWgRows * WGS;  // weight rows a block
  static constexpr int kConsumers = 128 * WGS;
  static constexpr size_t kX = (size_t)NT * 128;  // one x half tile
  static constexpr size_t kStage = 2 * kX + (size_t)kRows * kStepBytes;
  // f32 rows of the staged tiles: the scalar writes of the accumulator
  // fragments are conflict-free (kEpiStride % 32 == 4).
  static constexpr int kEpiStride = kRows + 4;
  static constexpr size_t kEpiTile = (size_t)NT * kEpiStride * 4;
  static constexpr size_t kEpi = P::kEpiTiles * kEpiTile;
  // One warpgroup: two blocks an SM (registers within 204 a thread, shared
  // memory within half the SM's), so that one block's waits overlap the
  // other's work.
  static constexpr size_t kBudget = WGS == 1 ? kSmemHalf : kSmemBudget;
};

// The first weight rows of pair tile y's two halves (GateUpScale: gate
// rows and up rows; QkvRopePairs: rows e0 .. and e0 + H/2 .. of a head).
template <class P, int kRows>
__device__ __forceinline__ int2 pair_rows(int y, int N, int H) {
  constexpr int kHalf = kRows / 2;
  if constexpr (P::kRope) {
    const int per_head = H / kRows;
    const int r0 = (y / per_head) * H + (y % per_head) * kHalf;
    return make_int2(r0, r0 + H / 2);
  } else {
    return make_int2(y * kHalf, N / 2 + y * kHalf);
  }
}

// ------------------------------------------------------------ the kernel

template <class P, int NT, int WGS>
__global__ void __launch_bounds__(WGS * 128 + 32, WGS == 1 ? 2 : 1)
int4_bf16_tc_kernel(const __grid_constant__ CUtensorMap x_map,
                    const __grid_constant__ CUtensorMap w_map,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias,
                    const __nv_bfloat16* __restrict__ res,
                    __nv_bfloat16* __restrict__ out, int M, int N, int K,
                    int nb, int block_steps, int stages, int steps_per_split,
                    int steps, const RopeOut ro) {
  using G = Geometry<P, NT, WGS>;
  constexpr bool kPairs = P::kGateUp || P::kRope;
  constexpr int kConsumers = G::kConsumers;
  constexpr int kAcc = NT / 2;  // accumulator registers a thread
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[kMaxStages];
  __shared__ __align__(8) uint64_t empty_bar[kMaxStages];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* ring = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  // The warp index through a shuffle: uniform across the warp to the
  // compiler too, so that no wgmma sits on a path it takes for divergent.
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  const int lane = threadIdx.x & 31;
  const int m0 = blockIdx.x * NT, n0 = blockIdx.y * G::kRows;
  const int splits = gridDim.z;  // one cluster of `splits` blocks a tile
  const int first = blockIdx.z * steps_per_split;
  const int nk = min(steps, first + steps_per_split) - first;
  // kPairs: the first rows of the tile's two halves.
  int2 pr = make_int2(n0, 0);
  if constexpr (kPairs) pr = pair_rows<P, G::kRows>(blockIdx.y, N, ro.H);

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full_bar[s], 1);
      mbar_init(&empty_bar[s], kConsumers);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // The MLP's gate/up lets the down (its programmatic dependent launch)
  // start now; the down brings its first stages' weights, then waits for
  // the gate/up's h before any x tile.
  if constexpr (P::kGateUp)
    asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  if (warp == kConsumers / 32) {  // the producer warp: one thread loads
    if (lane == 0) {
      // The stage's weight tile: kPairs, the halves' rows pr.x .. and pr.y
      // .. into the tile's first and second kRows / 2 rows.
      auto load_w = [&](uint8_t* st, int step, uint64_t* bar) {
        const int j0 = step * kStepBytes;
        if constexpr (kPairs) {
          tma_load_2d(st + 2 * G::kX, &w_map, j0, pr.x, bar);
          tma_load_2d(st + 2 * G::kX + (G::kRows / 2) * kStepBytes, &w_map,
                      j0, pr.y, bar);
        } else {
          tma_load_2d(st + 2 * G::kX, &w_map, j0, n0, bar);
        }
      };
      int early = 0;  // kDependent: stages whose weights are loaded already
      if constexpr (P::kDependent) {
        early = min(nk, stages);
        for (int i = 0; i < early; ++i) {
          uint8_t* st = ring + (size_t)i * G::kStage;
          mbar_expect_tx(&full_bar[i], (uint32_t)G::kStage);
          load_w(st, first + i, &full_bar[i]);
        }
        griddep_wait();
      }
      for (int i = 0; i < nk; ++i) {
        const int s = i % stages;
        uint8_t* st = ring + (size_t)s * G::kStage;
        if (i >= stages) mbar_wait(&empty_bar[s], ((i / stages) - 1) & 1);
        if (i >= early) mbar_expect_tx(&full_bar[s], (uint32_t)G::kStage);
        const int j0 = (first + i) * kStepBytes;
        int x_lo = j0, x_hi = K / 2 + j0;
        if constexpr (P::kGrouped) {  // the step's group g: j0 + g * bf/2
          x_lo = j0 + ((first + i) / block_steps) * block_steps * kStepBytes;
          x_hi = x_lo + block_steps * kStepBytes;
        }
        tma_load_2d(st, &x_map, x_lo, m0, &full_bar[s]);
        tma_load_2d(st + G::kX, &x_map, x_hi, m0, &full_bar[s]);
        if (i >= early) load_w(st, first + i, &full_bar[s]);
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
  float lo[kAcc], hi[kAcc], y[P::kBlocks ? kAcc : 1];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) lo[i] = hi[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < (P::kBlocks ? kAcc : 1); ++i) y[i] = 0.0f;
  // BlockScale: the current byte block's scales of the thread's two weight
  // rows (s[n, jb] and s[n, nb/2 + jb] for rows row, row + 8).
  // GroupSum: unit scales.
  float slo[2] = {P::kGrouped ? 1.0f : 0.0f, P::kGrouped ? 1.0f : 0.0f};
  float shi[2] = {P::kGrouped ? 1.0f : 0.0f, P::kGrouped ? 1.0f : 0.0f};
  // The epilogue's scales and biases of the thread's four weight rows
  // (kConsumers is a multiple of kGroups: the same rows in every item),
  // loaded now so that their latency hides behind the main loop.
  constexpr int kGroups = G::kRows / 4;  // 4 weight rows an item
  const int c4 = (threadIdx.x % kGroups) * 4, c = n0 + c4;
  // kPairs: sc the first half's scales (gate), bi the second's (up) of
  // the thread's four pair columns (kConsumers is a multiple of kGroups /
  // 2).
  float sc[4], bi[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if constexpr (kPairs) {
      const int f = (threadIdx.x % (kGroups / 2)) * 4 + e;
      sc[e] = __ldg(scale + min(pr.x + f, N - 1));
      bi[e] = __ldg(scale + min(pr.y + f, N - 1));
    } else {
      const int cc = min(c + e, N - 1);  // clamped: loads need no guard
      sc[e] = P::kBlocks && !P::kGrouped ? 1.0f : __ldg(scale + cc);
      bi[e] = bias != nullptr ? __ldg(bias + cc) : 0.0f;
    }
  }

  for (int i = 0; i < nk; ++i) {
    const int s = i % stages;
    const int step = first + i;
    const uint8_t* st = ring + (size_t)s * G::kStage;
    if constexpr (P::kBlocks && !P::kGrouped) {
      if (step % block_steps == 0) {  // loads that the block's end reads
        const int jb = step / block_steps;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const size_t at = (size_t)min(n0 + row + 8 * u, N - 1) * nb + jb;
          slo[u] = __ldg(scale + at);
          shi[u] = __ldg(scale + at + nb / 2);
        }
      }
    }
    wait_parity(&full_bar[s], (i / stages) & 1);
    uint32_t alo[4][4], ahi[4][4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      a_frags(st + 2 * G::kX, row, c, q, alo[c], ahi[c]);
    const uint64_t dlo = sw128_desc(st), dhi = sw128_desc(st + G::kX);
    wgmma_fence();
    fence_acc(lo);
    fence_acc(hi);
#pragma unroll
    for (int c = 0; c < 4; ++c) {  // + 32 bytes of K a window
      wgmma_rs<NT>(lo, alo[c], dlo + 2 * c);
      wgmma_rs<NT>(hi, ahi[c], dhi + 2 * c);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(lo);
    fence_acc(hi);
    // Every consumer thread arrives: no branch on the lane near a wgmma.
    mbar_arrive(&empty_bar[s]);
    if constexpr (P::kBlocks) {
      if ((step + 1) % block_steps == 0) {
        // y += lo * s[n, jb] + hi * s[n, nb/2 + jb]
#pragma unroll
        for (int r = 0; r < kAcc; ++r) {
          const int u = (r >> 1) & 1;
          const float acc = lo[r] * slo[u] + hi[r] * shi[u];
          y[r] = y[r] + acc;
          lo[r] = 0.0f;
          hi[r] = 0.0f;
        }
      }
    }
  }

  // The epilogue through shared memory (every stage was consumed and every
  // warpgroup's wgmma is done once all pass the barrier): the staged f32
  // tiles [kEpiTiles][NT tokens][kEpiStride].
  float* tile = reinterpret_cast<float*>(ring);
  constexpr int S = G::kEpiStride;
  bar_sync(1, kConsumers);
#pragma unroll
  for (int r = 0; r < kAcc; ++r) {
    const int tok = 8 * (r >> 2) + 2 * q + (r & 1);
    const int at = tok * S + row + 8 * ((r >> 1) & 1);
    if constexpr (P::kBlocks) {
      tile[at] = y[r];
    } else {
      tile[at] = lo[r];
      tile[G::kEpiTile / 4 + at] = hi[r];
    }
  }
  // Split-K: block z takes tokens [z * per, (z + 1) * per) of the tile and
  // sums them over every split's staged tiles, in split order.
  int tok_begin = 0, tok_end = NT;
  if (splits > 1) {
    cluster_sync();  // every split's partial tiles are staged
    const int per = (NT + splits - 1) / splits;
    tok_begin = min(NT, (int)blockIdx.z * per);
    tok_end = min(NT, tok_begin + per);
  } else {
    bar_sync(1, kConsumers);
  }
  if constexpr (P::kGateUp) {  // one block a tile (no split)
    constexpr int kHalf = G::kRows / 2, kItems = kHalf / 4;
    const int F = N / 2;
    const int f4 = (threadIdx.x % kItems) * 4, f = n0 / 2 + f4;
    for (int it = threadIdx.x; it < NT * kItems; it += kConsumers) {
      const int tt = it / kItems, m = m0 + tt;
      if (m >= M || f >= F) continue;  // F % 4 == 0: f < F covers f + 3
      const float* lo_t = tile + tt * S;
      const float* hi_t = lo_t + G::kEpiTile / 4;
      const float4 gl = *reinterpret_cast<const float4*>(lo_t + f4);
      const float4 gh = *reinterpret_cast<const float4*>(hi_t + f4);
      const float4 ul = *reinterpret_cast<const float4*>(lo_t + kHalf + f4);
      const float4 uh = *reinterpret_cast<const float4*>(hi_t + kHalf + f4);
      const float g0[4] = {gl.x, gl.y, gl.z, gl.w};
      const float g1[4] = {gh.x, gh.y, gh.z, gh.w};
      const float u0[4] = {ul.x, ul.y, ul.z, ul.w};
      const float u1[4] = {uh.x, uh.y, uh.z, uh.w};
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float gate = (g0[e] + g1[e]) * sc[e];
        const float up = (u0[e] + u1[e]) * bi[e];
        v[e] = (nb == 1 ? silu(gate) : gelu_tanh(gate)) * up;
      }
      const __nv_bfloat162 v01 = __floats2bfloat162_rn(v[0], v[1]);
      const __nv_bfloat162 v23 = __floats2bfloat162_rn(v[2], v[3]);
      uint2 pk;
      pk.x = *reinterpret_cast<const uint32_t*>(&v01);
      pk.y = *reinterpret_cast<const uint32_t*>(&v23);
      *reinterpret_cast<uint2*>(out + (size_t)m * F + f) = pk;
    }
    return;
  } else if constexpr (P::kRope) {
    // Item: a token and four columns of the pair (rows pr.x + f4 .. of
    // the first half, pr.y + f4 .. of the second).
    constexpr int kHalf = G::kRows / 2, kItems = kHalf / 4;
    const int f4 = (threadIdx.x % kItems) * 4;
    const int H = ro.H, half = H / 2, head = pr.x / H, e0 = pr.x % H + f4;
    __nv_bfloat16* dst = out;  // q, k or v and the head's index there
    int heads = ro.NQ, at_head = head;
    if (head >= ro.NQ + ro.NK) {
      dst = static_cast<__nv_bfloat16*>(ro.v);
      heads = ro.NK;
      at_head = head - ro.NQ - ro.NK;
    } else if (head >= ro.NQ) {
      dst = static_cast<__nv_bfloat16*>(ro.k);
      heads = ro.NK;
      at_head = head - ro.NQ;
    }
    for (int it = threadIdx.x; it < (tok_end - tok_begin) * kItems;
         it += kConsumers) {
      const int tt = tok_begin + it / kItems;
      float4 t[4];  // lo and hi of the first half's columns, of the second's
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* at = tile + (e & 1) * (G::kEpiTile / 4) + tt * S +
                          (e >> 1) * kHalf + f4;
        if (splits == 1) {
          t[e] = *reinterpret_cast<const float4*>(at);
          continue;
        }
        float4 part[kMaxSplit];  // every split's partial, added in order
#pragma unroll
        for (int z = 0; z < kMaxSplit; ++z)
          if (z < splits)
            part[z] = *reinterpret_cast<const float4*>(cluster_map(at, z));
        t[e] = part[0];
#pragma unroll
        for (int z = 1; z < kMaxSplit; ++z)
          if (z < splits) t[e] = add4(t[e], part[z]);
      }
      const int m = m0 + tt;
      if (m >= M) continue;
      const float* lo1 = reinterpret_cast<const float*>(&t[0]);
      const float* hi1 = reinterpret_cast<const float*>(&t[1]);
      const float* lo2 = reinterpret_cast<const float*>(&t[2]);
      const float* hi2 = reinterpret_cast<const float*>(&t[3]);
      float y1[4], y2[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // the projection, rounded to bf16
        const float a1 = lo1[e] + hi1[e], a2 = lo2[e] + hi2[e];
        y1[e] = __bfloat162float(__float2bfloat16_rn(a1 * sc[e]));
        y2[e] = __bfloat162float(__float2bfloat16_rn(a2 * bi[e]));
      }
      if (head < ro.NQ + ro.NK) {  // a query or key head: rotated
        const float4 cv =
            *reinterpret_cast<const float4*>(ro.cos + (size_t)m * half + e0);
        const float4 sv =
            *reinterpret_cast<const float4*>(ro.sin + (size_t)m * half + e0);
        const float cs[4] = {cv.x, cv.y, cv.z, cv.w};
        const float sn[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x1 = y1[e], x2 = y2[e];
          y1[e] = x1 * cs[e] - x2 * sn[e];
          y2[e] = x2 * cs[e] + x1 * sn[e];
        }
      }
      __nv_bfloat16* p = dst + ((size_t)m * heads + at_head) * H + e0;
      const float* ys[2] = {y1, y2};
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const __nv_bfloat162 v01 = __floats2bfloat162_rn(ys[u][0], ys[u][1]);
        const __nv_bfloat162 v23 = __floats2bfloat162_rn(ys[u][2], ys[u][3]);
        uint2 pk;
        pk.x = *reinterpret_cast<const uint32_t*>(&v01);
        pk.y = *reinterpret_cast<const uint32_t*>(&v23);
        *reinterpret_cast<uint2*>(p + u * half) = pk;
      }
    }
  } else {
    for (int it = threadIdx.x; it < (tok_end - tok_begin) * kGroups;
         it += kConsumers) {
      const int tt = tok_begin + it / kGroups;
      float4 t[P::kEpiTiles];
#pragma unroll
      for (int e = 0; e < P::kEpiTiles; ++e) {
        const float* at = tile + e * (G::kEpiTile / 4) + tt * S + c4;
        if (splits == 1) {
          t[e] = *reinterpret_cast<const float4*>(at);
          continue;
        }
        // Every split's partial in flight at once, then added in split order.
        float4 part[kMaxSplit];
#pragma unroll
        for (int z = 0; z < kMaxSplit; ++z)
          if (z < splits)
            part[z] = *reinterpret_cast<const float4*>(cluster_map(at, z));
        t[e] = part[0];
#pragma unroll
        for (int z = 1; z < kMaxSplit; ++z)
          if (z < splits) t[e] = add4(t[e], part[z]);
      }
      const int m = m0 + tt;
      if (m >= M || c >= N) continue;  // N % 4 == 0: c < N covers c + 3
      const float* t0 = reinterpret_cast<const float*>(&t[0]);
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (P::kGrouped) {
          v[e] = t0[e] * sc[e];
        } else if constexpr (P::kBlocks) {
          v[e] = t0[e];
        } else {
          const float acc = t0[e] + reinterpret_cast<const float*>(&t[1])[e];
          v[e] = acc * sc[e];
        }
        if (bias != nullptr) v[e] = v[e] + bi[e];
      }
      if constexpr (P::kResidual) {  // y = bf16(bf16(o) + res), 8-byte loads
        const uint2 rr =
            *reinterpret_cast<const uint2*>(res + (size_t)m * N + c);
        const float2 r01 =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&rr.x));
        const float2 r23 =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&rr.y));
        const float r[4] = {r01.x, r01.y, r23.x, r23.y};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[e] = __bfloat162float(__float2bfloat16_rn(v[e])) + r[e];
      }
      const __nv_bfloat162 v01 = __floats2bfloat162_rn(v[0], v[1]);
      const __nv_bfloat162 v23 = __floats2bfloat162_rn(v[2], v[3]);
      uint2 pk;
      pk.x = *reinterpret_cast<const uint32_t*>(&v01);
      pk.y = *reinterpret_cast<const uint32_t*>(&v23);
      *reinterpret_cast<uint2*>(out + (size_t)m * N + c) = pk;
    }
  }
  if (splits > 1) cluster_sync();  // no block leaves while others read it
}

// ------------------------------------------------------------------ host

// The shapes the core takes: N % 64 == 0, K % 128 == 0 (whole stages of 64
// packed bytes in each half); BlockScale also bs % 128 == 0 and K % (2 bs)
// == 0 (whole stages in a byte block; byte block jb pairs K-blocks jb and
// nb/2 + jb). N / 64 weight tiles must fit the grid's y dimension.
inline bool takes(int M, int N, int K, int bs) {
  const bool base = M > 0 && N > 0 && K > 0 && N % 64 == 0 && K % 128 == 0 &&
                    N / 64 <= 65535;
  return base && (bs == 0 || (bs > 0 && bs % 128 == 0 && K % (2 * bs) == 0));
}

// The launch a shape gets: consumer warpgroups, tokens a tile, grid, ring
// depth, split-K (a cluster of `split` blocks a tile) and shared memory.
struct Plan {
  int wgs, nt, m_tiles, n_tiles, split, steps_per_split, steps, stages,
      block_steps;
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

template <class P, int NT, int WGS>
inline void size_ring(Plan& p) {
  using G = Geometry<P, NT, WGS>;
  const size_t fit = (G::kBudget - 1024) / G::kStage;  // 4 or more
  p.stages = (int)std::min({(size_t)kMaxStages, (size_t)p.steps_per_split, fit});
  p.smem = 1024 + std::max((size_t)p.stages * G::kStage, G::kEpi);
}

// One consumer warpgroup (64 weight rows a block, kNT1 tokens, two blocks
// an SM) for M <= 64, else two (128 weight rows, P::kNT2 tokens). K splits
// only while the tiles leave SMs idle, into at most kMaxSplit blocks of at
// least kMinSplitSteps steps, in whole units (a step; for BlockScale a
// byte block of bs / 64 steps), every split the same number of units but
// the last.
template <class P>
inline Plan make_plan(int M, int N, int K, int bs) {
  Plan p;
  p.wgs = M <= kNT1 ? 1 : 2;
  p.nt = p.wgs == 1 ? kNT1 : P::kNT2;
  p.m_tiles = (M + p.nt - 1) / p.nt;
  p.n_tiles = (N + kWgRows * p.wgs - 1) / (kWgRows * p.wgs);
  p.steps = K / 2 / kStepBytes;
  p.block_steps = P::kBlocks ? bs / kStepBytes : 1;  // steps a byte block
  const int unit = p.block_steps;
  const int units = p.steps / unit;
  const int min_units = std::max(1, kMinSplitSteps / unit);
  const int tiles = p.m_tiles * p.n_tiles;
  // GroupSum at one warpgroup counts two blocks an SM.
  const int sms = (P::kGrouped && p.wgs == 1 ? 2 : 1) * sm_count();
  const int want = P::kGateUp ? 1 : std::max(
      1, std::min({units / min_units, sms / tiles, kMaxSplit}));
  const int per = (units + want - 1) / want;
  p.split = (units + per - 1) / per;
  p.steps_per_split = per * unit;
  if (p.wgs == 2) size_ring<P, P::kNT2, 2>(p);
  else size_ring<P, kNT1, 1>(p);
  return p;
}

// A 2D map of a row-major matrix [rows, cols] of `elem`-byte values (the
// row pitch cols * elem a multiple of 16, the base 16-byte aligned) with
// [box_rows, box_cols] boxes, zero fill past the edges, the 128-byte
// swizzle where asked.
inline bool encode_2d(CUtensorMap* map, const void* base, int elem,
                      uint64_t cols, uint64_t rows, uint32_t box_cols,
                      uint32_t box_rows, bool swizzle) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * elem};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map,
            elem == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                      : CU_TENSOR_MAP_DATA_TYPE_UINT8,
            2, const_cast<void*>(base), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <class P, int NT, int WGS>
int launch(const void* x, const void* w, const void* scale, const void* bias,
           const void* res, void* out, int M, int N, int K, int nb,
           const Plan& p, cudaStream_t stream, const RopeOut& ro) {
  using G = Geometry<P, NT, WGS>;
  CUtensorMap x_map, w_map;
  if (!encode_2d(&x_map, x, 2, (uint64_t)K, (uint64_t)M, 64, (uint32_t)NT,
                 true) ||
      !encode_2d(&w_map, w, 1, (uint64_t)(K / 2), (uint64_t)N, kStepBytes,
                 (uint32_t)(P::kGateUp || P::kRope ? G::kRows / 2 : G::kRows),
                 false))
    return kTensorMapFailed;
  auto* kernel = int4_bf16_tc_kernel<P, NT, WGS>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(p.m_tiles, p.n_tiles, p.split);
  config.blockDim = dim3(128 * WGS + 32);
  config.dynamicSmemBytes = p.smem;
  config.stream = stream;
  // kDependent (the MLP's down, #14's contraction, #19's projection): a
  // programmatic dependent launch on the launch before it.
  cudaLaunchAttribute attrs[2];
  int n_attrs = 0;
  if (p.split > 1) {
    attrs[n_attrs].id = cudaLaunchAttributeClusterDimension;
    attrs[n_attrs].val.clusterDim.x = 1;
    attrs[n_attrs].val.clusterDim.y = 1;
    attrs[n_attrs].val.clusterDim.z = p.split;
    ++n_attrs;
  }
  if (P::kDependent) {
    attrs[n_attrs].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attrs[n_attrs].val.programmaticStreamSerializationAllowed = 1;
    ++n_attrs;
  }
  config.attrs = attrs;
  config.numAttrs = n_attrs;
  return (int)cudaLaunchKernelEx(
      &config, kernel, x_map, w_map, static_cast<const float*>(scale),
      static_cast<const float*>(bias),
      static_cast<const __nv_bfloat16*>(res),
      static_cast<__nv_bfloat16*>(out), M, N, K, nb, p.block_steps, p.stages,
      p.steps_per_split, p.steps, ro);
}

// One call: x [M, K] bf16 (16-byte aligned), w [N, K/2] uint8 split-half
// packed (16-byte aligned), scale [N] (ChannelScale) or [N, K/bs]
// (BlockScale, bs > 0) f32, bias [N] f32 or null, out [M, N] bf16; res
// [M, N] bf16 (8-byte aligned) under kResidual, else unused; ro
// QkvRopePairs' operands (out its q), else unused. Shapes are the
// caller's to check first (takes).
// run_nb passes `nb` to the kernel as it is (GateUpScale's activation).
template <class P>
int run_nb(const void* x, const void* w, const void* scale, const void* bias,
           void* out, int M, int N, int K, int bs, int nb,
           cudaStream_t stream, const void* res = nullptr,
           const RopeOut& ro = RopeOut{}) {
  const Plan p = make_plan<P>(M, N, K, bs);
  if (p.wgs == 2)
    return launch<P, P::kNT2, 2>(x, w, scale, bias, res, out, M, N, K, nb, p,
                                 stream, ro);
  return launch<P, kNT1, 1>(x, w, scale, bias, res, out, M, N, K, nb, p,
                            stream, ro);
}

template <class P>
int run(const void* x, const void* w, const void* scale, const void* bias,
        void* out, int M, int N, int K, int bs, cudaStream_t stream,
        const void* res = nullptr, const RopeOut& ro = RopeOut{}) {
  return run_nb<P>(x, w, scale, bias, out, M, N, K, bs,
                   bs > 0 ? K / bs : 1, stream, res, ro);
}

// The plan as the Python wrapper reads it: grid x (token tiles), y (weight
// tiles), z (split), threads, dynamic shared memory, ring stages, tokens a
// tile.
template <class P>
void plan_fields(int M, int N, int K, int bs, long long* f) {
  const Plan p = make_plan<P>(M, N, K, bs);
  f[0] = p.m_tiles;
  f[1] = p.n_tiles;
  f[2] = p.split;
  f[3] = 128 * p.wgs + 32;
  f[4] = (long long)p.smem;
  f[5] = p.stages;
  f[6] = p.nt;
}

}  // namespace w4
}  // namespace aeqt
