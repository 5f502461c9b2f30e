// Prefill-shaped attention over an int8 KV cache with an additive mask:
// an online softmax over S tiles, on Hopper's bf16 and fp16 tensor cores.
//
// Replaces: ai_edge_quantizer_tpu/kernels/pallas_attention.py
//   flash_attention_int8_masked (_flash_attn_kernel). For each (batch,
//   kv-head) row and query row r (R = G * T grouped query rows):
//     s[j]  = (q[r] . k[j] - zp_k * sum(q[r])) * k_scale_eff + mask[r, j]
//     m'    = max(m, max_j s[j]),  a = exp(m - m'),  p[j] = exp(s[j] - m')
//     l     = a * l + sum_j p[j],  acc = acc * a + sum_j p[j] v[j]
//   over the S tiles in order from m = -1e30, l = 0, acc = 0; then
//     out[r] = (acc / max(l, 1e-30) - zp_v) * v_scale      (f32)
//   where k_scale_eff = k_scale / sqrt(H) is formed by the caller. No tile
//   is skipped: masked scores are -1e9 (not -inf), so a fully masked row
//   averages every row of V, as the TPU kernel's does. Keys past S (a
//   ragged last tile) score -1e30 and add exactly 0.
//
// Bound on the H100: at the server's prefill (B = 8, NK = 1, R = 1024, S =
//   1024, H = 256) the bytes (q bf16, K and V int8, the f32 mask [B, R, S]
//   -- 32 MiB of the 44 -- and the f32 output) take about 14 us at 3.35
//   TB/s; the TPU kernel's 4 * R * S * H operations per row, 8.6 GFLOP,
//   take 8.7 us at the 989 TFLOP/s bf16 peak: the bound is bytes.
//
// Exact operands on the tensor cores. K and V hold int8 values, exact in
//   bf16 and fp16; every product below is exact in f32 and the sums are
//   f32, so only the order of the sums differs from the plain version.
//   * Scores: q . k by wgmma m64n64k16 bf16 with f32 sums. A bf16 q is
//     one bf16 operand; an f32 q is split into kQPartsF32 bf16 parts whose
//     sum is q (q0 = bf16(q), q1 = bf16(q - q0), ...), one pass each.
//   * P . V: p in [0, 1] is f32. p * kPScale (2^15: exact, and parts stay
//     normal fp16 down to p = 2^-29) is split into kPParts fp16 parts (22
//     bits), one wgmma pass each; out divides acc by kPScale, exactly.
//   The CPU twin (tests/test_torch_port_flash_tc.py) holds this arithmetic
//   to 1e-5 * max(|y|, 1) of the plain version at the server's width and
//   shows that one part fewer, of either split, fails.
//
// Design: one block per (64 query rows, batch * kv-head row): one consumer
//   warpgroup and one producer warp. The producer keeps a ring of key tiles
//   in flight with TMA (cp.async.bulk.tensor.3d, an mbarrier per stage for
//   "full" and one for "empty"): the K and V tiles [64 keys, H] int8 and
//   the mask tile [64 rows, 64 keys] in the dtype it comes in (f32 or
//   bf16; boxes of 128 bytes with the 128-byte swizzle, so the consumers'
//   fragment reads do not conflict; the mask's rows mask_ld >= S elements
//   apart, which the wrapper pads to whole 16-byte units). TMA fills keys
//   past S and rows past R with zeros. The consumers
//   1. once: read their q rows (f32 or bf16), form sum(q) in f32 and the
//      bf16 parts into 128-byte-swizzled K-major sub-tiles of 64 columns;
//   2. per tile: widen K to bf16 and V to fp16 in shared memory, into the
//      same swizzled [64 keys, 64 columns] sub-tiles: K-major for K (the B
//      operand of the scores), MN-major for V (the B operand of P . V);
//   3. scores by wgmma (f32 in registers), the mask and scale added in the
//      plain version's order, the online softmax in registers (row max and
//      sum over the four lanes of a quad), O *= a;
//   4. p split into fp16 parts kept in registers as the A operand of the
//      P . V wgmma, accumulated into O: O = O * a + p . V. O [64, H] stays
//      in registers across all of S (128 f32 a thread at H 256).
//   Registers: O (128 f32 a thread at H 256), the scores (32) and the p
//   parts (16) fill the 255 a thread of a 160-thread block may hold
//   (chip_smoke.py logs ptxas' count and spills). Shared memory:
//   the q parts, the widened K and V tiles, and as many ring stages as fit
//   (2 at H 256 with bf16 q; 1 with f32 q). The grid is R / 64 row tiles
//   by B * NK rows (128 blocks at the server's shape, one an SM).
#include <cuda_fp16.h>

#include "drq_common.cuh"
#include "tc_ptx.cuh"

namespace {

using namespace aeqt::tc;

constexpr int kBR = 64;            // query rows of a block (wgmma m64)
constexpr int kBS = 64;            // keys of a tile (the scores' n64)
constexpr int kConsumers = 128;    // one warpgroup
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr int kMaxStages = 4;
constexpr int kSub = 64 * 128;     // a [64, 128-byte] swizzled sub-tile
constexpr int kQPartsF32 = 3;      // bf16 parts of an f32 q
constexpr int kPParts = 2;         // fp16 parts of p
constexpr float kPScale = 32768.0f;  // p's scale before the split: 2^15
constexpr float kNeg = -1e30f;
constexpr size_t kSmemBudget = 232448 - 1024;  // opt-in maximum less static

// Shared memory of a block, after 1024-byte alignment: the ring (each
// stage K [64, H] and V [64, H] int8, then the mask boxes), the q parts,
// the widened K and V tiles, sum(q).
template <int H, int QP, typename TM>
struct Layout {
  static constexpr int kSubs = H / 64;  // 64-column sub-tiles of a row
  static constexpr int kMaskBoxes = kBS * (int)sizeof(TM) / 128;
  static constexpr size_t kStage = 2 * (size_t)kBS * H + (size_t)kMaskBoxes * kSub;
  static constexpr size_t kQPart = (size_t)kSubs * kSub;
  static constexpr size_t kFixed = 1024 + QP * kQPart + 2 * kQPart + kBR * 4;
  static constexpr int kFit = (int)((kSmemBudget - kFixed) / kStage);
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr size_t kBytes = kFixed + kStages * kStage;
  static_assert(kStages >= 1, "one ring stage must fit");
};

// Byte offset of 16-byte chunk c of row r in a 128-byte-swizzled sub-tile.
__device__ __forceinline__ int swz(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// Two values as one bf16x2 or fp16x2 register (the first in the low half).
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16, float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack2(__half, float a, float b) {
  __half2 v = __floats2half2_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Sixteen int8 values widened, exactly, to sixteen T values (bf16 or
// fp16): two 16-byte vectors.
template <typename T>
__device__ __forceinline__ void widen16(const uint4& u, uint4& lo, uint4& hi) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = pack2(T(), (float)(int8_t)(w[i] & 0xFF),
                     (float)(int8_t)((w[i] >> 8) & 0xFF));
    o[2 * i + 1] = pack2(T(), (float)(int8_t)((w[i] >> 16) & 0xFF),
                         (float)(int8_t)(w[i] >> 24));
  }
  lo = make_uint4(o[0], o[1], o[2], o[3]);
  hi = make_uint4(o[4], o[5], o[6], o[7]);
}

// The int8 tile src [64 keys, H] (plain rows) -> T sub-tiles [H / 64][64
// keys, 64 columns], swizzled; each consumer thread widens H / 32 vectors.
template <typename T, int H>
__device__ __forceinline__ void widen_tile(const uint8_t* src, uint8_t* dst) {
  constexpr int kVecs = H / 16;  // 16-byte vectors of a key row
  for (int v = threadIdx.x; v < kBS * kVecs; v += kConsumers) {
    const int key = v / kVecs, c16 = v % kVecs;
    uint4 lo, hi;
    widen16<T>(reinterpret_cast<const uint4*>(src)[v], lo, hi);
    uint8_t* sub = dst + (c16 >> 2) * kSub;
    const int c = (c16 & 3) * 2;
    *reinterpret_cast<uint4*>(sub + swz(key, c)) = lo;
    *reinterpret_cast<uint4*>(sub + swz(key, c + 1)) = hi;
  }
}

// Eight values of q as floats.
__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// A mask value of the tile (row r of the block, key column col) from its
// swizzled 128-byte boxes, as f32.
__device__ __forceinline__ float2 mask2(const uint8_t* m, int r, int col,
                                        float) {
  const int byte = col * 4;
  const int at = (byte >> 7) * kSub + swz(r, (byte & 127) >> 4) + (byte & 15);
  return *reinterpret_cast<const float2*>(m + at);
}
__device__ __forceinline__ float2 mask2(const uint8_t* m, int r, int col,
                                        __nv_bfloat16) {
  const int byte = col * 2;
  const int at = (byte >> 7) * kSub + swz(r, (byte & 127) >> 4) + (byte & 15);
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(m + at));
}

// Keeps the compiler from moving register reads or writes across the
// asynchronous wgmma that owns them.
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma descriptor of an MN-major tile of 128-byte rows (64 fp16 of N)
// with the 128-byte swizzle, its 8-row (8 keys of K) atoms 1024 bytes
// apart. An n64 operand spans one atom along N, so the N stride is never
// used; both stride fields hold 1024.
__device__ __forceinline__ uint64_t sw128_desc_mn(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFFull) >> 4) | (64ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// d[64 x 64] (+)= A[64 x 16] . B[64 x 16]^T, bf16 x bf16 -> f32, both
// operands K-major in shared memory (128-byte swizzle); scale_d 0 writes d
// afresh. Register d[4j + 2h + e] of thread t (warp w = t / 32 of the
// warpgroup, g = lane / 4, q = lane % 4) holds row 16w + g + 8h, column
// 8j + 2q + e.
__device__ __forceinline__ void wgmma_bf16_ss(float (&d)[32], uint64_t desc_a,
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d[64 x 64] += A[64 x 16] . B[16 x 64], fp16 x fp16 -> f32: A from
// registers (a[0]: row g, columns 2q, 2q + 1; a[1]: row g + 8; a[2], a[3]:
// columns 8 further -- the layout of d above, so a tile of scores becomes
// an A operand in place), B MN-major in shared memory (imm-trans-b 1).
__device__ __forceinline__ void wgmma_f16_rs(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int H, int QP, typename TQ, typename TM>
__global__ void __launch_bounds__(kThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map,
                const __grid_constant__ CUtensorMap m_map,
                const TQ* __restrict__ q, float* __restrict__ out, int NK,
                int R, int S, int mask_nk, float k_scale_eff, float v_scale,
                float zp_k, float zp_v) {
  using L = Layout<H, QP, TM>;
  constexpr int kSubs = L::kSubs;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[kMaxStages];
  __shared__ __align__(8) uint64_t empty_bar[kMaxStages];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* ring = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  uint8_t* qs = ring + L::kStages * L::kStage;
  uint8_t* kw = qs + QP * L::kQPart;
  uint8_t* vw = kw + L::kQPart;
  float* qsum = reinterpret_cast<float*>(vw + L::kQPart);
  const int bn = blockIdx.y, b = bn / NK;
  const int r0 = blockIdx.x * kBR;
  const int tiles = (S + kBS - 1) / kBS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(&full_bar[s], 1);
      mbar_init(&empty_bar[s], kConsumers / 32);  // lane 0 of each warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // the producer warp: one thread loads
    if (lane == 0) {
      const int mz = mask_nk == 1 ? b : bn;
      for (int i = 0; i < tiles; ++i) {
        const int s = i % L::kStages;
        uint8_t* st = ring + s * L::kStage;
        if (i >= L::kStages)
          mbar_wait(&empty_bar[s], ((i / L::kStages) - 1) & 1);
        mbar_expect_tx(&full_bar[s], (uint32_t)L::kStage);
        tma_load_3d(st, &k_map, 0, i * kBS, bn, &full_bar[s]);
        tma_load_3d(st + kBS * H, &v_map, 0, i * kBS, bn, &full_bar[s]);
        for (int c = 0; c < L::kMaskBoxes; ++c)
          tma_load_3d(st + 2 * kBS * H + c * kSub, &m_map,
                      i * kBS + c * (128 / (int)sizeof(TM)), r0, mz,
                      &full_bar[s]);
      }
    }
    return;
  }

  // 1. The block's q rows: warp w takes rows 16w..16w+15 (its rows of the
  // accumulators), a lane 8 columns at a time; sum(q) in f32 and the bf16
  // parts, swizzled K-major (zeros past R).
  const TQ* qb = q + (size_t)bn * R * H;
  for (int i = 0; i < 16; ++i) {
    const int rr = 16 * warp + i;
    float part = 0.0f;
    for (int c8 = lane; c8 < H / 8; c8 += 32) {
      float f[8] = {};
      if (r0 + rr < R) load8(qb + (size_t)(r0 + rr) * H + 8 * c8, f);
#pragma unroll
      for (int e = 0; e < 8; ++e) part = part + f[e];
      uint8_t* at = qs + (c8 >> 3) * kSub + swz(rr, c8 & 7);
#pragma unroll
      for (int p = 0; p < QP; ++p) {
        uint32_t w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const __nv_bfloat16 lo = __float2bfloat16_rn(f[2 * e]);
          const __nv_bfloat16 hi = __float2bfloat16_rn(f[2 * e + 1]);
          f[2 * e] = f[2 * e] - __bfloat162float(lo);
          f[2 * e + 1] = f[2 * e + 1] - __bfloat162float(hi);
          __nv_bfloat162 v = __halves2bfloat162(lo, hi);
          w[e] = *reinterpret_cast<uint32_t*>(&v);
        }
        *reinterpret_cast<uint4*>(at + p * L::kQPart) =
            make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    part = aeqt::warp_sum(part);
    if (lane == 0) qsum[rr] = part;
  }
  __syncwarp();
  const int g = lane >> 2, qd = lane & 3;
  const float qsum_r[2] = {qsum[16 * warp + g], qsum[16 * warp + g + 8]};

  float o[kSubs][32];
#pragma unroll
  for (int c = 0; c < kSubs; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.0f;
  float m_run[2] = {kNeg, kNeg}, l_run[2] = {0.0f, 0.0f};

  for (int i = 0; i < tiles; ++i) {
    const int s = i % L::kStages;
    const uint8_t* st = ring + s * L::kStage;
    // Every warp's wgmma of the last tile has read kw and vw (and the q
    // parts are whole, at i = 0) before they are written.
    bar_sync(1, kConsumers);
    mbar_wait(&full_bar[s], (i / L::kStages) & 1);

    // 2. Widen K to bf16 and V to fp16, swizzled.
    widen_tile<__nv_bfloat16, H>(st, kw);
    widen_tile<__half, H>(st + kBS * H, vw);
    fence_proxy_async();
    bar_sync(1, kConsumers);

    // 3. Scores: sc = sum over the q parts of q_p . k, f32; the smallest
    // part first, so that fewer of the sum's steps round at its full size.
    float sc[32];
#pragma unroll
    for (int r = 0; r < 32; ++r) sc[r] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int pp = 0; pp < QP; ++pp)
#pragma unroll
      for (int kk = 0; kk < H / 16; ++kk) {
        const int p = QP - 1 - pp;
        const uint64_t da =
            sw128_desc(qs + p * L::kQPart + (kk >> 2) * kSub) + 2 * (kk & 3);
        const uint64_t db = sw128_desc(kw + (kk >> 2) * kSub) + 2 * (kk & 3);
        wgmma_bf16_ss(sc, da, db, pp | kk);
      }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // The plain version's order: (qk - zp_k * sum(q)) * scale + mask; keys
    // past S score -1e30.
    const uint8_t* mt = st + 2 * kBS * H;
    const int ns = S - i * kBS;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = 16 * warp + g + 8 * h, col = 8 * j + 2 * qd;
        const float2 mv = mask2(mt, rr, col, TM());
        const float mk[2] = {mv.x, mv.y};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * j + 2 * h + e];
          x = (x - zp_k * qsum_r[h]) * k_scale_eff + mk[e];
          if (col + e >= ns) x = kNeg;
        }
      }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty_bar[s]);  // this warp is done with it

    // Online softmax of the warp's rows g and g + 8 (a quad holds a row).
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * h], sc[4 * j + 2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[h], mx);
      alpha[h] = expf(m_run[h] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * j + 2 * h + e];
          x = expf(x - m_new);
          sum = sum + x;
        }
      sum = sum + __shfl_xor_sync(0xffffffffu, sum, 1);
      sum = sum + __shfl_xor_sync(0xffffffffu, sum, 2);
      l_run[h] = alpha[h] * l_run[h] + sum;
      m_run[h] = m_new;
    }

    // 4. p * 2^15 in kPParts fp16 parts, in the A layout of the P . V
    // wgmma: step t (keys 16t..16t+15) takes columns groups 2t and 2t + 1.
    uint32_t pa[kPParts][4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int idx = 4 * (2 * t + (r >> 1)) + 2 * (r & 1);
        float x0 = sc[idx] * kPScale, x1 = sc[idx + 1] * kPScale;
#pragma unroll
        for (int p = 0; p < kPParts; ++p) {
          const __half h0 = __float2half_rn(x0), h1 = __float2half_rn(x1);
          x0 = x0 - __half2float(h0);
          x1 = x1 - __half2float(h1);
          __half2 v = __halves2half2(h0, h1);
          pa[p][t][r] = *reinterpret_cast<uint32_t*>(&v);
        }
      }
    // O = O * a + p . V (the TPU kernel's order).
#pragma unroll
    for (int c = 0; c < kSubs; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          o[c][4 * j + 2 * h] = o[c][4 * j + 2 * h] * alpha[h];
          o[c][4 * j + 2 * h + 1] = o[c][4 * j + 2 * h + 1] * alpha[h];
        }
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < kSubs; ++c) {
      fence_regs(o[c]);
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int p = 0; p < kPParts; ++p)
          wgmma_f16_rs(o[c], pa[p][t],
                       sw128_desc_mn(vw + c * kSub + t * 2048));
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < kSubs; ++c) fence_regs(o[c]);
  }

  // out = (acc / max(l, 1e-30) - zp_v) * v_scale, acc = O / 2^15 exactly.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 16 * warp + g + 8 * h;
    if (r >= R) continue;
    const float denom = fmaxf(l_run[h], 1e-30f);
    float* orow = out + ((size_t)bn * R + r) * H;
#pragma unroll
    for (int c = 0; c < kSubs; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float2 y;
        y.x = (o[c][4 * j + 2 * h] * (1.0f / kPScale) / denom - zp_v) * v_scale;
        y.y = (o[c][4 * j + 2 * h + 1] * (1.0f / kPScale) / denom - zp_v) *
              v_scale;
        *reinterpret_cast<float2*>(orow + 64 * c + 8 * j + 2 * qd) = y;
      }
  }
}

// A 3D tensor map of a row-major array [d2, d1, d0] of `bytes`-wide
// elements, rows `pitch` >= d0 elements apart (pitch * bytes a multiple of
// 16), with [1, box1, box0] boxes, zero fill past every edge; the 128-byte
// swizzle where asked.
bool encode_3d(CUtensorMap* map, const void* base, int bytes, uint64_t d0,
               uint64_t pitch, uint64_t d1, uint64_t d2, uint32_t box0,
               uint32_t box1, bool swizzle) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const CUtensorMapDataType type =
      bytes == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                 : (bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_UINT16
                               : CU_TENSOR_MAP_DATA_TYPE_UINT32);
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {pitch * bytes, d1 * pitch * bytes};
  const cuuint32_t box[3] = {box0, box1, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, type, 3, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int H, int QP, typename TQ, typename TM>
int launch(const void* q, const void* k, const void* v, const void* mask,
           void* out, int BN, int NK, int R, int S, int mask_nk, int mask_ld,
           float k_scale_eff, float v_scale, float zp_k, float zp_v,
           cudaStream_t stream) {
  using L = Layout<H, QP, TM>;
  CUtensorMap k_map, v_map, m_map;
  const uint64_t mask_rows = (uint64_t)(BN / NK) * mask_nk;
  if (!encode_3d(&k_map, k, 1, H, H, S, BN, H, kBS, false) ||
      !encode_3d(&v_map, v, 1, H, H, S, BN, H, kBS, false) ||
      !encode_3d(&m_map, mask, sizeof(TM), S, mask_ld, R, mask_rows,
                 128 / sizeof(TM), kBR, true))
    return kTensorMapFailed;
  auto* kernel = flash_tc_kernel<H, QP, TQ, TM>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((R + kBR - 1) / kBR, BN);
  kernel<<<grid, kThreads, L::kBytes, stream>>>(
      k_map, v_map, m_map, static_cast<const TQ*>(q),
      static_cast<float*>(out), NK, R, S, mask_nk, k_scale_eff, v_scale,
      zp_k, zp_v);
  return (int)cudaGetLastError();
}

// Dispatch on q's dtype (bf16: one bf16 part; f32: kQPartsF32) and the
// mask's (f32 or bf16).
template <int H>
int launch_h(const void* q, int q_bf16, const void* k, const void* v,
             const void* mask, int mask_bf16, void* out, int BN, int NK,
             int R, int S, int mask_nk, int mask_ld, float ks, float vs,
             float zk, float zv, cudaStream_t st) {
  if (q_bf16 && mask_bf16)
    return launch<H, 1, __nv_bfloat16, __nv_bfloat16>(
        q, k, v, mask, out, BN, NK, R, S, mask_nk, mask_ld, ks, vs, zk, zv,
        st);
  if (q_bf16)
    return launch<H, 1, __nv_bfloat16, float>(q, k, v, mask, out, BN, NK, R,
                                              S, mask_nk, mask_ld, ks, vs, zk,
                                              zv, st);
  if (mask_bf16)
    return launch<H, kQPartsF32, float, __nv_bfloat16>(
        q, k, v, mask, out, BN, NK, R, S, mask_nk, mask_ld, ks, vs, zk, zv,
        st);
  return launch<H, kQPartsF32, float, float>(q, k, v, mask, out, BN, NK, R, S,
                                             mask_nk, mask_ld, ks, vs, zk, zv,
                                             st);
}

// The shapes the kernel takes: H 64, 128, 192 or 256; B * NK up to 65535.
bool takes(int BN, int NK, int R, int S, int H, int mask_nk) {
  const bool h_ok = H == 64 || H == 128 || H == 192 || H == 256;
  return h_ok && BN > 0 && BN <= 65535 && NK > 0 && BN % NK == 0 && R > 0 &&
         S > 0 && (mask_nk == 1 || mask_nk == NK);
}

template <int H, int QP, typename TM>
void plan_of(int R, int BN, long long* f) {
  f[0] = (R + kBR - 1) / kBR;
  f[1] = BN;
  f[2] = QP;
  f[3] = kThreads;
  f[4] = (long long)Layout<H, QP, TM>::kBytes;
  f[5] = Layout<H, QP, TM>::kStages;
}

template <int H>
void plan_h(int R, int BN, int q_bf16, int mask_bf16, long long* f) {
  if (q_bf16 && mask_bf16) plan_of<H, 1, __nv_bfloat16>(R, BN, f);
  else if (q_bf16) plan_of<H, 1, float>(R, BN, f);
  else if (mask_bf16) plan_of<H, kQPartsF32, __nv_bfloat16>(R, BN, f);
  else plan_of<H, kQPartsF32, float>(R, BN, f);
}

}  // namespace

// q [BN, R, H] f32 or bf16 (q_bf16), BN = B * NK; k, v int8 [BN, S, H];
// mask [B, mask_nk, R, S] f32 or bf16 (mask_bf16) with rows mask_ld >= S
// elements apart, mask_ld * its bytes a multiple of 16 (a tensor map's row
// pitch; the columns past S are not read), mask_nk 1 (broadcast over the
// kv heads) or NK; out f32 [BN, R, H]. Every pointer 16-byte aligned.
// Returns aeqt::kShapeRefused, before any launch, for a shape outside
// `takes` or another mask pitch.
extern "C" int aeqt_flash_attention_int8(
    const void* q, int q_bf16, const void* k, const void* v, const void* mask,
    int mask_bf16, int mask_ld, void* out, int BN, int NK, int R, int S,
    int H, int mask_nk, float k_scale_eff, float v_scale, float zp_k,
    float zp_v, void* stream) {
  if (!takes(BN, NK, R, S, H, mask_nk) || mask_ld < S ||
      (mask_ld * (mask_bf16 ? 2 : 4)) % 16 != 0)
    return aeqt::kShapeRefused;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto go = [&](auto fn) {
    return fn(q, q_bf16, k, v, mask, mask_bf16, out, BN, NK, R, S, mask_nk,
              mask_ld, k_scale_eff, v_scale, zp_k, zp_v, s);
  };
  switch (H) {
    case 64: return go(launch_h<64>);
    case 128: return go(launch_h<128>);
    case 192: return go(launch_h<192>);
    default: return go(launch_h<256>);
  }
}

// The launch aeqt_flash_attention_int8 gives this shape: grid x (row
// tiles), grid y (B * NK), q parts, threads, dynamic shared memory, ring
// stages; or kShapeRefused.
extern "C" int aeqt_flash_attention_int8_plan(int BN, int NK, int R, int S,
                                              int H, int mask_nk, int q_bf16,
                                              int mask_bf16,
                                              long long* fields) {
  if (!takes(BN, NK, R, S, H, mask_nk)) return aeqt::kShapeRefused;
  switch (H) {
    case 64: plan_h<64>(R, BN, q_bf16, mask_bf16, fields); break;
    case 128: plan_h<128>(R, BN, q_bf16, mask_bf16, fields); break;
    case 192: plan_h<192>(R, BN, q_bf16, mask_bf16, fields); break;
    default: plan_h<256>(R, BN, q_bf16, mask_bf16, fields); break;
  }
  return 0;
}
