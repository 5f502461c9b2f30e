// Decode attention over a quantized KV cache with the S cache rows of each
// (batch, kv-head) row split across a thread-block cluster, both
// contractions on the tensor cores (mma.sync): the body of the masked
// (attention_masked.cu, #17), the live-prefix (attention_dynlen.cu, #18),
// the lengths (attention_lengths.cu, #7), the stale-cache
// (attention_stale.cu, #2) and the splice-writeback (attention_writeback.cu,
// #8) kernels over int8 caches in every compute mode (`attend`), of the
// int4-group kernel
// (attention_int4_group.cu, #10) over packed int4 pools (`attend_int4g`)
// and of the per-row int4 kernel (attention_int4_row.cu, #21,
// `attend_int4r`).
//
// Bound on the H100: the cache bytes. At Gemma-2B's decode (one KV head,
// G = 8 query rows of H = 256, S = 1024) a row holds 512 KB of K and V; the
// score and context products are 4 * G * S * H operations a row, about 1 %
// of the bf16 tensor-core rate even with three operand parts.
//
// Design. One CTA of kThreads threads per (split, row): grid (n_split, R),
// a cluster of the n_split CTAs of a row. n_split is the most (up to 8)
// whose clusters the device holds all at once (choose_plan: 8 at small
// batches, 3 at Gemma-2B's decode batch of 64, 1 at 256), and a CTA takes
// whole chunks of kChunk rows. A CTA
//   1. streams its chunks through a ring of kStages shared-memory stages,
//      one bulk copy (cp.async.bulk, 1-D TMA) a chunk on the stage's
//      mbarrier: first its K chunks, then its V chunks, the first two at
//      entry and each next one as a stage is read, so that the V copies
//      are in flight while the last scores and the softmax run (the
//      live-prefix, lengths, stale and splice forms copy only their live
//      rows: rows < L (the stale form: L = lengths - 1), or for a
//      zero-length row no K row and its V rows, n_chunks * c of them for
//      #18, all S for #7 and #8, none for #2);
//   2. meanwhile stages the query operands in the tensor cores' fragment
//      order: f32 q in kQPartsF32 bf16 parts (their sum is q to 24 bits;
//      the smallest part is multiplied first), bf16 mode one bf16 part (q
//      rounded as before), int8 mode the codes; sum(q) (or sum(code *
//      q_scale)) in the order of attention_common.cuh's prepare_queries;
//   3. scores each chunk with mma.sync m16n8k16 bf16 (int8: m16n8k32 s8,
//      int32 sums): cache rows are M (one 16-row tile a warp), the query
//      rows N (8 a tile: G < 8 pads with zero rows, G up to 16 takes two
//      tiles), H the
//      depth; int8 K widens to bf16 exactly (byte into an f32 mantissa,
//      then a pair conversion); then each score as before:
//      (q . k - zp_k * sum(q)) * k_scale_eff, plus the mask (read by its
//      strides) or -1e30 past the length. The f32 mode of the lengths,
//      stale and splice forms instead forms q . k as one f32 FMA chain over
//      h = 0 .. H - 1 (SIMT,
//      `score_chunk_chain`), the order of the plain version's f32 matmul
//      on the card (equal to it bit for bit): its check holds the context
//      to 1e-5 absolute, about one ulp of the scores at Gemma-2B's widths
//      (the plain version's own rounding error against an f64 truth is
//      about 1e-5 there), which tensor-core sums in their own order do not
//      meet (PERF.md §6);
//   4. takes each query row's maximum over its slice; the maxima meet in
//      distributed shared memory and every CTA takes their maximum (order
//      free, so every e = exp(s - m) is the one-block kernel's value); the
//      local sums of e (SumT<C>) meet the same way, added in split order,
//      so every CTA holds the same denominator, and the mode's operand
//      prob_operand<C> follows as before. The live-prefix kernel keeps its
//      own formula: e unnormalised, l = the cluster's sum of e;
//   5. forms its slice's context ctx^T [H, G] = V^T . p^T on the tensor
//      cores: V is A (16 head columns a tile), p the N = 8 side. Float
//      modes: mma.sync m16n8k16 f16, V widened to fp16 exactly (0x64 | byte
//      ^ 0x80 is 1024 + 128 + v, less 1152), p * kPScale in kPParts fp16
//      parts (bf16 mode: one part, exact), the sum divided by kPScale;
//      int8: m16n8k32 s8 on the codes, int32, exact. The rows of a k-step
//      come to each thread as bytes of four (eight) rows, transposed with
//      prmt. Warps split H in two and each chunk's rows in four, their
//      sums in registers across the chunks (the chained f32 modes add
//      each k-step's products into their sums by an f32 add, so that
//      the tensor cores' own accumulation spans one k-step); the four row
//      quarters are added in order;
//   6. the [G, H] partials meet in distributed shared memory: CTA i adds
//      the i-th n-th of every CTA's partial (in fragment order) in split
//      order (a fixed order: the result does not depend on timing), applies
//      finish_ctx<C> (int8: the code sums of the cluster, exact) or
//      acc / max(l, 1e-30), and writes them (f32, or bf16 rounded once at
//      the write).
//   The stale form (#2) adds the new token's column, which is no cache row:
//   every CTA of the cluster forms s_cur itself between steps 2 and 3 (G
//   dots of H against k_new staged in shared memory, while the first chunks
//   are in flight; f32 and bf16 in the order of the plain version's
//   one-column matmul on the card, new_column_order; int8 exact), so it
//   needs no exchange; step 4 takes s_cur into the maximum after the
//   cluster's maxima and e_cur into the denominator after the slices' sums
//   (int8: inside the f64 sum), and step 6 adds p_cur's operand times v_new
//   after the cluster's partials (int8: its code in int32, and into the
//   code sum), the plain version's order. A row with no stale row (lengths
//   0 or 1) reads nothing and its context is v_new.
//   The splice form (#8) is the lengths form with row p = clip(pos, 0,
//   S - 1) replaced by the new token's rows in shared memory, never in the
//   cache: the CTA whose slice holds p waits for the chunk's bulk copy,
//   overwrites that row of the ring stage with k_new (V: v_new; K where p is
//   a scored row, V where it is a read one), fences the generic writes
//   against the stage's next bulk copy (fence.proxy.async) and lets the
//   chunk be read after a __syncthreads; after gather_partials (all its
//   copies landed) it writes the two rows into the caches. No other CTA
//   reads row p of its (batch, kv-head) row.
//   A chunk is plain rows (one copy), so the fragment reads of K meet every
//   row at the same bank (two-way conflicts); V's reads take whole rows of
//   128 bytes. The chained scores read the K chunk copied (in shared
//   memory) to rows of H + kKPad bytes, so that the rows a warp reads at
//   once lie on eight bank groups. The tensor cores' f32 sums run in their
//   own order: f32 results hold 1e-5 * max(|y|, 1) of the plain versions
//   (the CPU twins, tests/test_torch_port_attn_split*.py, show one part
//   fewer of q or p fails it).
//
// The int4-group body (`attend_int4g`, #10's arithmetic: bf16 operands and
// f32 sums) keeps steps 1, 4, 5 and 6 and the cluster: a ring stage holds
// a chunk's packed codes [kChunk, H / 2] and the sidecar strips of its
// rows ([NG, kChunk] bf16 each: K scales and mins for a K chunk, V scales
// for a V chunk), the codes one bulk copy and each strip one more (S is
// the sidecar's minor axis, so a chunk's scales are 2 NG or NG runs of 256
// bytes; the lanes of one warp issue them together, with no tensor map to
// encode on the host at every call). Scores: as the lengths form's f32
// mode, one f32 FMA chain a score in the plain version's order on the card
// (bf16(q) . K over h, then sum_n qsum[g, n] * kmin[n, j] over n), K[j, h]
// = bf16(kcode * kscale) formed two at a time in registers (0x4300 | code
// is the bf16 128 + code, and one bf16x2 FMA with -128 * kscale leaves the
// product rounded once): its check holds the context to 4e-3 of its
// largest value with a bf16 rounding of p in between, which a one-ulp
// difference of a score flips, in the kernel or in the plain version
// (chip_smoke.INT4G_CTX_RTOL; PERF.md §6). Context: V[j, h] =
// bf16(vcode * vscale) (0x4300 | (code ^ 8), less 136, times vscale) is
// A, bf16 p the N = 8 side, f32 sums (mma.sync m16n8k16 bf16). Warps
// split H by nibble (the low nibbles hold columns [0, H / 2), the high
// ones the rest) and each chunk's rows in four.
//
// The per-row int4 body (`attend_int4r`, #21's arithmetic) is #10's with
// one scale a cache row: a ring stage holds a chunk's packed codes and one
// strip of its rows' scales ([kChunk] bf16 of kv_scales [R, 8, S]: row 0
// for a K chunk, row 1 for a V chunk), both bulk copies. Scores: two f32
// FMA chains a score, bf16(q) over the low half of H against the low
// nibbles and over the high half against the high ones (the plain
// version's two matmuls, in their order on the card), then ((lo + hi) *
// kscale) * inv_sqrt_h. Softmax with f32 probabilities (the lengths form's
// rows). Context: the V code widened to bf16 exactly (0x4300 | (u ^ 8),
// less 136) is A, bf16(p * vscale) the N = 8 side, f32 sums (mma.sync
// m16n8k16 bf16); warps split H by nibble as #10's.
#pragma once

#include <cuda_fp16.h>

#include "attention_common.cuh"
#include "tc_ptx.cuh"

namespace aeqt {
namespace split {

constexpr int kThreads = 256;        // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 128;          // cache rows of a ring stage
constexpr int kStages = 2;           // ring stages of a CTA
constexpr int kMaxSplit = 8;         // CTAs of a cluster (portable size)
constexpr int kMaxG = 16;            // query rows: two n-tiles at most
constexpr int kQPartsF32 = 3;        // bf16 parts of an f32 q
constexpr int kPParts = 2;           // fp16 parts of an f32 p
constexpr float kPScale = 32768.0f;  // p's scale before the split: 2^15
constexpr uint32_t kFlip = 0x80808080u;  // int8 -> biased byte (v + 128)
constexpr int kKPad = 16;            // bytes after a K row of a chained chunk

// The bodies of the int8-cache kernels: the masked (#17), live-prefix (#18),
// lengths (#7), stale (#2: lengths - 1 cache rows and the new token's
// column) and splice (#8: the lengths form with row pos read from the new
// token's rows, which it writes into the caches) forms.
enum Form : int {
  kMasked = 0,
  kDynlen = 1,
  kLengths = 2,
  kStale = 3,
  kSplice = 4
};

// The head dims the fragment layout takes.
inline bool head_dim_fits(int H) { return H == 64 || H == 128 || H == 256; }

// Whether a form scores f32 q by one FMA chain a score (step 3).
__host__ __device__ constexpr bool chained(int F, int C) {
  return (F == kLengths || F == kStale || F == kSplice) && C == kF32;
}

// The chained scores read a K chunk copied from its ring stage to rows
// kKPad bytes longer (kpad), so that the 32 rows a warp reads at once lie
// on eight bank groups: bytes of that copy for rows of rb bytes.
__host__ __device__ inline size_t kpad_bytes(int rb) {
  return (size_t)kChunk * (rb + kKPad);
}

// bf16 parts of q: f32 kQPartsF32, bf16 one; int8 takes codes instead.
__host__ __device__ constexpr int q_parts(int C) {
  return C == kF32 ? kQPartsF32 : (C == kBF16 ? 1 : 0);
}
// fp16 parts of the context's probability operand.
__host__ __device__ constexpr int p_parts(int C) {
  return C == kBF16 ? 1 : kPParts;
}

// Floats between two query rows' scores: 4 more than the slice's rows, so
// that the rows of a fragment fall on different banks.
__host__ __device__ inline int sc_pitch(int T) { return T + 4; }

__host__ __device__ inline size_t up16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

// Byte offsets of a CTA's shared memory: the ring of kStages chunks of
// kChunk K or V rows (after the last, the four row quarters' context
// partials in fragment order), the chained form's padded K chunk, the
// query operands in fragment order (the chained form's f32 rows), the
// scores [G][T + 4] (then e, the operands p), sum(q), q scales, and the
// cluster's exchange slots: the maxima, the sums of e (SumT: 8 bytes), the
// int8 code sums; the cluster's l or code sum of each query row; the stale
// form's new column (s_cur, then e_cur, then p_cur's operand, [G] f32) and
// k_new's H bytes; the stages' mbarriers.
struct Layout {
  size_t ring, kpad, q, sc, qsum, qscale, xmax, xsum, xcodes, xtot, cur, knew,
      bars, bytes;
};

__host__ __device__ inline size_t query_bytes(int F, int C, int G, int H) {
  const size_t nt = (size_t)(G + 7) / 8;
  if (chained(F, C)) return 8 * nt * (H + 4) * 4;  // f32 rows, padded
  return C == kInt8 ? nt * H * 8 : q_parts(C) * nt * H * 16;
}

__host__ __device__ inline Layout layout(int F, int C, int G, int H, int T) {
  const size_t nt = (size_t)(G + 7) / 8;
  const size_t parts = (size_t)128 * nt * H;
  const size_t ring = (size_t)kStages * kChunk * H;
  Layout L;
  L.ring = 0;
  L.kpad = up16(ring > parts ? ring : parts);
  L.q = up16(L.kpad + (chained(F, C) ? kpad_bytes(H) : 0));
  L.sc = up16(L.q + query_bytes(F, C, G, H));
  L.qsum = up16(L.sc + (size_t)G * sc_pitch(T) * 4);
  L.qscale = up16(L.qsum + (size_t)G * 4);
  L.xmax = up16(L.qscale + (size_t)G * 4);
  L.xsum = up16(L.xmax + (size_t)G * 4);
  L.xcodes = up16(L.xsum + (size_t)G * 8);
  L.xtot = up16(L.xcodes + (size_t)G * 4);
  L.cur = up16(L.xtot + (size_t)G * 4);
  L.knew = up16(L.cur + (F == kStale ? (size_t)G * 4 : 0));
  L.bars = up16(L.knew + (F == kStale ? (size_t)H : 0));
  L.bytes = L.bars + 8 * kStages;
  return L;
}

// The kernels' arguments (the masked kernel reads mask*, the live-prefix
// kernel lengths, c and rb, the lengths kernel lengths, the stale kernel
// lengths, k_new and v_new, the splice kernel those and pos, the
// int4-group kernel lengths, sidecar and shift, with ks = f32(1 / sqrt(H))).
// The stale and splice kernels' pointers share storage with the masked
// kernel's mask fields, which they do not read: the block stays 128 bytes
// (24 more made #7's f32 kernel 4 % slower on the H100, PERF.md §6).
struct Args {
  const float* q;   // [R, G, H]
  const int8_t* k;  // [R, S, H] (int4 group: packed uint8 [R, S, H / 2];
                    // splice: written at row pos)
  const int8_t* v;  // [R, S, H] (int4 group: packed uint8 [R, S, H / 2];
                    // splice: written at row pos)
  void* out;        // [R, G, H]: f32, or bf16 where out_bf16
  union {
    const float* mask;
    const int8_t* k_new;  // stale, splice: the new token's rows [R, H]
  };
  union {
    long long mask_sb;
    const int8_t* v_new;  // stale, splice: [R, H]
  };
  union {
    long long mask_sn;
    const int* pos;  // splice: [1] on the device, clipped to [0, S - 1]
  };
  long long mask_sg;
  const int* lengths;
  const uint16_t* sidecar;  // int4 group: bf16 [R, 3 NG, S]
  int c, rb;
  int NK, G, S, rows, out_bf16, shift;
  float ks, v_scale, zp_k, zp_v;
};

// Element i of the output, rounded once to its type.
__device__ __forceinline__ void store_out(const Args& a, size_t i, float y) {
  if (a.out_bf16)
    static_cast<__nv_bfloat16*>(a.out)[i] = __float2bfloat16_rn(y);
  else
    static_cast<float*>(a.out)[i] = y;
}

// The launch of a shape: n_split CTAs (one cluster) a row, `rows` cache
// rows a CTA (whole chunks), the dynamic shared memory.
struct Plan {
  int n_split, rows;
  size_t smem;
};

// A body's shared memory for a slice of T cache rows: the int8 forms'
// (layout) ...
struct Int8Smem {
  int F, C, G, H;
  size_t operator()(int T) const { return layout(F, C, G, H, T).bytes; }
};

// The plan of n_split CTAs a row, whole chunks each (the last CTA's slice
// cut at S); smem_of(T) is the body's shared memory for T rows a CTA.
template <class SmemOf>
inline Plan plan_for(const SmemOf& smem_of, int S, int n_split) {
  const int chunks = S > kChunk ? (S + kChunk - 1) / kChunk : 1;
  Plan p;
  p.n_split = n_split;
  p.rows = (chunks + n_split - 1) / n_split * kChunk;
  p.smem = smem_of(p.rows);
  return p;
}

// Whether a body takes R rows of S cache rows (the entry points add their
// own terms): the plan with the most CTAs a row must fit.
template <class SmemOf>
inline bool takes_rows(const SmemOf& smem_of, int R, int G, int S) {
  if (R < 1 || R > 65535 || G < 1 || G > kMaxG || S < 1) return false;
  const int chunks = S > kChunk ? (S + kChunk - 1) / kChunk : 1;
  return smem_fits(
      plan_for(smem_of, S, chunks < kMaxSplit ? chunks : kMaxSplit).smem);
}

// Whether the int8 forms take a shape.
inline bool takes(int F, int C, int R, int G, int S, int H) {
  return head_dim_fits(H) && takes_rows(Int8Smem{F, C, G, H}, R, G, S);
}

// The launch of `kernel` under plan p for R rows: grid (n_split, R), one
// cluster of n_split CTAs a row.
inline cudaLaunchConfig_t launch_config(const Plan& p, int R,
                                        cudaLaunchAttribute* attr,
                                        cudaStream_t stream) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(p.n_split, R);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = p.smem;
  config.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = p.n_split;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return config;
}

using Kernel = void (*)(Args);

// The clusters of plan p the device holds at once (the occupancy query,
// kept per kernel and plan: a server asks at every step).
inline int max_clusters(Kernel kernel, const Plan& p) {
  struct Known {
    Kernel kernel;
    int n_split;
    size_t smem;
    int clusters;
  };
  static Known known[64];
  static int n_known = 0;
  for (int i = 0; i < n_known; ++i)
    if (known[i].kernel == kernel && known[i].n_split == p.n_split &&
        known[i].smem == p.smem)
      return known[i].clusters;
  int clusters = 0;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t config = launch_config(p, 1, &attr, 0);
  if (cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)p.smem) != cudaSuccess ||
      cudaOccupancyMaxActiveClusters(&clusters, kernel, &config) !=
          cudaSuccess) {
    cudaGetLastError();  // a refused query is no launch error
    clusters = 0;
  }
  if (n_known < 64) known[n_known++] = {kernel, p.n_split, p.smem, clusters};
  return clusters;
}

// The split: the most CTAs a row (kMaxSplit at most, a portable cluster;
// whole chunks each) whose R clusters the device holds at once, by the
// occupancy query; else the fewest (one, where its scores fit). A grid of
// more clusters than the device holds leaves its last ones to start only
// when the first ones end, each waiting out its whole serial chain; at a
// batch too large for any split to fit at once, a row's whole S in one CTA
// ran fastest (PERF.md §6). At S 1024 on the H100 that is 8 CTAs a row
// for small batches, 3 at a batch of 64 and 1 at 256.
template <class SmemOf>
inline Plan choose_plan(Kernel kernel, const SmemOf& smem_of, int S, int R) {
  const int chunks = S > kChunk ? (S + kChunk - 1) / kChunk : 1;
  Plan fits = plan_for(smem_of, S, chunks < kMaxSplit ? chunks : kMaxSplit);
  int tried = 0;
  for (int per = (chunks + kMaxSplit - 1) / kMaxSplit; per <= chunks;
       ++per) {
    const int n = (chunks + per - 1) / per;
    if (n == tried) continue;  // the same split as the last try
    tried = n;
    const Plan p = plan_for(smem_of, S, n);
    if (!smem_fits(p.smem)) break;  // fewer CTAs hold more scores
    if (R <= max_clusters(kernel, p)) return p;
    fits = p;
  }
  return fits;  // more than one wave: the fewest CTAs a row that fit
}

// Plan fields as chip_smoke.py reads them (SPLIT_PLAN_FIELDS): the
// cluster size (splits, grid x), grid y (rows), cache rows a CTA, threads,
// dynamic shared memory.
inline void plan_fields(const Plan& p, int R, long long* f) {
  f[0] = p.n_split;
  f[1] = R;
  f[2] = p.rows;
  f[3] = kThreads;
  f[4] = (long long)p.smem;
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_f16(float (&d)[4], uint32_t a0,
                                        uint32_t a1, uint32_t a2, uint32_t a3,
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Bytes e and e + 1 of a biased word (each byte v + 128) as a bf16 pair
// (byte e in the low half), exactly: the byte as an f32 mantissa (2^23 +
// v + 128), less 2^23 + 128.
template <int E>
__device__ __forceinline__ uint32_t bf16_pair(uint32_t biased) {
  const float lo =
      __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7440 | E)) -
      8388736.0f;
  const float hi =
      __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7440 | (E + 1))) -
      8388736.0f;
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Bytes 0 and 1 (SEL 0x4140) or 2 and 3 (0x4342) of a biased word as an
// fp16 pair, exactly: 0x64 above each byte is 1024 + v + 128, less 1152.
template <int SEL>
__device__ __forceinline__ uint32_t f16_pair(uint32_t biased) {
  uint32_t d;
  asm("sub.rn.f16x2 %0, %1, %2;"
      : "=r"(d)
      : "r"(__byte_perm(biased, 0x64646464u, SEL)), "r"(0x64806480u));
  return d;
}

// Byte BO and BO + 1 of x and of y, interleaved: [x.BO, y.BO, x.BO+1,
// y.BO+1].
template <int BO>
__device__ __forceinline__ uint32_t pair_rows(uint32_t x, uint32_t y) {
  return __byte_perm(x, y, BO | ((4 + BO) << 4) | ((BO + 1) << 8) |
                               ((5 + BO) << 12));
}

// x0 and x1 in NP fp16 parts, each rounding what the earlier ones left.
template <int NP>
__device__ __forceinline__ void f16_parts(float x0, float x1,
                                          uint32_t (&out)[NP]) {
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const __half2 h = __floats2half2_rn(x0, x1);
    out[p] = *reinterpret_cast<const uint32_t*>(&h);
    x0 = x0 - __low2float(h);
    x1 = x1 - __high2float(h);
  }
}

// W bytes of a V row as W / 4 words.
template <int W>
__device__ __forceinline__ void load_row(const int8_t* p,
                                         uint32_t (&w)[W / 4]) {
  if constexpr (W == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  } else if constexpr (W == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x;
    w[1] = v.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
}

// Fragment order of the query operands. Thread t of a warp reads, from
// cache rows grp and grp + 8, the 16 bytes at 64 gi + 16 t; its word u is
// the k16 step 4 gi + u (bytes 0, 1: k 2t, 2t + 1; bytes 2, 3: k 2t + 8,
// 2t + 9), or for int8 words 2v and 2v + 1 the k32 step 2 gi + v. Query
// row g of n-tile nt and head column h go where lane 4 (g % 8) + t finds
// them: bf16 element index of part p ...
template <int H>
__device__ __forceinline__ int q_index(int p, int nts, int nt, int g8,
                                          int h) {
  const int ks = 4 * (h >> 6) + ((h >> 2) & 3);
  const int ln = 4 * g8 + ((h >> 4) & 3);
  return (((p * nts + nt) * (H / 16) + ks) * 32 + ln) * 4 + (h & 3);
}
// ... and byte index of the int8 codes.
template <int H>
__device__ __forceinline__ int code_index(int nt, int g8, int h) {
  const int ks = 2 * (h >> 6) + ((h >> 3) & 1);
  const int ln = 4 * g8 + ((h >> 4) & 3);
  return ((nt * (H / 32) + ks) * 32 + ln) * 8 + 4 * ((h >> 2) & 1) + (h & 3);
}

// Step 2: the query operands of the G rows qr [G][H] (zeros for the pad
// rows up to a whole n-tile), qsum and (int8) the q scales; one warp a
// query row, in prepare_queries' order.
// Query row g (zeros past G) into registers, lane-strided: every load in
// flight at once.
template <int H>
__device__ __forceinline__ void load_query(const float* __restrict__ qr,
                                           int G, int g, float (&x)[H / 32]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < H / 32; ++i)
    x[i] = g < G ? qr[(size_t)g * H + lane + 32 * i] : 0.0f;
}

// x holds this warp's first row (g = warp), loaded before the copies were
// issued.
template <int C, int H>
__device__ __forceinline__ void stage_queries(const float* __restrict__ qr,
                                              int G, uint8_t* qbuf,
                                              float* qsum, float* qscale,
                                              float (&x)[H / 32]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nts = (G + 7) >> 3;
  for (int g = warp; g < 8 * nts; g += kWarps) {
    const int nt = g >> 3, g8 = g & 7;
    const bool real = g < G;
    if (g != warp) load_query<H>(qr, G, g, x);
    float s = 0.0f;
    if constexpr (C == kInt8) {
      float m = 0.0f;
#pragma unroll
      for (int i = 0; i < H / 32; ++i) m = fmaxf(m, fabsf(x[i]));
      m = warp_max(m);
      const float scale = fmaxf(m, (float)1e-9) * kInv127;
#pragma unroll
      for (int i = 0; i < H / 32; ++i) {
        const float code = real ? rintf(x[i] / scale) : 0.0f;
        qbuf[code_index<H>(nt, g8, lane + 32 * i)] =
            (uint8_t)(int8_t)(int)code;
        s = s + code * scale;
      }
      s = warp_sum(s);
      if (real && lane == 0) qscale[g] = scale;
    } else {
      __nv_bfloat16* qb = reinterpret_cast<__nv_bfloat16*>(qbuf);
#pragma unroll
      for (int i = 0; i < H / 32; ++i) {
        const int h = lane + 32 * i;
        float r = x[i];
        s = s + r;
#pragma unroll
        for (int p = 0; p < q_parts(C); ++p) {
          const __nv_bfloat16 b = __float2bfloat16_rn(r);
          qb[q_index<H>(p, nts, nt, g8, h)] = b;
          r = r - __bfloat162float(b);
        }
      }
      s = warp_sum(s);
    }
    if (real && lane == 0) qsum[g] = s;
  }
}

// Step 3: the scores of one chunk, slice rows [j0, j0 + kChunk) lying in
// ring stage `kst`, one 16-row tile a warp, into sc [G][T + 4] for the
// rows j < kr (rows of a tile past kr are computed and not stored).
template <int F, int C, int H>
__device__ __forceinline__ void score_chunk(const Args& a, const int8_t* kst,
                                            const uint8_t* qbuf,
                                            const float* qsum,
                                            const float* qscale,
                                            const float* mrow, float* sc,
                                            int j0, int kr, int s0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, t = lane & 3;
  const int G = a.G, P = sc_pitch(a.rows), nts = (G + 7) >> 3;
  const int mt = warp;  // the warp's tile of the chunk
  if (j0 + 16 * mt < kr) {
    const int8_t* k0 = kst + (size_t)(16 * mt + grp) * H + 16 * t;
    const int8_t* k1 = k0 + 8 * H;
    for (int nt = 0; nt < nts; ++nt) {
      float dot[4];
      if constexpr (C == kInt8) {
        int acc[4] = {0, 0, 0, 0};
        const uint2* qb =
            reinterpret_cast<const uint2*>(qbuf) + nt * (H / 32) * 32 + lane;
#pragma unroll
        for (int gi = 0; gi < H / 64; ++gi) {
          const uint4 w0 = *reinterpret_cast<const uint4*>(k0 + 64 * gi);
          const uint4 w1 = *reinterpret_cast<const uint4*>(k1 + 64 * gi);
          const uint2 b0 = qb[(2 * gi) * 32], b1 = qb[(2 * gi + 1) * 32];
          mma_s8(acc, w0.x, w1.x, w0.y, w1.y, b0.x, b0.y);
          mma_s8(acc, w0.z, w1.z, w0.w, w1.w, b1.x, b1.y);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int g = 8 * nt + 2 * t + (i & 1);
          dot[i] = g < G ? (float)acc[i] * qscale[g] : 0.0f;
        }
      } else {
        constexpr int QP = q_parts(C);
        float acc[QP][4] = {};  // one chain of products a part
        const uint2* qb = reinterpret_cast<const uint2*>(qbuf) + lane;
#pragma unroll
        for (int gi = 0; gi < H / 64; ++gi) {
          const uint4 w0 = *reinterpret_cast<const uint4*>(k0 + 64 * gi);
          const uint4 w1 = *reinterpret_cast<const uint4*>(k1 + 64 * gi);
          const uint32_t r0[4] = {w0.x ^ kFlip, w0.y ^ kFlip, w0.z ^ kFlip,
                                  w0.w ^ kFlip};
          const uint32_t r1[4] = {w1.x ^ kFlip, w1.y ^ kFlip, w1.z ^ kFlip,
                                  w1.w ^ kFlip};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const uint32_t a0 = bf16_pair<0>(r0[u]), a2 = bf16_pair<2>(r0[u]);
            const uint32_t a1 = bf16_pair<0>(r1[u]), a3 = bf16_pair<2>(r1[u]);
            const int ks = 4 * gi + u;
#pragma unroll
            for (int p = QP - 1; p >= 0; --p) {  // the smallest part first
              const uint2 b = qb[((p * nts + nt) * (H / 16) + ks) * 32];
              mma_bf16(acc[p], a0, a1, a2, a3, b.x, b.y);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {  // the smallest part's sum first
          dot[i] = acc[QP - 1][i];
#pragma unroll
          for (int p = QP - 2; p >= 0; --p) dot[i] = dot[i] + acc[p][i];
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int g = 8 * nt + 2 * t + (i & 1);
        const int j = j0 + 16 * mt + grp + 8 * (i >> 1);
        if (g >= G || j >= kr) continue;
        float s = (dot[i] - a.zp_k * qsum[g]) * a.ks;
        if constexpr (F == kMasked) s = s + mrow[g * a.mask_sg + s0 + j];
        sc[g * P + j] = s;
      }
    }
  }
}

// Step 2 of the chained form: the f32 query rows qr [G][H] into qf
// [8 nt][H + 4] (zeros past G, so that every chain runs unguarded; a pitch
// that puts the rows a warp reads at once on separate banks) and their
// sums, one warp a query row, in prepare_queries' order.
template <int H>
__device__ __forceinline__ void stage_query_rows(const float* __restrict__ qr,
                                                 int G, float* qf,
                                                 float* qsum,
                                                 float (&x)[H / 32]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int g = warp; g < 8 * ((G + 7) >> 3); g += kWarps) {
    if (g != warp) load_query<H>(qr, G, g, x);
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < H / 32; ++i) {
      qf[g * (H + 4) + lane + 32 * i] = x[i];
      s = s + x[i];
    }
    s = warp_sum(s);
    if (g < G && lane == 0) qsum[g] = s;
  }
}

// The chained scores' first step: the n rows of rb bytes of a K chunk in
// ring stage `st` into kpad, rows rb + kKPad bytes apart; every thread
// copies 16-byte units.
template <int RB>
__device__ __forceinline__ void pad_rows(const uint8_t* st, uint8_t* kpad,
                                         int n) {
  constexpr int U = RB / 16;  // units a row
  for (int u = threadIdx.x; u < n * U; u += kThreads) {
    const int r = u / U, c = u % U;
    *reinterpret_cast<uint4*>(kpad + (size_t)r * (RB + kKPad) + 16 * c) =
        *reinterpret_cast<const uint4*>(st + (size_t)r * RB + 16 * c);
  }
}

// The chained scores' lanes: warp w takes cache rows 32 (w % 4) + lane of
// a chunk and the query rows (w / 4) NQ .. + NQ - 1 (NQ = 4 NTS), one f32
// FMA chain each over h = 0 .. H - 1: each K element is widened once for
// NQ chains, and each q word is one broadcast read.
template <int NTS>
struct Chain {
  static constexpr int NQ = 4 * NTS;
  __device__ static int row() { return 32 * ((threadIdx.x >> 5) & 3) +
                                       (threadIdx.x & 31); }
  __device__ static int g0() { return (threadIdx.x >> 7) * NQ; }
};

// Step 3 of the chained form: the scores of one chunk (slice rows [j0, j0 +
// kChunk), copied to kpad), q . k one f32 FMA chain over h in increasing
// order, then (q . k - zp_k * sum(q)) * k_scale_eff, for the rows j < kr.
template <int H, int NTS>
__device__ __forceinline__ void score_chunk_chain(const Args& a,
                                                  const uint8_t* kpad,
                                                  const float* qf,
                                                  const float* qsum,
                                                  float* sc, int j0, int kr) {
  using CH = Chain<NTS>;
  constexpr int QP = H + 4, NQ = CH::NQ;
  const int G = a.G, P = sc_pitch(a.rows);
  const int j = CH::row(), g0 = CH::g0();
  if (j0 + (j & ~31) >= kr || g0 >= G) return;  // warp-uniform
  const uint8_t* krow = kpad + (size_t)j * (H + kKPad);
  float acc[NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) acc[i] = 0.0f;
#pragma unroll 2
  for (int h = 0; h < H; h += 16) {
    const uint4 w = *reinterpret_cast<const uint4*>(krow + h);
    const uint32_t r[4] = {w.x ^ kFlip, w.y ^ kFlip, w.z ^ kFlip,
                           w.w ^ kFlip};
    float kf[16];
#pragma unroll
    for (int e = 0; e < 16; ++e)  // the biased byte as an f32 mantissa
      kf[e] = __uint_as_float(__byte_perm(r[e >> 2], 0x4B000000u,
                                          0x7440 | (e & 3))) -
              8388736.0f;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int i = 0; i < NQ; ++i) {  // rows past G: zeros
        const float4 qv =
            *reinterpret_cast<const float4*>(qf + (g0 + i) * QP + h + 4 * u);
        acc[i] = __fmaf_rn(qv.x, kf[4 * u], acc[i]);
        acc[i] = __fmaf_rn(qv.y, kf[4 * u + 1], acc[i]);
        acc[i] = __fmaf_rn(qv.z, kf[4 * u + 2], acc[i]);
        acc[i] = __fmaf_rn(qv.w, kf[4 * u + 3], acc[i]);
      }
    }
  }
  if (j0 + j < kr) {
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const int g = g0 + i;
      if (g < G) sc[g * P + j0 + j] = (acc[i] - a.zp_k * qsum[g]) * a.ks;
    }
  }
}

// The order of the stale form's new column q . k_new (f32 and bf16 modes):
// the plain version's one-column matmul, a batched [G, H] . [H, 1] product
// over R = B * NK rows, on the H100 (kernel_study.py order, every
// output equal): `parts` partial FMA chains over h in increasing order,
// then added. One row: 32 contiguous runs of H / 32, added as a butterfly
// (part l with l + parts / 2, then on down); up to 64 rows: min(16, H / 8)
// such runs; more rows: parts strided by `parts` (h = l, l + parts, ...),
// 16 added in order (H 64: 4, as a butterfly).
struct NewColumnOrder {
  int parts;
  bool strided, butterfly;
};

__host__ __device__ inline NewColumnOrder new_column_order(int R, int H) {
  if (R == 1) return {32, false, true};
  if (R <= 64) return {H / 8 < 16 ? H / 8 : 16, false, true};
  if (H == 64) return {4, true, true};
  return {16, true, false};
}

// The stale form's new column: each query row's score against k_new (knew,
// H bytes in shared memory) into cur [G], as a cache row's: (q . k_new -
// zp_k * sum(q)) * k_scale_eff, q . k_new in new_column_order's parts
// (f32: the f32 rows qf; bf16: bf16(q), each product exact), int8 the
// codes' int32 sum (exact) times q_scale. Lanes l of a group of `parts`
// take part l of query row g, the CTA's threads in turns where the groups
// outnumber them (parts * G up to 512).
template <int C, int H>
__device__ __forceinline__ void new_column_scores(const Args& a,
                                                  const uint8_t* qbuf,
                                                  const float* qsum,
                                                  const float* qscale,
                                                  const int8_t* knew,
                                                  float* cur) {
  const NewColumnOrder o = new_column_order(gridDim.y, H);
  const int n = H / o.parts, nts = (a.G + 7) >> 3;
  for (int t = threadIdx.x; (t & ~31) < o.parts * a.G; t += kThreads) {
    const int g = t / o.parts, l = t % o.parts;  // warp-uniform loop
    const bool real = g < a.G;
    const int nt = g >> 3, g8 = g & 7;
    float dot = 0.0f;
    int idot = 0;
    if (real) {
      const float* qf = reinterpret_cast<const float*>(qbuf) + g * (H + 4);
      const __nv_bfloat16* qb = reinterpret_cast<const __nv_bfloat16*>(qbuf);
      for (int i = 0; i < n; ++i) {
        const int h = o.strided ? l + o.parts * i : l * n + i;
        if constexpr (C == kInt8)
          idot += (int)(int8_t)qbuf[code_index<H>(nt, g8, h)] * (int)knew[h];
        else if constexpr (C == kF32)
          dot = __fmaf_rn(qf[h], (float)knew[h], dot);
        else
          dot = __fmaf_rn(
              __bfloat162float(qb[q_index<H>(0, nts, nt, g8, h)]),
              (float)knew[h], dot);
      }
    }
    if constexpr (C == kInt8) {
      for (int d = o.parts / 2; d >= 1; d >>= 1)  // exact: any order
        idot += __shfl_xor_sync(0xffffffffu, idot, d);
      if (real) dot = (float)idot * qscale[g];
    } else if (o.butterfly) {
      for (int d = o.parts / 2; d >= 1; d >>= 1)
        dot = dot + __shfl_xor_sync(0xffffffffu, dot, d);
    } else {
      const int first = (t & 31) - l;
      float sum = __shfl_sync(0xffffffffu, dot, first);
      for (int r = 1; r < o.parts; ++r)
        sum = sum + __shfl_sync(0xffffffffu, dot, first + r);
      dot = sum;
    }
    if (real && l == 0) cur[g] = (dot - a.zp_k * qsum[g]) * a.ks;
  }
}

// Step 5 in a float mode: the partial context of query rows [8 nt, 8 nt +
// 8) over rows [j0, j1) of the chunk in ring stage vst (k16 steps; sc
// points at the chunk's first score column), head columns
// h0 + 2 mt and h0 + 2 mt + 1 of tile mt; V widened to fp16, p in NP fp16
// parts of p * kPScale.
// kStep: each k-step's products summed by the tensor cores from zero and
// added into acc by an f32 add.
template <int C, int H, bool kStep>
__device__ __forceinline__ void context_f16(const int8_t* vst,
                                            const float* sc, int G, int P,
                                            int nt, int j0, int j1, int h0,
                                            float (&acc)[H / 32][4]) {
  constexpr int W = H / 16, MT = H / 32, NP = p_parts(C);
  const int lane = threadIdx.x & 31, grp = lane >> 2, t = lane & 3;
  const int g = 8 * nt + grp;
  for (int jb = j0; jb < j1; jb += 16) {
    uint32_t r[4][W / 4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      load_row<W>(vst + (size_t)(jb + 4 * t + i) * H + h0, r[i]);
#pragma unroll
      for (int w = 0; w < W / 4; ++w) r[i][w] ^= kFlip;
    }
    float4 pv = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (g < G) pv = *reinterpret_cast<const float4*>(sc + g * P + jb + 4 * t);
    uint32_t b0[NP], b1[NP];
    f16_parts<NP>(pv.x * kPScale, pv.y * kPScale, b0);
    f16_parts<NP>(pv.z * kPScale, pv.w * kPScale, b1);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int wi = mt >> 1;
      uint32_t x01, x23;
      if (mt & 1) {
        x01 = pair_rows<2>(r[0][wi], r[1][wi]);
        x23 = pair_rows<2>(r[2][wi], r[3][wi]);
      } else {
        x01 = pair_rows<0>(r[0][wi], r[1][wi]);
        x23 = pair_rows<0>(r[2][wi], r[3][wi]);
      }
      const uint32_t a0 = f16_pair<0x4140>(x01), a1 = f16_pair<0x4342>(x01);
      const uint32_t a2 = f16_pair<0x4140>(x23), a3 = f16_pair<0x4342>(x23);
      if constexpr (kStep) {
        float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int p = NP - 1; p >= 0; --p)  // the smallest part first
          mma_f16(d, a0, a1, a2, a3, b0[p], b1[p]);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][i] = acc[mt][i] + d[i];
      } else {
#pragma unroll
        for (int p = NP - 1; p >= 0; --p)  // the smallest part first
          mma_f16(acc[mt], a0, a1, a2, a3, b0[p], b1[p]);
      }
    }
  }
}

// Step 5 in int8: the same on the codes, k32 steps, m16n8k32 s8.
template <int H>
__device__ __forceinline__ void context_s8(const int8_t* vst,
                                           const float* sc, int G, int P,
                                           int nt, int j0, int j1, int h0,
                                           int (&acc)[H / 32][4]) {
  constexpr int W = H / 16, MT = H / 32;
  const int lane = threadIdx.x & 31, grp = lane >> 2, t = lane & 3;
  const int g = 8 * nt + grp;
  for (int jb = j0; jb < j1; jb += 32) {
    uint32_t r[8][W / 4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      load_row<W>(vst + (size_t)(jb + 16 * (i >> 2) + 4 * t + (i & 3)) * H +
                      h0,
                  r[i]);
    uint32_t b0 = 0, b1 = 0;
    if (g < G) {
      const float4 c0 =
          *reinterpret_cast<const float4*>(sc + g * P + jb + 4 * t);
      const float4 c1 =
          *reinterpret_cast<const float4*>(sc + g * P + jb + 16 + 4 * t);
      b0 = (uint32_t)__float2int_rn(c0.x) |
           ((uint32_t)__float2int_rn(c0.y) << 8) |
           ((uint32_t)__float2int_rn(c0.z) << 16) |
           ((uint32_t)__float2int_rn(c0.w) << 24);
      b1 = (uint32_t)__float2int_rn(c1.x) |
           ((uint32_t)__float2int_rn(c1.y) << 8) |
           ((uint32_t)__float2int_rn(c1.z) << 16) |
           ((uint32_t)__float2int_rn(c1.w) << 24);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int wi = mt >> 1;
      uint32_t x[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        x[i] = (mt & 1) ? pair_rows<2>(r[2 * i][wi], r[2 * i + 1][wi])
                        : pair_rows<0>(r[2 * i][wi], r[2 * i + 1][wi]);
      mma_s8(acc[mt], __byte_perm(x[0], x[1], 0x5410),
             __byte_perm(x[0], x[1], 0x7632), __byte_perm(x[2], x[3], 0x5410),
             __byte_perm(x[2], x[3], 0x7632), b0, b1);
    }
  }
}

// The context partials lie in the order of the C fragments in registers,
// [quarter][n-tile][hh][mt][lane][4], so that every store, the quarters'
// sum and the cluster's reads take whole rows of banks: element e of lane
// (grp, t) in tile mt of half hh, n-tile nt, is query row 8 nt + 2 t +
// (e & 1) at head column hh H / 2 + grp H / 16 + 2 mt + (e >> 1).
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(int* p, const int (&v)[4]) {
  *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
}

// Step 4 for the G query rows of a CTA's slice (scores sc [G][T + 4] of its
// kr scored rows; rows [kr, vr) scored -1e30, T rows in all): the row maxima
// over the cluster, e = exp(s - m), the sums of e (SumT<C>) over the cluster
// in split order, then (but for the live-prefix form) the mode's operand
// prob_operand<C>(e, sum) in place, 0 past vr. Maxima start at -1e30 where a
// row may have no scored row (every form but the masked one: a zero-length
// row's e is then 1), else at -inf. xsum keeps this CTA's sum of e; xcodes
// (int8) its operands' sum. The stale form's new column (cur: s_cur, the
// same in every CTA) joins the maximum after the cluster's, its e_cur the
// sum after the cluster's (in int8 inside the f64 sum), and cur ends as
// p_cur's operand, as the plain version orders them.
template <int F, int C>
__device__ __forceinline__ void softmax_cluster(float* sc, int G, int P,
                                                int T, int kr, int vr,
                                                float* xmax, SumT<C>* xsum,
                                                float* xcodes,
                                                float* cur = nullptr) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nsplit = gridDim.x;
  constexpr bool kLive = F != kMasked;  // rows may have no scored row
  for (int g = warp; g < G; g += kWarps) {
    float m = kLive ? kNegInf : -INFINITY;
    for (int j = lane; j < kr; j += 32) m = fmaxf(m, sc[g * P + j]);
    m = warp_max(m);
    if (lane == 0) xmax[g] = m;
  }
  tc::cluster_sync();
  for (int g = warp; g < G; g += kWarps) {
    float m = lane < nsplit ? *tc::cluster_map(&xmax[g], lane) : -INFINITY;
    m = warp_max(m);
    if constexpr (F == kStale) {
      m = fmaxf(m, cur[g]);
      const float e_cur = expf(cur[g] - m);
      __syncwarp();
      if (lane == 0) cur[g] = e_cur;
    }
    // Rows scored -1e30 (a zero-length row's V rows): e of -1e30 less the
    // maximum.
    const float e_dead = kLive ? expf(kNegInf - m) : 0.0f;
    SumT<C> acc = 0;
    for (int j = lane; j < T; j += 32) {
      float e = 0.0f;
      if (j < kr)
        e = expf(sc[g * P + j] - m);
      else if (j < vr)
        e = e_dead;
      sc[g * P + j] = e;
      acc = acc + (SumT<C>)e;
    }
    acc = warp_sum_t(acc);
    if (lane == 0) xsum[g] = acc;
  }
  if constexpr (F != kDynlen) {
    tc::cluster_sync();
    for (int g = warp; g < G; g += kWarps) {
      const SumT<C> mine = lane < nsplit ? *tc::cluster_map(&xsum[g], lane) : 0;
      SumT<C> tot = 0;
      for (int r = 0; r < nsplit; ++r)  // split order
        tot = tot + __shfl_sync(0xffffffffu, mine, r);
      float e_cur = 0.0f;
      if constexpr (F == kStale) {
        e_cur = cur[g];
        tot = tot + (SumT<C>)e_cur;  // the new column last
      }
      const float denom = (float)tot;
      float codes = 0.0f;
      for (int j = lane; j < T; j += 32) {
        const float p = j < vr ? prob_operand<C>(sc[g * P + j], denom) : 0.0f;
        sc[g * P + j] = p;
        codes = codes + p;
      }
      if constexpr (C == kInt8) {
        codes = warp_sum(codes);
        if (lane == 0) xcodes[g] = codes;
      }
      if constexpr (F == kStale) {
        __syncwarp();
        if (lane == 0) cur[g] = prob_operand<C>(e_cur, denom);
      }
    }
  }
}

// Step 6, first: the row quarters' partials `part` ([4][qstride] in
// fragment order, see store4) added in order; then the cluster's barrier.
template <typename AccT>
__device__ __forceinline__ void sum_quarters(AccT* part, int qstride) {
  __syncthreads();
  for (int i = threadIdx.x; i < qstride; i += kThreads) {  // in order
    AccT s = part[i];
    for (int q4 = 1; q4 < 4; ++q4) s = s + part[(size_t)q4 * qstride + i];
    part[i] = s;
  }
  tc::cluster_sync();
}

// Step 6, then: this CTA's share (1 / n_split) of the fragments summed over
// the cluster in split order (every remote value loaded before the sum);
// finish(g, h, acc) writes each value.
template <int H, typename AccT, class Finish>
__device__ __forceinline__ void gather_partials(const AccT* part, int G,
                                                int qstride,
                                                const Finish& finish) {
  const int tid = threadIdx.x, me = blockIdx.x, nsplit = gridDim.x;
  using AccT4 = typename std::conditional<std::is_same<AccT, int>::value,
                                          int4, float4>::type;
  const int n4 = qstride / 4;  // fragments of 4 values
  const int i0 = me * n4 / nsplit, i1 = (me + 1) * n4 / nsplit;
  for (int i = i0 + tid; i < i1; i += kThreads) {
    // Fragment i: its lane, tile, half and n-tile.
    constexpr int MT = H / 32;
    const int ln = i & 31, mt = (i >> 5) % MT, rest = (i >> 5) / MT;
    const int g = 8 * (rest >> 1) + 2 * (ln & 3);
    const int h = (rest & 1) * (H / 2) + (ln >> 2) * (H / 16) + 2 * mt;
    AccT4 v[kMaxSplit];
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r)
      if (r < nsplit)
        v[r] = *tc::cluster_map(reinterpret_cast<const AccT4*>(part) + i, r);
    AccT y4[4] = {v[0].x, v[0].y, v[0].z, v[0].w};
#pragma unroll
    for (int r = 1; r < kMaxSplit; ++r)
      if (r < nsplit) {
        y4[0] = y4[0] + v[r].x;
        y4[1] = y4[1] + v[r].y;
        y4[2] = y4[2] + v[r].z;
        y4[3] = y4[3] + v[r].w;
      }
    // y4: (g, h), (g + 1, h), (g, h + 1), (g + 1, h + 1).
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (g + (e & 1) < G) finish(g + (e & 1), h + (e >> 1), y4[e]);
  }
  tc::cluster_sync();  // no CTA leaves while others read its shared memory
}

// The int8 kernels' body in form F and compute mode C (the live-prefix
// form C = kF32). One CTA: blockIdx.x the split (its rank in the cluster),
// blockIdx.y the (batch, kv-head) row.
template <int F, int C, int H, int NTS>
__device__ __forceinline__ void attend(const Args& a) {
  extern __shared__ __align__(128) uint8_t smem[];
  using AccT = typename std::conditional<C == kInt8, int, float>::type;
  constexpr bool kChain = chained(F, C);
  const int G = a.G, S = a.S, T = a.rows, P = sc_pitch(T);
  const Layout L = layout(F, C, G, H, T);
  int8_t* ring = reinterpret_cast<int8_t*>(smem + L.ring);
  uint8_t* kpad = smem + L.kpad;
  uint8_t* qbuf = smem + L.q;
  float* sc = reinterpret_cast<float*>(smem + L.sc);
  float* qsum = reinterpret_cast<float*>(smem + L.qsum);
  float* qscale = reinterpret_cast<float*>(smem + L.qscale);
  float* xmax = reinterpret_cast<float*>(smem + L.xmax);
  SumT<C>* xsum = reinterpret_cast<SumT<C>*>(smem + L.xsum);
  float* xcodes = reinterpret_cast<float*>(smem + L.xcodes);
  float* xtot = reinterpret_cast<float*>(smem + L.xtot);
  float* cur = reinterpret_cast<float*>(smem + L.cur);
  int8_t* knew = reinterpret_cast<int8_t*>(smem + L.knew);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  AccT* part = reinterpret_cast<AccT*>(smem + L.ring);  // after the last V

  const int me = blockIdx.x, nsplit = gridDim.x, row = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int s0 = me * T;
  const int here = min(max(S - s0, 0), T);
  // Rows of the slice to score (kr) and to read from V (vr).
  int kr = here, vr = here;
  if constexpr (F == kDynlen) {
    // The TPU kernel's chunk count of this row's block of rb rows.
    const int len = a.lengths[row / a.NK];
    const int rb0 = (row / a.rb) * a.rb;
    int blk = a.lengths[rb0 / a.NK];
    for (int r = rb0 + 1; r < rb0 + a.rb; ++r)
      blk = max(blk, a.lengths[r / a.NK]);
    const int n_chunks =
        min(max(blk > 0 ? (blk + a.c - 1) / a.c : 0, 1), S / a.c);
    const int live_k = len > 0 ? min(len, n_chunks * a.c) : 0;
    const int live_v = len > 0 ? live_k : n_chunks * a.c;
    kr = min(max(live_k - s0, 0), here);
    vr = min(max(live_v - s0, 0), here);
  } else if constexpr (F == kLengths || F == kSplice) {
    // Rows < L; a zero-length row scores -1e30 everywhere: every one of
    // its S rows weighs 1 / S.
    const int len = a.lengths[row / a.NK];
    kr = len > 0 ? min(max(min(len, S) - s0, 0), here) : 0;
    vr = len > 0 ? kr : here;
  } else if constexpr (F == kStale) {
    // The L = lengths - 1 stale rows (the new token's column is apart): a
    // row with none reads nothing and weighs the new column alone.
    const int len = min(max(a.lengths[row / a.NK] - 1, 0), S);
    kr = vr = min(max(len - s0, 0), here);
  }
  // The splice form: the slice row of row p = clip(pos, 0, S - 1), where
  // this CTA holds it (-1: another CTA does).
  int sub = -1;
  if constexpr (F == kSplice) {
    const int p = min(max(*a.pos, 0), S - 1);
    if (p >= s0 && p < s0 + here) sub = p - s0;
  }

  // 1. The slice's loads: its K chunks, then its V chunks (live rows
  //    only), each one bulk copy into ring stage i % kStages; the first
  //    kStages at once (this warp's first query row loaded first), the next
  //    as a stage is read (the chained form's K chunk: as it is padded).
  const int nk = (kr + kChunk - 1) / kChunk, nv = (vr + kChunk - 1) / kChunk;
  const size_t base = ((size_t)row * S + s0) * H;
  auto issue_load = [&](int i) {
    if (i >= nk + nv) return;
    const bool is_v = i >= nk;
    const int c = is_v ? i - nk : i;
    const uint32_t bytes = (uint32_t)(min((is_v ? vr : kr) - c * kChunk,
                                          kChunk) * H);
    uint64_t* bar = &bars[i % kStages];
    tc::mbar_expect_tx(bar, bytes);
    tc::bulk_load(ring + (size_t)(i % kStages) * kChunk * H,
                  (is_v ? a.v : a.k) + base + (size_t)c * kChunk * H, bytes,
                  bar);
  };
  auto await_load = [&](int i) {
    tc::mbar_wait(&bars[i % kStages], (uint32_t)(i / kStages) & 1);
  };
  // The splice form, once chunk c of the slice's n copied rows (kr of K,
  // vr of V) has landed in stage st: where it holds row sub, that row
  // becomes the new token's (src, H bytes) before any thread reads the
  // stage. The proxy fence orders the generic writes before the stage's
  // next bulk copy (issued after the stage's readers' __syncthreads).
  auto splice = [&](int8_t* st, int c, int n, const int8_t* src) {
    if constexpr (F == kSplice) {
      if (sub >= c * kChunk && sub < min(n, (c + 1) * kChunk)) {
        if (tid < H / 16) {
          reinterpret_cast<uint4*>(st + (size_t)(sub - c * kChunk) * H)[tid] =
              __ldg(reinterpret_cast<const uint4*>(src) + tid);
          tc::fence_proxy_async();
        }
        __syncthreads();
      }
    }
  };
  const float* qr = a.q + (size_t)row * G * H;
  float xq[H / 32];
  load_query<H>(qr, G, warp, xq);
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) tc::mbar_init(&bars[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int i = 0; i < kStages; ++i) issue_load(i);

  // 2. Query operands (the stale form: k_new beside them, then the new
  //    column's scores, while the first chunks are in flight).
  if constexpr (kChain)
    stage_query_rows<H>(qr, G, reinterpret_cast<float*>(qbuf), qsum, xq);
  else
    stage_queries<C, H>(qr, G, qbuf, qsum, qscale, xq);
  if constexpr (F == kStale) {
    if (tid < H / 16)
      reinterpret_cast<uint4*>(knew)[tid] = __ldg(
          reinterpret_cast<const uint4*>(a.k_new + (size_t)row * H) + tid);
  }
  __syncthreads();
  if constexpr (F == kStale)
    new_column_scores<C, H>(a, qbuf, qsum, qscale, knew, cur);

  // 3. Scores.
  const float* mrow = nullptr;
  if constexpr (F == kMasked)
    mrow = a.mask + (row / a.NK) * a.mask_sb + (row % a.NK) * a.mask_sn;
  for (int c = 0; c < nk; ++c) {
    await_load(c);
    int8_t* kst = ring + (size_t)(c % kStages) * kChunk * H;
    splice(kst, c, kr, a.k_new + (size_t)row * H);
    if constexpr (kChain) {
      pad_rows<H>(reinterpret_cast<const uint8_t*>(kst), kpad,
                  min(kr - c * kChunk, kChunk));
      __syncthreads();  // the stage is read
      if (tid == 0) issue_load(c + kStages);
      score_chunk_chain<H, NTS>(a, kpad, reinterpret_cast<const float*>(qbuf),
                                qsum, sc, c * kChunk, kr);
      __syncthreads();  // kpad is read
    } else {
      score_chunk<F, C, H>(a, kst, qbuf, qsum, qscale, mrow, sc, c * kChunk,
                           kr, s0);
      __syncthreads();  // the stage is read
      if (tid == 0) issue_load(c + kStages);
    }
  }
  __syncthreads();

  // 4. Softmax across the cluster.
  softmax_cluster<F, C>(sc, G, P, T, kr, vr, xmax, xsum, xcodes, cur);
  __syncthreads();

  // 5. The slice's context, chunk by chunk: warp (hh, qq) takes head
  //    columns [hh H / 2, (hh + 1) H / 2) and rows [32 qq, 32 qq + 32) of
  //    each chunk, its sums in registers across the chunks.
  const int qstride = ((G + 7) >> 3) * 8 * H;  // a row quarter's partial
  {
    constexpr int MT = H / 32;
    const int grp = lane >> 2;
    const int hh = warp & 1, qq = warp >> 1;
    const int h0 = hh * (H / 2) + grp * (H / 16);
    AccT acc[NTS][MT][4];
#pragma unroll
    for (int nt = 0; nt < NTS; ++nt)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][mt][i] = 0;
    for (int c = 0; c < nv; ++c) {
      await_load(nk + c);
      int8_t* vst = ring + (size_t)((nk + c) % kStages) * kChunk * H;
      splice(vst, c, vr, a.v_new + (size_t)row * H);
      const int j0 = 32 * qq, j1 = min(j0 + 32, vr - c * kChunk);
#pragma unroll
      for (int nt = 0; nt < NTS; ++nt) {
        if constexpr (C == kInt8)
          context_s8<H>(vst, sc + c * kChunk, G, P, nt, j0, j1, h0, acc[nt]);
        else
          context_f16<C, H, kChain>(vst, sc + c * kChunk, G, P, nt, j0, j1,
                                    h0, acc[nt]);
      }
      __syncthreads();  // the stage is read
      if (tid == 0) issue_load(nk + c + kStages);
    }
#pragma unroll
    for (int nt = 0; nt < NTS; ++nt)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        store4(part + (size_t)qq * qstride +
                   (((nt * 2 + hh) * MT + mt) * 32 + lane) * 4,
               acc[nt][mt]);
  }

  // 6. The cluster's l (live-prefix) or int8 code sum of each query row,
  //    then the partials summed over the cluster.
  sum_quarters(part, qstride);
  if constexpr (F == kDynlen || C == kInt8) {
    for (int g = warp; g < G; g += kWarps) {
      float mine = 0.0f;
      if (lane < nsplit) {
        if constexpr (F == kDynlen)
          mine = *tc::cluster_map(&xsum[g], lane);
        else
          mine = *tc::cluster_map(&xcodes[g], lane);
      }
      float tot = 0.0f;
      for (int r = 0; r < nsplit; ++r)
        tot = tot + __shfl_sync(0xffffffffu, mine, r);
      if (lane == 0) xtot[g] = tot;
    }
    __syncthreads();
  }
  // The stale form adds the new column last, as the plain version: p_cur's
  // operand times v_new (int8: its code, in int32, and the code into the
  // code sum).
  const int8_t* vnew = a.v_new + (size_t)row * H;
  gather_partials<H>(part, G, qstride, [&](int g, int h, AccT acc) {
    float y;
    if constexpr (F == kDynlen) {
      y = (acc * (1.0f / kPScale) / fmaxf(xtot[g], 1e-30f) - a.zp_v) *
          a.v_scale;
    } else if constexpr (C == kInt8) {
      float codes = xtot[g];
      if constexpr (F == kStale) {
        acc = acc + (int)cur[g] * (int)vnew[h];
        codes = codes + cur[g];
      }
      y = finish_ctx<C>((float)acc, fmaxf(codes, 1.0f), a.zp_v, a.v_scale);
    } else {
      float ctx = acc * (1.0f / kPScale);
      if constexpr (F == kStale) ctx = ctx + cur[g] * (float)vnew[h];
      y = finish_ctx<C>(ctx, 1.0f, a.zp_v, a.v_scale);
    }
    store_out(a, ((size_t)row * G + g) * H + h, y);
  });

  // The splice form's row write: the CTA holding row p, after every read of
  // it (its bulk copies have all landed), writes the new rows into both
  // caches; no other CTA reads row p of this (batch, kv-head) row.
  if constexpr (F == kSplice) {
    if (sub >= 0 && tid < 2 * (H / 16)) {
      const bool is_v = tid >= H / 16;
      const int u = is_v ? tid - H / 16 : tid;
      const size_t at = ((size_t)row * S + s0 + sub) * H;
      reinterpret_cast<uint4*>(const_cast<int8_t*>(is_v ? a.v : a.k) + at)[u] =
          __ldg(reinterpret_cast<const uint4*>(is_v ? a.v_new : a.k_new) +
                (size_t)row * (H / 16) + u);
    }
  }
}

// ---- The int4-group body (#10) ----

// Bytes of a ring stage: a chunk's packed codes [kChunk][H / 2], then 2 NG
// strips [NG][kChunk] bf16 (a K chunk: its scales, then its mins; a V
// chunk: its scales in the first NG).
__host__ __device__ inline size_t g4_stage(int H, int NG) {
  return (size_t)kChunk * (H / 2) + (size_t)4 * NG * kChunk;
}

// Byte offsets of an int4-group CTA's shared memory: the ring (after the
// last V chunk, the row quarters' context partials), a K chunk's codes
// padded (kpad), bf16(q) as f32 rows [8 nt][H + 4], the f32 group sums
// [G][NG], the scores [G][T + 4], the cluster's maxima and sums, the
// stages' mbarriers.
struct Layout4 {
  size_t ring, kpad, q, qsum, sc, xmax, xsum, bars, bytes;
};

__host__ __device__ inline Layout4 layout4(int G, int H, int NG, int T) {
  const size_t nt = (size_t)(G + 7) / 8;
  const size_t ring = (size_t)kStages * g4_stage(H, NG);
  const size_t parts = (size_t)128 * nt * H;
  Layout4 L;
  L.ring = 0;
  L.kpad = up16(ring > parts ? ring : parts);
  L.q = up16(L.kpad + kpad_bytes(H / 2));
  L.qsum = up16(L.q + 8 * nt * (H + 4) * 4);
  L.sc = up16(L.qsum + (size_t)G * NG * 4);
  L.xmax = up16(L.sc + (size_t)G * sc_pitch(T) * 4);
  L.xsum = up16(L.xmax + (size_t)G * 4);
  L.bars = up16(L.xsum + (size_t)G * 4);
  L.bytes = L.bars + 8 * kStages;
  return L;
}

struct Int4GroupSmem {
  int G, H, NG;
  size_t operator()(int T) const { return layout4(G, H, NG, T).bytes; }
};

// Whether the int4-group body takes a shape: the int8 forms' terms, S a
// multiple of 8 (a strip's copy, whole 16-byte units, stays inside S).
inline bool takes_int4g(int R, int G, int S, int H, int group) {
  return head_dim_fits(H) && group > 0 && S % 8 == 0 &&
         takes_rows(Int4GroupSmem{G, H, H / group}, R, G, S);
}

__device__ __forceinline__ uint32_t bf2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ __nv_bfloat162 bits_bf2(uint32_t v) {
  return *reinterpret_cast<const __nv_bfloat162*>(&v);
}

// The K operand pair of two unsigned codes (bits 0-3 and 16-19 of x, other
// bits ignored) and their scales s2 (m2 = -128 * s2): 0x4300 | code is the
// bf16 128 + code, and (128 + code) * s - 128 * s is code * s, rounded once.
__device__ __forceinline__ uint32_t k_pair(uint32_t x, uint32_t s2,
                                           uint32_t m2) {
  const uint32_t c = (x & 0x000F000Fu) | 0x43004300u;
  return bf2_bits(__hfma2(bits_bf2(c), bits_bf2(s2), bits_bf2(m2)));
}

// Two signed codes (nibbles at bits 0-3 and 16-19 of y, (u ^ 8) - 8) as a
// bf16 pair, exactly: 0x4300 | (u ^ 8) is 136 + the code, less 136.
__device__ __forceinline__ uint32_t code_pair(uint32_t y) {
  const uint32_t c = (y & 0x000F000Fu) ^ 0x43084308u;
  return bf2_bits(__hsub2(bits_bf2(c), bits_bf2(0x43084308u)));
}

// The V operand pair of two signed codes and their scales: the codes
// (code_pair) times the scales, rounded once.
__device__ __forceinline__ uint32_t v_pair(uint32_t y, uint32_t s2) {
  return bf2_bits(__hmul2(bits_bf2(code_pair(y)), bits_bf2(s2)));
}

// Step 2: bf16(q) of the query rows as f32 rows qf [8 nt][H + 4] (zeros
// past G), and the f32 group sums qsum [G][NG] of bf16(q) (columns in a
// lane in order, then the lanes of a group by a butterfly: a sum of bf16
// values, exact but where they span more than 24 bits); one warp a query
// row.
template <int H>
__device__ __forceinline__ void stage_queries_g4(const float* __restrict__ qr,
                                                 int G, int NG, int group,
                                                 float* qf, float* qsum,
                                                 float (&x)[H / 32]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int g = warp; g < 8 * ((G + 7) >> 3); g += kWarps) {
    if (g != warp) load_query<H>(qr, G, g, x);
    float run = 0.0f;  // a group wider than 32 columns: its sum so far
#pragma unroll
    for (int i = 0; i < H / 32; ++i) {
      float v = __bfloat162float(__float2bfloat16_rn(x[i]));
      qf[g * (H + 4) + lane + 32 * i] = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1)
        if (o < group) v = v + __shfl_xor_sync(0xffffffffu, v, o);
      if (g >= G) continue;
      if (group <= 32) {
        if (lane % group == 0) qsum[g * NG + (32 * i + lane) / group] = v;
      } else {
        run = run + v;
        if ((32 * (i + 1)) % group == 0) {
          if (lane == 0) qsum[g * NG + 32 * i / group] = run;
          run = 0.0f;
        }
      }
    }
  }
}

// Step 3: the scores of one chunk (slice rows [j0, j0 + kChunk): codes in
// kpad, scales and mins in ring stage `st`), by Chain's lanes: bf16(q) . K
// one f32 FMA chain over h = 0 .. H - 1 (K[j, h] = bf16(kcode * kscale),
// formed two at a time by k_pair; the products are exact), the offset
// sum_n qsum[g, n] * kmin[n, j] one more over n, then (dot + offset) *
// inv_sqrt_h: the plain version's order on the card. KG = min(group, 16).
template <int H, int NTS, int KG>
__device__ __forceinline__ void score_chunk_g4(const Args& a,
                                               const uint8_t* kpad,
                                               const uint8_t* st,
                                               const float* qf,
                                               const float* qsum, float* sc,
                                               int j0, int kr, int NG) {
  using CH = Chain<NTS>;
  constexpr int QP = H + 4, NQ = CH::NQ, RB = H / 2, NS = 16 / KG;
  const int G = a.G, P = sc_pitch(a.rows), shift = a.shift;
  const int j = CH::row(), g0 = CH::g0();
  if (j0 + (j & ~31) >= kr || g0 >= G) return;  // warp-uniform
  const uint8_t* krow = kpad + (size_t)j * (RB + kKPad);
  const uint16_t* ksc = reinterpret_cast<const uint16_t*>(st + kChunk * RB);
  const uint16_t* kmn = ksc + NG * kChunk;
  const __nv_bfloat162 m128 = __floats2bfloat162_rn(-128.0f, -128.0f);
  float acc[NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) acc[i] = 0.0f;
  for (int hf = 0; hf < 2; ++hf) {  // the low nibbles, then the high ones
#pragma unroll 2
    for (int b0 = 0; b0 < RB; b0 += 16) {
      const uint4 w = *reinterpret_cast<const uint4*>(krow + b0);
      const uint32_t words[4] = {w.x, w.y, w.z, w.w};
      uint32_t sv[NS];  // the 16 bytes' scales, KG bytes each
#pragma unroll
      for (int k = 0; k < NS; ++k)
        sv[k] = ksc[(hf * (NG / 2) + ((b0 + k * KG) >> shift)) * kChunk + j];
#pragma unroll
      for (int wi = 0; wi < 4; ++wi) {
        const int b = 4 * wi;  // bytes b .. b + 3 of the 16
        const uint32_t x = hf ? words[wi] >> 4 : words[wi];
        const uint32_t s02 = sv[b / KG] | sv[(b + 2) / KG] << 16;
        const uint32_t s13 = sv[(b + 1) / KG] | sv[(b + 3) / KG] << 16;
        const uint32_t p02 = k_pair(x, s02,
                                    bf2_bits(__hmul2(bits_bf2(s02), m128)));
        const uint32_t p13 = k_pair(x >> 8, s13,
                                    bf2_bits(__hmul2(bits_bf2(s13), m128)));
        const float kf[4] = {__uint_as_float(p02 << 16),
                             __uint_as_float(p13 << 16),
                             __uint_as_float(p02 & 0xFFFF0000u),
                             __uint_as_float(p13 & 0xFFFF0000u)};
        const int h = hf * RB + b0 + b;
#pragma unroll
        for (int i = 0; i < NQ; ++i) {  // rows past G: zeros
          const float4 qv =
              *reinterpret_cast<const float4*>(qf + (g0 + i) * QP + h);
          acc[i] = __fmaf_rn(qv.x, kf[0], acc[i]);
          acc[i] = __fmaf_rn(qv.y, kf[1], acc[i]);
          acc[i] = __fmaf_rn(qv.z, kf[2], acc[i]);
          acc[i] = __fmaf_rn(qv.w, kf[3], acc[i]);
        }
      }
    }
  }
  if (j0 + j < kr) {
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const int g = g0 + i;
      if (g < G) {
        float off = 0.0f;
        for (int n = 0; n < NG; ++n)
          off = __fmaf_rn(qsum[g * NG + n],
                          __uint_as_float((uint32_t)kmn[n * kChunk + j]
                                          << 16),
                          off);
        sc[g * P + j0 + j] = (acc[i] + off) * a.ks;
      }
    }
  }
}

// Step 5: the partial context of rows [j0, j1) of the chunk in stage `st`
// (k16 steps; sc points at the chunk's first score column) for the warp's
// nibble half hh (columns hh H / 2 + the bytes [grp W, grp W + W), W =
// H / 16): A = V^T, bf16(vcode * vscale), the rows of a k-step 4t .. 4t + 3
// from four loads and one 8-byte scale load a block; B = bf16 p. KG =
// min(group, 16).
template <int H, int NTS, int KG>
__device__ __forceinline__ void context_g4(const uint8_t* st, const float* sc,
                                           int G, int P, int j0, int j1,
                                           int hh, int NG, int shift,
                                           float (&acc)[NTS][H / 32][4]) {
  constexpr int W = H / 16, MT = H / 32, KGV = KG < W ? KG : W;
  const int lane = threadIdx.x & 31, grp = lane >> 2, t = lane & 3;
  const int nts = (G + 7) >> 3;
  const int b0 = grp * W;  // the thread's first byte of a row
  const uint16_t* vsc = reinterpret_cast<const uint16_t*>(st + kChunk * H / 2);
  int strip[W / KGV];
#pragma unroll
  for (int bk = 0; bk < W / KGV; ++bk)
    strip[bk] = (hh * (NG / 2) + ((b0 + bk * KGV) >> shift)) * kChunk;
  for (int jb = j0; jb < j1; jb += 16) {
    uint32_t r[4][W < 4 ? 1 : W / 4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      load_row<W>(reinterpret_cast<const int8_t*>(st) +
                      (size_t)(jb + 4 * t + i) * (H / 2) + b0,
                  r[i]);
    uint32_t s01[W / KGV], s23[W / KGV];
#pragma unroll
    for (int bk = 0; bk < W / KGV; ++bk) {
      const uint2 sv = *reinterpret_cast<const uint2*>(vsc + strip[bk] + jb +
                                                       4 * t);
      s01[bk] = sv.x;
      s23[bk] = sv.y;
    }
    uint32_t pb0[NTS], pb1[NTS];
#pragma unroll
    for (int nt = 0; nt < NTS; ++nt) {
      const int g = 8 * nt + grp;
      float4 pv = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (nt < nts && g < G)
        pv = *reinterpret_cast<const float4*>(sc + g * P + jb + 4 * t);
      pb0[nt] = bf2_bits(__floats2bfloat162_rn(pv.x, pv.y));
      pb1[nt] = bf2_bits(__floats2bfloat162_rn(pv.z, pv.w));
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int wi = mt >> 1;
      uint32_t x01, x23;
      if (mt & 1) {
        x01 = pair_rows<2>(r[0][wi], r[1][wi]);
        x23 = pair_rows<2>(r[2][wi], r[3][wi]);
      } else {
        x01 = pair_rows<0>(r[0][wi], r[1][wi]);
        x23 = pair_rows<0>(r[2][wi], r[3][wi]);
      }
      if (hh) {  // the high nibbles
        x01 >>= 4;
        x23 >>= 4;
      }
      const int ba = (2 * mt) / KGV, bb = (2 * mt + 1) / KGV;
      const uint32_t a0 = v_pair(__byte_perm(x01, 0, 0x4140), s01[ba]);
      const uint32_t a1 = v_pair(__byte_perm(x01, 0, 0x4342), s01[bb]);
      const uint32_t a2 = v_pair(__byte_perm(x23, 0, 0x4140), s23[ba]);
      const uint32_t a3 = v_pair(__byte_perm(x23, 0, 0x4342), s23[bb]);
#pragma unroll
      for (int nt = 0; nt < NTS; ++nt)
        if (nt < nts) mma_bf16(acc[nt][mt], a0, a1, a2, a3, pb0[nt], pb1[nt]);
    }
  }
}

// The int4-group kernel's body (#10): the lengths form's rows and
// softmax with bf16 probabilities, the scores and context above. KG =
// min(group, 16).
template <int H, int NTS, int KG>
__device__ __forceinline__ void attend_int4g(const Args& a) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int G = a.G, S = a.S, T = a.rows, P = sc_pitch(T);
  const int NG = H >> a.shift, group = 1 << a.shift;
  const Layout4 L = layout4(G, H, NG, T);
  const size_t stage = g4_stage(H, NG);
  uint8_t* ring = smem + L.ring;
  uint8_t* kpad = smem + L.kpad;
  float* qf = reinterpret_cast<float*>(smem + L.q);
  float* qsum = reinterpret_cast<float*>(smem + L.qsum);
  float* sc = reinterpret_cast<float*>(smem + L.sc);
  float* xmax = reinterpret_cast<float*>(smem + L.xmax);
  float* xsum = reinterpret_cast<float*>(smem + L.xsum);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  float* part = reinterpret_cast<float*>(smem + L.ring);  // after the last V

  const int me = blockIdx.x, row = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int s0 = me * T;
  const int here = min(max(S - s0, 0), T);
  const int len = a.lengths[row / a.NK];
  const int kr = len > 0 ? min(max(min(len, S) - s0, 0), here) : 0;
  const int vr = len > 0 ? kr : here;

  // 1. Loads: a chunk's codes one bulk copy, each strip one more (lanes of
  //    warp 0), its rows rounded up to 8 (inside S: S % 8 == 0).
  const int nk = (kr + kChunk - 1) / kChunk, nv = (vr + kChunk - 1) / kChunk;
  const int H2 = H / 2;
  auto issue_load = [&](int i) {
    if (i >= nk + nv) return;
    const bool is_v = i >= nk;
    const int c = is_v ? i - nk : i;
    const int n = min((is_v ? vr : kr) - c * kChunk, kChunk);
    const int n8 = (n + 7) & ~7;
    const int strips = is_v ? NG : 2 * NG, first = is_v ? 2 * NG : 0;
    uint64_t* bar = &bars[i % kStages];
    uint8_t* dst = ring + (i % kStages) * stage;
    const int j = s0 + c * kChunk;
    if (lane == 0) {
      tc::mbar_expect_tx(bar, (uint32_t)(n * H2 + strips * n8 * 2));
      tc::bulk_load(dst, (is_v ? a.v : a.k) + ((size_t)row * S + j) * H2,
                    (uint32_t)(n * H2), bar);
    }
    __syncwarp();
    for (int sidx = lane; sidx < strips; sidx += 32)
      tc::bulk_load(dst + kChunk * H2 + (size_t)sidx * kChunk * 2,
                    a.sidecar + ((size_t)row * 3 * NG + first + sidx) * S + j,
                    (uint32_t)(n8 * 2), bar);
  };
  auto await_load = [&](int i) {
    tc::mbar_wait(&bars[i % kStages], (uint32_t)(i / kStages) & 1);
  };
  const float* qr = a.q + (size_t)row * G * H;
  float xq[H / 32];
  load_query<H>(qr, G, warp, xq);
  // The strips' rows past a copy are read (times p = 0) by the last k-step
  // of a V chunk: zeros before the first copies, earlier strips after.
  for (int s = 0; s < kStages; ++s)
    for (size_t i = kChunk * H2 + 16 * tid; i < stage; i += 16 * kThreads)
      *reinterpret_cast<uint4*>(ring + s * stage + i) = make_uint4(0, 0, 0, 0);
  tc::fence_proxy_async();
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) tc::mbar_init(&bars[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (warp == 0)
    for (int i = 0; i < kStages; ++i) issue_load(i);

  // 2. Query operands.
  stage_queries_g4<H>(qr, G, NG, group, qf, qsum, xq);
  __syncthreads();

  // 3. Scores: the chunk's codes padded, then the chains.
  for (int c = 0; c < nk; ++c) {
    await_load(c);
    const uint8_t* st = ring + (c % kStages) * stage;
    pad_rows<H / 2>(st, kpad, min(kr - c * kChunk, kChunk));
    __syncthreads();
    score_chunk_g4<H, NTS, KG>(a, kpad, st, qf, qsum, sc, c * kChunk, kr,
                               NG);
    __syncthreads();  // the stage and kpad are read
    if (warp == 0) issue_load(c + kStages);
  }
  __syncthreads();

  // 4. Softmax across the cluster: bf16 probabilities.
  softmax_cluster<kLengths, kBF16>(sc, G, P, T, kr, vr, xmax, xsum, nullptr);
  __syncthreads();

  // 5. The slice's context: warp (hh, qq) takes the nibble half hh and rows
  //    [32 qq, 32 qq + 32) of each chunk.
  constexpr int MT = H / 32;
  const int qstride = ((G + 7) >> 3) * 8 * H;
  {
    const int hh = warp & 1, qq = warp >> 1;
    float acc[NTS][MT][4];
#pragma unroll
    for (int nt = 0; nt < NTS; ++nt)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][mt][i] = 0.0f;
    for (int c = 0; c < nv; ++c) {
      await_load(nk + c);
      const int j0 = 32 * qq, j1 = min(j0 + 32, vr - c * kChunk);
      context_g4<H, NTS, KG>(ring + ((nk + c) % kStages) * stage,
                             sc + c * kChunk, G, P, j0, j1, hh, NG, a.shift,
                             acc);
      __syncthreads();  // the stage is read
      if (warp == 0) issue_load(nk + c + kStages);
    }
#pragma unroll
    for (int nt = 0; nt < NTS; ++nt)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        store4(part + (size_t)qq * qstride +
                   (((nt * 2 + hh) * MT + mt) * 32 + lane) * 4,
               acc[nt][mt]);
  }

  // 6. The partials summed over the cluster: the context as it is.
  sum_quarters(part, qstride);
  gather_partials<H>(part, G, qstride, [&](int g, int h, float acc) {
    store_out(a, ((size_t)row * G + g) * H + h, acc);
  });
}

// ---- The per-row int4 body (#21) ----

// Bytes of a ring stage: a chunk's packed codes [kChunk][H / 2], then its
// rows' scales [kChunk] bf16 (a K chunk: the K scales, row 0 of kv_scales;
// a V chunk: the V scales, row 1).
__host__ __device__ inline size_t r4_stage(int H) {
  return (size_t)kChunk * (H / 2) + (size_t)2 * kChunk;
}

// Byte offsets of a per-row int4 CTA's shared memory: the ring (after the
// last V chunk, the row quarters' context partials), a K chunk's codes
// padded (kpad), bf16(q) as f32 rows [8 nt][H + 4], the scores [G][T + 4],
// the cluster's maxima and sums, the stages' mbarriers.
struct Layout4r {
  size_t ring, kpad, q, sc, xmax, xsum, bars, bytes;
};

__host__ __device__ inline Layout4r layout4r(int G, int H, int T) {
  const size_t nt = (size_t)(G + 7) / 8;
  const size_t ring = (size_t)kStages * r4_stage(H);
  const size_t parts = (size_t)128 * nt * H;
  Layout4r L;
  L.ring = 0;
  L.kpad = up16(ring > parts ? ring : parts);
  L.q = up16(L.kpad + kpad_bytes(H / 2));
  L.sc = up16(L.q + 8 * nt * (H + 4) * 4);
  L.xmax = up16(L.sc + (size_t)G * sc_pitch(T) * 4);
  L.xsum = up16(L.xmax + (size_t)G * 4);
  L.bars = up16(L.xsum + (size_t)G * 4);
  L.bytes = L.bars + 8 * kStages;
  return L;
}

struct Int4RowSmem {
  int G, H;
  size_t operator()(int T) const { return layout4r(G, H, T).bytes; }
};

// Whether the per-row int4 body takes a shape: the int8 forms' terms, S a
// multiple of 8 (a scale strip's copy, whole 16-byte units, stays inside S,
// and row 1 of kv_scales starts 16-byte aligned).
inline bool takes_int4r(int R, int G, int S, int H) {
  return head_dim_fits(H) && S % 8 == 0 &&
         takes_rows(Int4RowSmem{G, H}, R, G, S);
}

// Step 2: bf16(q) of the query rows as f32 rows qf [8 nt][H + 4] (zeros
// past G); one warp a query row.
template <int H>
__device__ __forceinline__ void stage_queries_r4(const float* __restrict__ qr,
                                                 int G, float* qf,
                                                 float (&x)[H / 32]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int g = warp; g < 8 * ((G + 7) >> 3); g += kWarps) {
    if (g != warp) load_query<H>(qr, G, g, x);
#pragma unroll
    for (int i = 0; i < H / 32; ++i)
      qf[g * (H + 4) + lane + 32 * i] =
          __bfloat162float(__float2bfloat16_rn(x[i]));
  }
}

// Step 3: the scores of one chunk (slice rows [j0, j0 + kChunk): codes in
// kpad, K scales in ring stage `st`), by Chain's lanes: bf16(q) over the
// low half of H against the low nibbles, one f32 FMA chain over h = 0 ..
// H/2 - 1, and over the high half against the high nibbles, another (the
// plain version's two matmuls on the card); then ((lo + hi) * kscale[j]) *
// inv_sqrt_h.
template <int H, int NTS>
__device__ __forceinline__ void score_chunk_r4(const Args& a,
                                               const uint8_t* kpad,
                                               const uint8_t* st,
                                               const float* qf, float* sc,
                                               int j0, int kr) {
  using CH = Chain<NTS>;
  constexpr int QP = H + 4, NQ = CH::NQ, RB = H / 2;
  const int G = a.G, P = sc_pitch(a.rows);
  const int j = CH::row(), g0 = CH::g0();
  if (j0 + (j & ~31) >= kr || g0 >= G) return;  // warp-uniform
  const uint8_t* krow = kpad + (size_t)j * (RB + kKPad);
  float acc[2][NQ];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int i = 0; i < NQ; ++i) acc[hf][i] = 0.0f;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {  // the low nibbles, then the high ones
#pragma unroll 2
    for (int b0 = 0; b0 < RB; b0 += 16) {
      const uint4 w = *reinterpret_cast<const uint4*>(krow + b0);
      const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int wi = 0; wi < 4; ++wi) {
        const uint32_t x = hf ? words[wi] >> 4 : words[wi];
        const uint32_t p02 = code_pair(x), p13 = code_pair(x >> 8);
        const float kf[4] = {__uint_as_float(p02 << 16),
                             __uint_as_float(p13 << 16),
                             __uint_as_float(p02 & 0xFFFF0000u),
                             __uint_as_float(p13 & 0xFFFF0000u)};
        const int h = hf * RB + b0 + 4 * wi;
#pragma unroll
        for (int i = 0; i < NQ; ++i) {  // rows past G: zeros
          const float4 qv =
              *reinterpret_cast<const float4*>(qf + (g0 + i) * QP + h);
          acc[hf][i] = __fmaf_rn(qv.x, kf[0], acc[hf][i]);
          acc[hf][i] = __fmaf_rn(qv.y, kf[1], acc[hf][i]);
          acc[hf][i] = __fmaf_rn(qv.z, kf[2], acc[hf][i]);
          acc[hf][i] = __fmaf_rn(qv.w, kf[3], acc[hf][i]);
        }
      }
    }
  }
  if (j0 + j < kr) {
    const uint16_t* ksc = reinterpret_cast<const uint16_t*>(st + kChunk * RB);
    const float ks = __uint_as_float((uint32_t)ksc[j] << 16);
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const int g = g0 + i;
      if (g < G) {
        const float dot = acc[0][i] + acc[1][i];
        const float scaled = dot * ks;
        sc[g * P + j0 + j] = scaled * a.ks;
      }
    }
  }
}

// Step 5: the partial context of rows [j0, j1) of the chunk in stage `st`
// (k16 steps; sc points at the chunk's first column of probabilities) for
// the warp's nibble half hh (columns hh H / 2 + the bytes [grp W, grp W +
// W), W = H / 16): A = V^T, the codes widened to bf16 exactly (code_pair),
// the rows of a k-step 4t .. 4t + 3 from four loads; B = bf16(p * vscale),
// the product rounded in f32, then to bf16, with one 8-byte scale load a
// k-step.
template <int H, int NTS>
__device__ __forceinline__ void context_r4(const uint8_t* st, const float* sc,
                                           int G, int P, int j0, int j1,
                                           int hh,
                                           float (&acc)[NTS][H / 32][4]) {
  constexpr int W = H / 16, MT = H / 32;
  const int lane = threadIdx.x & 31, grp = lane >> 2, t = lane & 3;
  const int nts = (G + 7) >> 3;
  const int b0 = grp * W;  // the thread's first byte of a row
  const uint16_t* vsc = reinterpret_cast<const uint16_t*>(st + kChunk * H / 2);
  for (int jb = j0; jb < j1; jb += 16) {
    uint32_t r[4][W < 4 ? 1 : W / 4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      load_row<W>(reinterpret_cast<const int8_t*>(st) +
                      (size_t)(jb + 4 * t + i) * (H / 2) + b0,
                  r[i]);
    const uint2 sv = *reinterpret_cast<const uint2*>(vsc + jb + 4 * t);
    const float vs[4] = {__uint_as_float(sv.x << 16),
                         __uint_as_float(sv.x & 0xFFFF0000u),
                         __uint_as_float(sv.y << 16),
                         __uint_as_float(sv.y & 0xFFFF0000u)};
    uint32_t pb0[NTS], pb1[NTS];
#pragma unroll
    for (int nt = 0; nt < NTS; ++nt) {
      const int g = 8 * nt + grp;
      float4 pv = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (nt < nts && g < G)
        pv = *reinterpret_cast<const float4*>(sc + g * P + jb + 4 * t);
      pb0[nt] = bf2_bits(__floats2bfloat162_rn(__fmul_rn(pv.x, vs[0]),
                                               __fmul_rn(pv.y, vs[1])));
      pb1[nt] = bf2_bits(__floats2bfloat162_rn(__fmul_rn(pv.z, vs[2]),
                                               __fmul_rn(pv.w, vs[3])));
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int wi = mt >> 1;
      uint32_t x01, x23;
      if (mt & 1) {
        x01 = pair_rows<2>(r[0][wi], r[1][wi]);
        x23 = pair_rows<2>(r[2][wi], r[3][wi]);
      } else {
        x01 = pair_rows<0>(r[0][wi], r[1][wi]);
        x23 = pair_rows<0>(r[2][wi], r[3][wi]);
      }
      if (hh) {  // the high nibbles
        x01 >>= 4;
        x23 >>= 4;
      }
      const uint32_t a0 = code_pair(__byte_perm(x01, 0, 0x4140));
      const uint32_t a1 = code_pair(__byte_perm(x01, 0, 0x4342));
      const uint32_t a2 = code_pair(__byte_perm(x23, 0, 0x4140));
      const uint32_t a3 = code_pair(__byte_perm(x23, 0, 0x4342));
#pragma unroll
      for (int nt = 0; nt < NTS; ++nt)
        if (nt < nts) mma_bf16(acc[nt][mt], a0, a1, a2, a3, pb0[nt], pb1[nt]);
    }
  }
}

// The per-row int4 kernel's body (#21): the lengths form's rows, its
// softmax with f32 probabilities, the scores and context above; a.sidecar
// is kv_scales [R, 8, S] bf16.
template <int H, int NTS>
__device__ __forceinline__ void attend_int4r(const Args& a) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int G = a.G, S = a.S, T = a.rows, P = sc_pitch(T);
  const Layout4r L = layout4r(G, H, T);
  const size_t stage = r4_stage(H);
  uint8_t* ring = smem + L.ring;
  uint8_t* kpad = smem + L.kpad;
  float* qf = reinterpret_cast<float*>(smem + L.q);
  float* sc = reinterpret_cast<float*>(smem + L.sc);
  float* xmax = reinterpret_cast<float*>(smem + L.xmax);
  float* xsum = reinterpret_cast<float*>(smem + L.xsum);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  float* part = reinterpret_cast<float*>(smem + L.ring);  // after the last V

  const int me = blockIdx.x, row = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int s0 = me * T;
  const int here = min(max(S - s0, 0), T);
  const int len = a.lengths[row / a.NK];
  const int kr = len > 0 ? min(max(min(len, S) - s0, 0), here) : 0;
  const int vr = len > 0 ? kr : here;

  // 1. Loads: a chunk's codes one bulk copy and its scales one more, its
  //    rows rounded up to 8 (inside S: S % 8 == 0).
  const int nk = (kr + kChunk - 1) / kChunk, nv = (vr + kChunk - 1) / kChunk;
  const int H2 = H / 2;
  auto issue_load = [&](int i) {
    if (i >= nk + nv) return;
    const bool is_v = i >= nk;
    const int c = is_v ? i - nk : i;
    const int n = min((is_v ? vr : kr) - c * kChunk, kChunk);
    const int n8 = (n + 7) & ~7;
    uint64_t* bar = &bars[i % kStages];
    uint8_t* dst = ring + (i % kStages) * stage;
    const int j = s0 + c * kChunk;
    tc::mbar_expect_tx(bar, (uint32_t)(n * H2 + n8 * 2));
    tc::bulk_load(dst, (is_v ? a.v : a.k) + ((size_t)row * S + j) * H2,
                  (uint32_t)(n * H2), bar);
    tc::bulk_load(dst + kChunk * H2,
                  a.sidecar + ((size_t)row * 8 + (is_v ? 1 : 0)) * S + j,
                  (uint32_t)(n8 * 2), bar);
  };
  auto await_load = [&](int i) {
    tc::mbar_wait(&bars[i % kStages], (uint32_t)(i / kStages) & 1);
  };
  const float* qr = a.q + (size_t)row * G * H;
  float xq[H / 32];
  load_query<H>(qr, G, warp, xq);
  // The scales past a copy are read (times p = 0) by the last k-step of a
  // V chunk: zeros before the first copies, earlier scales after.
  for (int s = 0; s < kStages; ++s)
    for (size_t i = kChunk * H2 + 16 * tid; i < stage; i += 16 * kThreads)
      *reinterpret_cast<uint4*>(ring + s * stage + i) = make_uint4(0, 0, 0, 0);
  tc::fence_proxy_async();
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) tc::mbar_init(&bars[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int i = 0; i < kStages; ++i) issue_load(i);

  // 2. Query operands.
  stage_queries_r4<H>(qr, G, qf, xq);
  __syncthreads();

  // 3. Scores: the chunk's codes padded, then the chains.
  for (int c = 0; c < nk; ++c) {
    await_load(c);
    const uint8_t* st = ring + (c % kStages) * stage;
    pad_rows<H / 2>(st, kpad, min(kr - c * kChunk, kChunk));
    __syncthreads();
    score_chunk_r4<H, NTS>(a, kpad, st, qf, sc, c * kChunk, kr);
    __syncthreads();  // the stage and kpad are read
    if (tid == 0) issue_load(c + kStages);
  }
  __syncthreads();

  // 4. Softmax across the cluster: f32 probabilities.
  softmax_cluster<kLengths, kF32>(sc, G, P, T, kr, vr, xmax, xsum, nullptr);
  __syncthreads();

  // 5. The slice's context: warp (hh, qq) takes the nibble half hh and rows
  //    [32 qq, 32 qq + 32) of each chunk.
  constexpr int MT = H / 32;
  const int qstride = ((G + 7) >> 3) * 8 * H;
  {
    const int hh = warp & 1, qq = warp >> 1;
    float acc[NTS][MT][4];
#pragma unroll
    for (int nt = 0; nt < NTS; ++nt)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][mt][i] = 0.0f;
    for (int c = 0; c < nv; ++c) {
      await_load(nk + c);
      const int j0 = 32 * qq, j1 = min(j0 + 32, vr - c * kChunk);
      context_r4<H, NTS>(ring + ((nk + c) % kStages) * stage, sc + c * kChunk,
                         G, P, j0, j1, hh, acc);
      __syncthreads();  // the stage is read
      if (tid == 0) issue_load(nk + c + kStages);
    }
#pragma unroll
    for (int nt = 0; nt < NTS; ++nt)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        store4(part + (size_t)qq * qstride +
                   (((nt * 2 + hh) * MT + mt) * 32 + lane) * 4,
               acc[nt][mt]);
  }

  // 6. The partials summed over the cluster: the context as it is.
  sum_quarters(part, qstride);
  gather_partials<H>(part, G, qstride, [&](int g, int h, float acc) {
    store_out(a, ((size_t)row * G + g) * H + h, acc);
  });
}

// Launches `kernel` under plan p for R rows.
inline int launch(Kernel kernel, Args a, const Plan& p, int R,
                  cudaStream_t stream) {
  a.rows = p.rows;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t config = launch_config(p, R, &attr, stream);
  return (int)cudaLaunchKernelEx(&config, kernel, a);
}

}  // namespace split
}  // namespace aeqt
