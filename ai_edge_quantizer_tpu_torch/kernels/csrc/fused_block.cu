// Fused decode block: MLP(l-1) + both RMS norms + QKV(l) + RoPE + the new
// K/V row's int8 quantization + stale-cache attention(l), and the write of
// the new row into the cache pools, in one cooperative launch.
//
// Replaces: ai_edge_quantizer_tpu/kernels/pallas_block.py
//   fused_mlp_qkv_attention (_kernel_impl), f32 attention compute. Per
//   batch row b (x_res [B, D] f32 or bf16):
//     xq1, xs1 = rmsnorm_quant(x_res, g1)
//     per F-tile t of bf columns: gate, up = (acc * xs1) * s (packed int4),
//       h = act(gate) * up, hq, hs = DRQ of h's tile, acc += part * hs
//     x_ffn = x_res + acc * s_d                          (kept in f32)
//     xq2, xs2 = rmsnorm_quant(x_ffn, g2); qkv = (acc * xs2) * s_qkv
//     q, k = half-split RoPE of the NQ query heads and of K; v = V
//     k_new = clip(rint(k * (1/kq)), -127, 127); v_new likewise
//     ctx = stale attention over the cache rows < lengths[b] - 1 plus the
//           inline new column (aeqt::stale_attention_row)
//   and row clamp(pos, 0, S - 1) of k_pool[b] and v_pool[b] becomes
//   k_new[b] and v_new[b] (the TPU kernel's aliased outputs). The TPU
//   kernel's ring prefetch (`bb`, `ring`) and dirty-tile writeback are
//   VMEM and DMA choices with no counterpart here, and so is its writeback
//   race (a ring slot refilled, pallas_block.py:367, before the slot's
//   tile is read, :385-388): each block writes row pos of its own batch
//   row after its own reads of that row.
//
// Bound on the H100: at the bench shape (Gemma-2B: D 2048, F 16384, NQ 8,
//   H 256; B 256, S 1024, 897 live rows) one unit reads 32 MiB of gate/up,
//   16 MiB of down and 2.5 MiB of QKV weights and about 117 MB of live
//   K/V rows: about 0.051 ms at 3.35 TB/s. Its int8 work (54 GOP) takes
//   0.027 ms at the 1,979 TOP/s tensor-core peak and its f32 attention
//   (1.9 GFLOP) 0.028 ms at 67 TFLOP/s: bytes and operations about even.
//
// Design (simple first, deterministic; SIMT __dp4a as in the port's other
//   DRQ kernels, no tensor cores). CUDA blocks run in no order, so the TPU
//   kernel's sequential grid becomes seven stages of one persistent grid
//   (as many blocks as fit on the SMs at once, cudaLaunchCooperativeKernel)
//   separated by grid.sync(). Each stage's scratch (allocated by the
//   wrapper) is written once and read only after a sync:
//   1. norm 1 + DRQ: one warp per row -> xq1 int8 [B, D], xs1 [B].
//   2. gate/up + act: tiles of 16 rows x 64 hidden columns; each warp the
//      gate and up rows of 8 columns against xq1 staged in shared memory
//      (dot_packed) -> h f32 [B, F].
//   3. hidden DRQ: one warp per (row, F-tile) -> hq int8 [B, F], hs.
//   4. down + residual: tiles of 8 rows x 64 output columns; the rows of hq
//      are staged one F-tile at a time and each (row, column) adds
//      float(part) * hs in tile order in one lane, so the sum does not
//      depend on timing -> x_ffn (f32 scratch and the output dtype).
//   5. norm 2 + DRQ of x_ffn -> xq2, xs2.
//   6. QKV: tiles of 16 rows x 64 columns -> qkv f32 [B, (NQ + 2) H].
//   7. one block per batch row: RoPE into shared memory, k_new and v_new,
//      the stale attention, then row pos of the pools after the row's reads
//      (the stale contract never reads row pos for pos = lengths - 1, and
//      no other block touches the row).
//   Every product and sum is rounded on its own (--fmad=false) in the order
//   of the plain version (kernels/block.py), so the int8 codes equal it
//   bit for bit; gelu/silu, the norm, the DRQ dots and the attention body
//   are the device code of the MLP, qmatmul and stale kernels. It is far
//   from its bound: the int8 work runs on SIMT __dp4a, and the hidden
//   activations make a round trip through L2 (h 16 MiB, hq 4 MiB at the
//   bench shape). Tensor cores, keeping h on chip and an L2 prefetch of the
//   layer's cache under stages 1-6 are later work.
#include <cooperative_groups.h>

#include "attention_common.cuh"

namespace cg = cooperative_groups;

// The C entry point's argument, mirrored field by field by
// kernels/block.py (_Args).
struct FusedBlockArgs {
  const void* x;        // [B, D] f32 or bf16 (x_bf16)
  const float* g1;      // [D]
  const uint8_t* wgu;   // [2F, D/2] split-half packed: gate rows, up rows
  const float* sgu;     // [2F]
  const uint8_t* wd;    // [D, F/2] group-split packed, group bf
  const float* sd;      // [D]
  const float* g2;      // [D]
  const uint8_t* wqkv;  // [(NQ + 2) H, D/2] split-half packed
  const float* sqkv;    // [(NQ + 2) H]
  const float* cos;     // [B, H/2]
  const float* sin;     // [B, H/2]
  const int* lengths;   // [B], counting the new token
  const int* pos;       // [1], the shared write position
  int8_t* k_pool;       // [B, S, H]: rows < lengths - 1 read, row pos written
  int8_t* v_pool;       // [B, S, H]
  float* ctx;           // [B, NQ, H]
  void* x_ffn;          // [B, D] in x's dtype
  int8_t* k_new;        // [B, H]
  int8_t* v_new;        // [B, H]
  int8_t* xq1;          // scratch: [B, D]
  float* xs1;           // [B]
  float* hid;           // [B, F]
  int8_t* hq;           // [B, F]
  float* hs;            // [B, F / bf]
  float* xf;            // [B, D]
  int8_t* xq2;          // [B, D]
  float* xs2;           // [B]
  float* qkv;           // [B, (NQ + 2) H]
  int x_bf16, B, D, F, bf, NQ, H, S, act_silu;
  float eps, k_scale_eff, v_scale, zp_k, zp_v, kq_inv, vq_inv;
};

namespace {

using Args = FusedBlockArgs;

constexpr int kThreads = aeqt::kAttnThreads;  // the attention body's block
constexpr int kWarps = kThreads / 32;
constexpr int kMmBM = 16;  // rows of a gate/up or QKV tile
constexpr int kDownBM = 8;  // rows of a down tile
constexpr int kColsPerWarp = 8;
constexpr int kBN = kWarps * kColsPerWarp;  // columns of a tile

__device__ __forceinline__ int grid_warp() {
  return blockIdx.x * kWarps + (threadIdx.x >> 5);
}

// dst [BM][width] <- rows [m0, m0 + BM), columns [col0, col0 + width) of
// the row-major int8 matrix src with ld columns; rows past M are zeros.
// width, ld and col0 are multiples of 16.
template <int BM>
__device__ __forceinline__ void stage_rows(const int8_t* src, int ld,
                                           int col0, int width, int M,
                                           int m0, int8_t* dst) {
  for (int i = threadIdx.x * 16; i < BM * width; i += blockDim.x * 16) {
    const int r = i / width, col = i % width;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (m0 + r < M)
      v = *reinterpret_cast<const uint4*>(src + (size_t)(m0 + r) * ld + col0 +
                                          col);
    *reinterpret_cast<uint4*>(dst + i) = v;
  }
}

// Stages 1 and 5: one warp per row.
template <typename T>
__device__ __forceinline__ void norm_stage(const T* x, const float* gamma,
                                           const Args& a, int8_t* xq,
                                           float* xs) {
  const int lane = threadIdx.x & 31;
  for (int m = grid_warp(); m < a.B; m += gridDim.x * kWarps)
    aeqt::rmsnorm_quant_row(x + (size_t)m * a.D, gamma, a.D, a.eps,
                            xq + (size_t)m * a.D, xs + m, lane);
}

// One warp: the DRQ dot of kMmBM staged rows with packed weight row n,
// reduced; lane r < kMmBM gets row r's int32 sum.
__device__ __forceinline__ int packed_row_dot(const uint8_t* w, int n, int D,
                                              const int8_t* xq_s, int lane) {
  const int k2 = D / 2;
  int acc[kMmBM] = {};
  aeqt::dot_packed<kMmBM>(w + (size_t)n * k2, k2, xq_s, xq_s + k2, D, lane,
                          acc);
  aeqt::warp_reduce_rows<kMmBM>(acc);
  return aeqt::pick_row<kMmBM>(acc, lane);
}

// Stages 2 (gate/up + act, out = h [B, F]) and 6 (QKV, out = qkv): tiles of
// kMmBM rows x kBN columns of the N output columns, the row tile fastest so
// that the blocks sharing a weight tile run together.
template <bool kGateUp>
__device__ __forceinline__ void matmul_stage(const Args& a,
                                             unsigned char* smem) {
  const int8_t* xq = kGateUp ? a.xq1 : a.xq2;
  const float* xs = kGateUp ? a.xs1 : a.xs2;
  const uint8_t* w = kGateUp ? a.wgu : a.wqkv;
  const float* scale = kGateUp ? a.sgu : a.sqkv;
  float* out = kGateUp ? a.hid : a.qkv;
  const int N = kGateUp ? a.F : (a.NQ + 2) * a.H;
  int8_t* xq_s = reinterpret_cast<int8_t*>(smem);
  float* xs_s = reinterpret_cast<float*>(smem + (size_t)kMmBM * a.D);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mt = (a.B + kMmBM - 1) / kMmBM, nt = (N + kBN - 1) / kBN;
  for (int tile = blockIdx.x; tile < mt * nt; tile += gridDim.x) {
    const int m0 = (tile % mt) * kMmBM, n0 = (tile / mt) * kBN;
    __syncthreads();  // the previous tile's reads of xq_s are done
    stage_rows<kMmBM>(xq, a.D, 0, a.D, a.B, m0, xq_s);
    if (threadIdx.x < kMmBM)
      xs_s[threadIdx.x] = m0 + threadIdx.x < a.B ? xs[m0 + threadIdx.x] : 0.0f;
    __syncthreads();
    const bool row_ok = lane < kMmBM && m0 + lane < a.B;
    const float xsv = lane < kMmBM ? xs_s[lane] : 0.0f;
    for (int c = 0; c < kColsPerWarp; ++c) {
      const int n = n0 + warp * kColsPerWarp + c;
      if (n >= N) break;  // warp-uniform
      const int acc = packed_row_dot(w, n, a.D, xq_s, lane);
      float y = ((float)acc * xsv) * scale[n];
      if (kGateUp) {
        const int acc_up = packed_row_dot(w, a.F + n, a.D, xq_s, lane);
        const float up = ((float)acc_up * xsv) * scale[a.F + n];
        y = (a.act_silu ? aeqt::silu(y) : aeqt::gelu_tanh(y)) * up;
      }
      if (row_ok) out[(size_t)(m0 + lane) * N + n] = y;
    }
  }
}

// Stage 3: one warp per (row, F-tile) of h.
__device__ __forceinline__ void hidden_quant_stage(const Args& a) {
  const int lane = threadIdx.x & 31;
  const int nf = a.F / a.bf;
  for (int task = grid_warp(); task < a.B * nf; task += gridDim.x * kWarps) {
    const int m = task / nf, t = task % nf;
    const size_t off = (size_t)m * a.F + (size_t)t * a.bf;
    const float* h = a.hid + off;
    float amax = 0.0f;
    for (int j = lane; j < a.bf; j += 32) amax = fmaxf(amax, fabsf(h[j]));
    amax = aeqt::warp_max(amax);
    const float s = fmaxf(amax, 1e-9f) * aeqt::kInv127;
    const float inv = 1.0f / s;
    for (int j = lane; j < a.bf; j += 32)
      a.hq[off + j] = (int8_t)__float2int_rn(h[j] * inv);
    if (lane == 0) a.hs[(size_t)m * nf + t] = s;
  }
}

// Stage 4: x_ffn = x + (sum over F-tiles in order of float(part) * hs) * sd.
template <typename T>
__device__ __forceinline__ void down_stage(const Args& a,
                                           unsigned char* smem) {
  int8_t* hq_s = reinterpret_cast<int8_t*>(smem);  // [kDownBM][bf]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nf = a.F / a.bf, f2 = a.F / 2, b2 = a.bf / 2;
  const int mt = (a.B + kDownBM - 1) / kDownBM, dt = (a.D + kBN - 1) / kBN;
  const T* x = static_cast<const T*>(a.x);
  T* x_ffn = static_cast<T*>(a.x_ffn);
  for (int tile = blockIdx.x; tile < mt * dt; tile += gridDim.x) {
    const int m0 = (tile % mt) * kDownBM, d0 = (tile / mt) * kBN;
    const int m = m0 + lane;
    const bool row_ok = lane < kDownBM && m < a.B;
    float facc[kColsPerWarp];
#pragma unroll
    for (int c = 0; c < kColsPerWarp; ++c) facc[c] = 0.0f;
    for (int t = 0; t < nf; ++t) {
      __syncthreads();  // the previous F-tile's reads of hq_s are done
      stage_rows<kDownBM>(a.hq, a.F, t * a.bf, a.bf, a.B, m0, hq_s);
      __syncthreads();
      const float hs = row_ok ? a.hs[(size_t)m * nf + t] : 0.0f;
#pragma unroll
      for (int c = 0; c < kColsPerWarp; ++c) {
        const int d = d0 + warp * kColsPerWarp + c;
        if (d < a.D) {  // warp-uniform
          int acc[kDownBM] = {};
          aeqt::dot_packed<kDownBM>(a.wd + (size_t)d * f2 + (size_t)t * b2,
                                    b2, hq_s, hq_s + b2, a.bf, lane, acc);
          aeqt::warp_reduce_rows<kDownBM>(acc);
          const int mine = aeqt::pick_row<kDownBM>(acc, lane);
          if (row_ok) facc[c] = facc[c] + (float)mine * hs;
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kColsPerWarp; ++c) {
      const int d = d0 + warp * kColsPerWarp + c;
      if (row_ok && d < a.D) {
        const size_t i = (size_t)m * a.D + d;
        const float y = aeqt::load_f(x, i) + facc[c] * a.sd[d];
        a.xf[i] = y;
        aeqt::store_f(x_ffn, i, y);
      }
    }
  }
}

// Narrow-range symmetric int8 code of v (already multiplied by 1/scale).
__device__ __forceinline__ int8_t row_code(float v) {
  return (int8_t)(int)fminf(fmaxf(rintf(v), -127.0f), 127.0f);
}

// Stage 7: one block per batch row.
__device__ __forceinline__ void attention_stage(const Args& a, float* sm) {
  const int H = a.H, half = a.H / 2, NQ = a.NQ, N = (a.NQ + 2) * a.H;
  for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
    __syncthreads();  // the previous row's reads of sm are done
    const float* row = a.qkv + (size_t)b * N;
    const float* cs = a.cos + (size_t)b * half;
    const float* sn = a.sin + (size_t)b * half;
    int8_t* kn = a.k_new + (size_t)b * H;
    int8_t* vn = a.v_new + (size_t)b * H;
    // RoPE of the NQ query heads (into sm, the attention's qs) and of K.
    for (int i = threadIdx.x; i < (NQ + 1) * half; i += blockDim.x) {
      const int n = i / half, e = i % half;
      const float x1 = row[n * H + e], x2 = row[n * H + half + e];
      const float c = cs[e], s = sn[e];
      const float r1 = x1 * c - x2 * s;
      const float r2 = x2 * c + x1 * s;
      if (n < NQ) {
        sm[n * H + e] = r1;
        sm[n * H + half + e] = r2;
      } else {
        kn[e] = row_code(r1 * a.kq_inv);
        kn[half + e] = row_code(r2 * a.kq_inv);
      }
    }
    for (int e = threadIdx.x; e < H; e += blockDim.x)
      vn[e] = row_code(row[(NQ + 1) * H + e] * a.vq_inv);
    __syncthreads();
    const int L = min(max(a.lengths[b] - 1, 0), a.S);
    int8_t* kr = a.k_pool + (size_t)b * a.S * H;
    int8_t* vr = a.v_pool + (size_t)b * a.S * H;
    aeqt::stale_attention_row<float>(sm, NQ, a.S, H, L, kr, vr, kn, vn,
                                     a.ctx + (size_t)b * NQ * H,
                                     a.k_scale_eff, a.v_scale, a.zp_k,
                                     a.zp_v);
    __syncthreads();  // every read of this row's cache is done
    const int p = min(max(*a.pos, 0), a.S - 1);
    for (int e = threadIdx.x; e < H; e += blockDim.x) {
      kr[(size_t)p * H + e] = kn[e];
      vr[(size_t)p * H + e] = vn[e];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) fused_block_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  norm_stage(static_cast<const T*>(a.x), a.g1, a, a.xq1, a.xs1);
  grid.sync();
  matmul_stage<true>(a, smem);
  grid.sync();
  hidden_quant_stage(a);
  grid.sync();
  down_stage<T>(a, smem);
  grid.sync();
  norm_stage(static_cast<const float*>(a.xf), a.g2, a, a.xq2, a.xs2);
  grid.sync();
  matmul_stage<false>(a, smem);
  grid.sync();
  attention_stage(a, reinterpret_cast<float*>(smem));
}

size_t smem_bytes(const Args& a) {
  const size_t mm = (size_t)kMmBM * a.D + kMmBM * sizeof(float);
  const size_t down = (size_t)kDownBM * a.bf;
  const size_t attn = aeqt::stale_smem_floats(a.NQ, a.S, a.H) * sizeof(float);
  return mm > down ? (mm > attn ? mm : attn) : (down > attn ? down : attn);
}

template <typename T>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a);
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (!coop || !aeqt::smem_fits(smem)) return aeqt::kShapeRefused;
  auto* kernel = fused_block_kernel<T>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return aeqt::kShapeRefused;
  void* params[] = {const_cast<Args*>(&a)};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                    dim3(per_sm * sms), dim3(kThreads), params,
                                    smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Returns aeqt::kShapeRefused (nothing launched) unless D % 32 == 0,
// bf % 32 == 0, bf divides F, the head dim fits the attention body
// (H % 16 == 0, 1024 % H == 0), the NQ x S scores and the staged rows fit
// in shared memory, and the device takes cooperative launches.
extern "C" int aeqt_fused_block(const FusedBlockArgs* args, void* stream) {
  const Args& a = *args;
  if (a.B < 1 || a.NQ < 1 || a.S < 1 || a.D % 32 || a.bf < 32 || a.bf % 32 ||
      a.F % a.bf || !aeqt::head_dim_fits(a.H))
    return aeqt::kShapeRefused;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.x_bf16) return launch<__nv_bfloat16>(a, s);
  return launch<float>(a, s);
}
