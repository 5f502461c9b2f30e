// Fused decode block: MLP(l-1) + both RMS norms + QKV(l) + RoPE + the new
// K/V row's int8 quantization + stale-cache attention(l), and the write of
// the new row into the cache pools, as one chain of launches.
//
// Replaces: ai_edge_quantizer_tpu/kernels/pallas_block.py
//   fused_mlp_qkv_attention (_kernel_impl), its attention in the f32, bf16
//   or int8 compute mode (`compute`). Per batch row b (x_res [B, D] f32 or
//   bf16):
//     xq1, xs1 = rmsnorm_quant(x_res, g1)
//     per F-tile t of bf columns: gate, up = (acc * xs1) * s (packed int4),
//       h = act(gate) * up, hq, hs = DRQ of h's tile, acc += part * hs
//     x_ffn = x_res + acc * s_d                          (kept in f32)
//     xq2, xs2 = rmsnorm_quant(x_ffn, g2); qkv = (acc * xs2) * s_qkv
//     q, k = half-split RoPE of the NQ query heads and of K; v = V
//     k_new = clip(rint(k * (1/kq)), -127, 127); v_new likewise
//     ctx = stale attention over the cache rows < lengths[b] - 1 plus the
//           inline new column (#2's function in the mode)
//   and row clamp(pos, 0, S - 1) of k_pool[b] and v_pool[b] becomes
//   k_new[b] and v_new[b] (the TPU kernel's aliased outputs). The TPU
//   kernel's ring prefetch (`bb`, `ring`) and dirty-tile writeback are
//   VMEM and DMA choices with no counterpart here, and so is its writeback
//   race (a ring slot refilled, pallas_block.py:367, before the slot's
//   tile is read, :385-388): the rows are written after every read of them.
//
// Bound on the H100: at the bench shape (Gemma-2B: D 2048, F 16384, NQ 8,
//   H 256; B 256, S 1024, 897 live rows) one unit reads 32 MiB of gate/up,
//   16 MiB of down and 2.5 MiB of QKV weights and about 117 MB of live
//   K/V rows: about 0.051 ms at 3.35 TB/s. Its int8 work (54 GOP) takes
//   0.027 ms at the 1,979 TOP/s tensor-core peak and its f32 attention
//   (1.9 GFLOP) 0.028 ms at 67 TFLOP/s: bytes and operations about even.
//
// Design: eight launches on the caller's stream, built from the cores the
//   unfused kernels run on; each a programmatic dependent launch where it
//   can start before its predecessor ends (its first weight tiles load
//   meanwhile), every step of the arithmetic the plain version's
//   (kernels/block.py), each product and sum rounded on its own
//   (--fmad=false):
//   1. norm 1 + DRQ of x: one block a row (the block's own formula,
//      pallas_block._rmsnorm_quant, the sum of squares in f64) -> xq1,
//      xs1;
//   2. gate/up + act on the int8 core (mlp_int4_drq.cuh, #3's pair tile of
//      64 gate and 64 up rows) -> h f32 [B, F];
//   3. hidden DRQ (#3's hquant_kernel) -> hq, hs;
//   4. down (#3's group-split chain: a tile's running f32 sum passes block
//      to block of its cluster in group order, so x_ffn is the unfused
//      MLP's bit for bit), with the residual in its epilogue: x_ffn = x +
//      R * s_d into f32 scratch xf (for norm 2) and into x's dtype;
//   5. norm 2 + DRQ of the f32 xf -> xq2, xs2;
//   6. QKV on the int8 core in pair tiles (rows e and e + H/2 of a head in
//      one B tile), its epilogue the half-split RoPE and the new row's codes
//      (k * kq_inv with the host's f32 inverse) -> q f32 [B, NQ, H], k_new,
//      v_new;
//   7. the stale attention of #2 (attention_stale.cuh: the split core's
//      stale form, attend<kStale, C>, clusters by the occupancy query; the
//      one-block body aeqt::stale_attention_row for the shapes the core
//      does not take, the same fixed rule as #2's) -> ctx;
//   8. row clamp(pos, 0, S - 1) of both pools <- k_new, v_new: stream order
//      puts it after every CTA of launch 7 has read its slice (the row can
//      lie below lengths - 1, where launch 7 reads it).
//   The hidden activations still go through L2 (h 16 MiB and hq 4 MiB at
//   the bench shape): a group's absmax spans bf columns, 32 gate/up tiles.
#include "attention_stale.cuh"
#include "mlp_int4_drq.cuh"

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
  float* q;             // [B, NQ, H]
  int x_bf16, B, D, F, bf, NQ, H, S, act_silu;
  int compute;          // aeqt::kF32, kBF16 or kInt8
  float eps, k_scale_eff, v_scale, zp_k, zp_v, kq_inv, vq_inv;
};

namespace {

namespace tc = aeqt::tc;
namespace mlp = aeqt::mlp;
using Args = FusedBlockArgs;

constexpr int kNormThreads = 256;  // a norm block: one row
constexpr int kWriteThreads = 64;

// Launches 1 and 5: RMS norm + DRQ of row blockIdx.x, the block's own
// formula (pallas_block._rmsnorm_quant): the sum of squares in f64 (each
// square exact; rounded to f32 once, which makes a difference between
// orders of the sum very unlikely, though not impossible: the plain
// versions sum in f64 in another order and, in every check so far, get the
// same f32), var = f32(ss / K), r = 1 / sqrt(var + eps), xn = (x * r) *
// gamma, xs = max(absmax(xn), 1e-9) * (1/127), xq = rint(xn * (1 / xs)). A
// block a row, its threads on adjacent elements: three passes over the
// row, the last two from L1.
template <typename T>
__global__ void __launch_bounds__(kNormThreads)
norm_quant_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                  int K, float eps, int8_t* __restrict__ xq,
                  float* __restrict__ xs) {
  __shared__ double part_ss[kNormThreads / 32];
  __shared__ float part_max[kNormThreads / 32];
  // The next launch may start now: it waits for this grid before its codes.
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  tc::griddep_wait();  // launch 5 reads the down's xf
  const size_t m = blockIdx.x;
  const T* row = x + m * K;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  double ss = 0.0;
  for (int k = threadIdx.x; k < K; k += kNormThreads) {
    const double v = (double)aeqt::load_f(row, k);
    ss += v * v;
  }
  ss = aeqt::warp_sum_double(ss);
  if (lane == 0) part_ss[warp] = ss;
  __syncthreads();
  ss = part_ss[0];
#pragma unroll
  for (int w = 1; w < kNormThreads / 32; ++w) ss += part_ss[w];
  const float var = (float)(ss / (double)K);
  const float r = 1.0f / sqrtf(var + eps);
  float amax = 0.0f;
  for (int k = threadIdx.x; k < K; k += kNormThreads)
    amax = fmaxf(amax, fabsf((aeqt::load_f(row, k) * r) * gamma[k]));
  amax = aeqt::warp_max(amax);
  if (lane == 0) part_max[warp] = amax;
  __syncthreads();
  amax = part_max[0];
#pragma unroll
  for (int w = 1; w < kNormThreads / 32; ++w) amax = fmaxf(amax, part_max[w]);
  const float s = fmaxf(amax, 1e-9f) * aeqt::kInv127;
  const float inv = 1.0f / s;
  int8_t* dst = xq + m * K;
  for (int k = threadIdx.x; k < K; k += kNormThreads)
    dst[k] = (int8_t)__float2int_rn(((aeqt::load_f(row, k) * r) * gamma[k]) *
                                    inv);
  if (threadIdx.x == 0) xs[m] = s;
}

// Launch 8: row clamp(pos, 0, S - 1) of batch row blockIdx.x of both pools
// <- the new rows, 16 bytes a thread (H % 16 == 0).
__global__ void __launch_bounds__(kWriteThreads)
write_rows_kernel(const int8_t* __restrict__ k_new,
                  const int8_t* __restrict__ v_new, const int* __restrict__ pos,
                  int8_t* __restrict__ k_pool, int8_t* __restrict__ v_pool,
                  int S, int H) {
  const size_t b = blockIdx.x;
  const int p = min(max(*pos, 0), S - 1);
  const size_t at = (b * S + p) * H;
  for (int v = threadIdx.x; v < H / 16; v += kWriteThreads) {
    reinterpret_cast<uint4*>(k_pool + at)[v] =
        reinterpret_cast<const uint4*>(k_new + b * H)[v];
    reinterpret_cast<uint4*>(v_pool + at)[v] =
        reinterpret_cast<const uint4*>(v_new + b * H)[v];
  }
}

// Launch 5 as a programmatic dependent launch of the down.
template <typename... Params, typename... Actual>
int launch_dependent(void (*kernel)(Params...), int blocks, int threads,
                     cudaStream_t stream, Actual... args) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(blocks);
  config.blockDim = dim3(threads);
  config.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  config.attrs = &attr;
  config.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&config, kernel, args...);
}

// The shapes of the chain: #3's contractions (D % 32 == 0, bf % 256 == 0
// and at most 8192, F % bf == 0), the QKV's pair tiles (H % 128 == 0), and
// the attention of #2 (the split core, or the one-block body where that
// fits).
bool takes(const Args& a) {
  long long fields[5];
  return a.B >= 1 && a.NQ >= 1 && a.S >= 1 &&
         mlp::shape_ok(a.B, a.D, a.F, a.bf) && a.H >= 128 && a.H % 128 == 0 &&
         (long long)(a.NQ + 2) * a.H / 128 <= 65535 &&
         aeqt::stale::plan(a.B, a.NQ, a.S, a.H, a.compute, fields) == 0;
}

template <typename T>
int launch_all(const Args& a, cudaStream_t s) {
  const int B = a.B, D = a.D, F = a.F, bf = a.bf, N = (a.NQ + 2) * a.H;
  // 1. norm 1 + DRQ of x.
  norm_quant_kernel<T><<<B, kNormThreads, 0, s>>>(
      static_cast<const T*>(a.x), a.g1, D, a.eps, a.xq1, a.xs1);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  // 2. gate/up + act -> h.
  err = mlp::launch_gemm<mlp::kGateUp, float>(
      mlp::gate_up_plan(B, D, F), a.xq1, D, a.wgu, D / 2, 2 * F, a.xs1,
      a.sgu, a.hid, B, F, D, F, bf, a.act_silu, s);
  if (err != 0) return err;
  // 3. hidden DRQ.
  err = mlp::launch_hquant(a.hid, a.hq, a.hs, B, F, bf, s);
  if (err != 0) return err;
  // 4. down, x_ffn = x + R * s_d (f32 scratch and x's dtype).
  mlp::BlockEpilogue down = {};
  down.x = a.x;
  down.xf = a.xf;
  err = mlp::launch_gemm<mlp::kDown, T>(
      mlp::down_plan<T>(B, D, F, bf), a.hq, F, a.wd, F / 2, D, a.hs, a.sd,
      static_cast<T*>(a.x_ffn), B, D, D, F, bf, a.act_silu, s, down);
  if (err != 0) return err;
  // 5. norm 2 + DRQ of the f32 x_ffn.
  err = launch_dependent(norm_quant_kernel<float>, B, kNormThreads, s,
                         (const float*)a.xf, a.g2, D, a.eps, a.xq2, a.xs2);
  if (err != 0) return err;
  // 6. QKV + RoPE + the new row's codes.
  mlp::BlockEpilogue qkv = {};
  qkv.cos = a.cos;
  qkv.sin = a.sin;
  qkv.q = a.q;
  qkv.k_new = a.k_new;
  qkv.v_new = a.v_new;
  qkv.H = a.H;
  qkv.NQ = a.NQ;
  qkv.kq_inv = a.kq_inv;
  qkv.vq_inv = a.vq_inv;
  err = mlp::launch_gemm<mlp::kQkv, float>(
      mlp::qkv_plan(B, D, N), a.xq2, D, a.wqkv, D / 2, N, a.xs2, a.sqkv,
      nullptr, B, N, D, 0, bf, 0, s, qkv);
  if (err != 0) return err;
  // 7. the stale attention.
  err = aeqt::stale::run(a.q, a.k_pool, a.v_pool, a.k_new, a.v_new,
                         a.lengths, a.ctx, 0, a.compute, B, 1, a.NQ, a.S,
                         a.H, a.k_scale_eff, a.v_scale, a.zp_k, a.zp_v, s);
  if (err != 0) return err;
  // 8. the pools' row pos, after launch 7's reads.
  write_rows_kernel<<<B, kWriteThreads, 0, s>>>(a.k_new, a.v_new, a.pos,
                                               a.k_pool, a.v_pool, a.S, a.H);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns aeqt::kShapeRefused (nothing launched) unless D % 32 == 0,
// bf % 256 == 0 (at most 8192), bf divides F, H % 128 == 0, and #2's
// attention takes (R = B, G = NQ, S, H) in the mode: the split core (H 128
// or 256, NQ <= 16), else the one-block body (1024 % H == 0, the NQ x S
// scores in shared memory, and in int8 NQ * H / 4 + NQ <= aeqt::kRedFloats).
extern "C" int aeqt_fused_block(const FusedBlockArgs* args, void* stream) {
  const Args& a = *args;
  if (!takes(a)) return aeqt::kShapeRefused;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.x_bf16) return launch_all<__nv_bfloat16>(a, s);
  return launch_all<float>(a, s);
}

// The chain's launches (kernels/block.py PLAN_FIELDS): the gate/up, the
// down and the QKV as mlp::gemm_fields gives them (grid x, y, z, threads,
// ring stages, shared memory), then the attention's plan (cluster size, 0
// for the one-block body; rows; cache rows a CTA; threads; shared
// memory); or kShapeRefused.
extern "C" int aeqt_fused_block_plan(int B, int D, int F, int bf, int NQ,
                                     int H, int S, int compute, int x_bf16,
                                     long long* fields) {
  Args a = {};
  a.B = B, a.D = D, a.F = F, a.bf = bf, a.NQ = NQ, a.H = H, a.S = S;
  a.compute = compute;
  if (!takes(a)) return aeqt::kShapeRefused;
  mlp::gemm_fields(mlp::gate_up_plan(B, D, F), fields);
  mlp::gemm_fields(x_bf16 ? mlp::down_plan<__nv_bfloat16>(B, D, F, bf)
                          : mlp::down_plan<float>(B, D, F, bf),
                   fields + 6);
  mlp::gemm_fields(mlp::qkv_plan(B, D, (NQ + 2) * H), fields + 12);
  return aeqt::stale::plan(B, NQ, S, H, compute, fields + 18);
}
