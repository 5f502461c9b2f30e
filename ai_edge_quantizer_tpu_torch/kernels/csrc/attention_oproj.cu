// Decode attention over an int8 KV cache (one KV head), then the packed
// int4 out projection and the residual add: y = x_res + W_o . ctx.
//
// Replaces: ai_edge_quantizer_tpu/kernels/pallas_attention.py
//   decode_attention_oproj_pallas (_attn_oproj_kernel), the JAX executor's
//   AEQT_ATTN_BLOCK epilogue, in the f32, bf16 or int8 attention compute
//   mode. With T the activation dtype (bf16 for bf16 x_res, else f32), per
//   batch row b (q already rounded to T by the caller, as the TPU wrapper
//   casts it before the kernel takes q_ref[j].astype(f32)):
//     ctx = T(_ctx_prefix_len(compute, q[b], cache[b], lengths[b])) [G * H]
//     DRQ: xs = max(absmax(ctx), 1e-9) * (1/127) over the whole G*H row,
//          xq = rint(ctx * (1/xs)), o = T((acc * xs) * so), int32 sums;
//     weight-only: o = T(acc * so), f32 sums;
//     y   = T(x_res + o)
//   wo [D, G*H/2] is split-half packed: byte column j of pair p (j in
//   [p*H, (p+1)*H)) holds head p's column in its low nibble and head
//   p + G/2's in its high nibble, which is the split-half layout of a
//   [D, G*H] weight, so the projection is the port's packed FC over the
//   ctx rows.
//
// Bound on the H100 at bench.py's decode (Gemma-2B: B 256, S 1024, 897
//   live rows, G 8, H 256, D 2048): the K/V bytes of the live rows,
//   2 * 256 * 897 * 256 = 117.6 MB, 35 us at 3.35 TB/s, plus the 2 MiB of
//   packed W_o and the residual in and out: about 0.037 ms. The f32
//   attention (4 * G * L * H per row, 1.9 GFLOP) takes 28 us at the
//   67 TFLOP/s f32 peak (bf16 rounds the operands of the same f32 SIMT
//   work; int8 runs the score dot on __dp4a); the projection 2.1 GOP of
//   int8.
//
// Design (simple first): three launches on the caller's stream. (1) the
//   lengths attention (attention_lengths.cuh, the kernel of #7 in the
//   mode: one block of 256 threads a batch row) writes ctx in T to a
//   scratch [B, G*H]; (2) the packed projection of the ctx rows into an o
//   scratch in T, by the port's packed-FC tiles: DRQ (qmatmul_int4_drq.cuh, bit for bit the
//   plain version given ctx) or weight-only (qmatmul_int4_weight_only.cuh,
//   mma.sync bf16 with f32 sums; the low and the high halves are summed
//   apart and added, where the TPU kernel adds pair by pair: the f32 sums
//   differ in order only); (3) y = T(x_res + o), one thread an element. The
//   TPU kernel keeps ctx and o in VMEM; here they make a round trip through
//   L2 (1 MiB each at the bench shape). Keeping ctx on chip and adding the
//   residual in the projection's epilogue is later work.
#include "attention_lengths.cuh"
#include "qmatmul_int4_drq.cuh"
#include "qmatmul_int4_weight_only.cuh"

namespace {

constexpr int kAddThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kAddThreads)
residual_add_kernel(const T* __restrict__ x, const T* __restrict__ o,
                    T* __restrict__ y, size_t n) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    aeqt::store_f(y, i, aeqt::load_f(x, i) + aeqt::load_f(o, i));
}

template <typename T, int C>
int run(const void* q, const void* k, const void* v, const void* lengths,
        const void* x, const void* wo, const void* so, void* ctx, void* o,
        void* out, bool drq, int B, int G, int S, int H, int D,
        float k_scale_eff, float v_scale, float zp_k, float zp_v,
        cudaStream_t stream) {
  const int K = G * H;
  // The attention: H % 16, 1024 % H, the G x S scores in shared memory,
  // int8's q codes in the partials' space (checked again by its launcher).
  // The projection: DRQ K %
  // 32 and 16 rows of K int8 in shared memory; weight-only D % 64 and
  // K % 128. G even: the nibble pairing.
  const bool proj_ok = drq ? K % 32 == 0 &&
                                 aeqt::smem_fits(aeqt::qmatmul_smem_bytes(K))
                           : aeqt::wo_shape_ok(B, D, K, K);
  const size_t attn_smem = aeqt::scores_smem_floats(G, S, H) * sizeof(float);
  if (B <= 0 || G % 2 || !proj_ok || !aeqt::head_dim_fits(H) ||
      !aeqt::compute_fits(C, G, H) || !aeqt::smem_fits(attn_smem))
    return aeqt::kShapeRefused;
  int err = aeqt::launch_lengths_attention<T, C>(
      q, k, v, lengths, ctx, B, 1, G, S, H, k_scale_eff, v_scale, zp_k, zp_v,
      stream);
  if (err != 0) return err;
  err = drq ? aeqt::launch_qmatmul<T, T>(ctx, wo, so, nullptr, o, B, D, K,
                                         stream)
            : aeqt::launch_wo<T, T>(ctx, wo, so, nullptr, o, B, D, K, K,
                                    nullptr, stream);
  if (err != 0) return err;
  const size_t n = (size_t)B * D;
  const int blocks =
      (int)std::min<size_t>((n + kAddThreads - 1) / kAddThreads, 65536);
  residual_add_kernel<T><<<blocks, kAddThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(o), static_cast<T*>(out),
      n);
  return (int)cudaGetLastError();
}

template <typename T>
int run_mode(int compute, const void* q, const void* k, const void* v,
             const void* lengths, const void* x, const void* wo,
             const void* so, void* ctx, void* o, void* out, bool drq, int B,
             int G, int S, int H, int D, float k_scale_eff, float v_scale,
             float zp_k, float zp_v, cudaStream_t stream) {
  return aeqt::with_compute(compute, [&](auto mode) {
    return run<T, decltype(mode)::value>(q, k, v, lengths, x, wo, so, ctx, o,
                                         out, drq, B, G, S, H, D, k_scale_eff,
                                         v_scale, zp_k, zp_v, stream);
  });
}

}  // namespace

// q f32 [B, G, H] (already rounded to x's dtype); k, v int8 [B, S, H];
// lengths int32 [B]; x_res [B, D] bf16 (x_bf16) or f32; wo [D, G*H/2] uint8
// split-half packed, rows 16-byte aligned; so [D] f32; ctx [B, G*H] and o
// [B, D] scratch and out [B, D], all in x's dtype. drq: the int8 DRQ
// projection, else weight-only; compute: the attention's aeqt::kF32, kBF16
// or kInt8. Refuses with kShapeRefused, before launching anything, an odd
// G and the shapes the attention (H % 16, 1024 % H, G x S scores in shared
// memory, int8: G * H / 4 + G <= aeqt::kRedFloats) or the projection (DRQ:
// G*H % 32 and 16 rows of G*H int8 in shared memory; weight-only: D % 64,
// G*H % 128) does not take.
extern "C" int aeqt_attention_oproj(const void* q, const void* k,
                                    const void* v, const void* lengths,
                                    const void* x, const void* wo,
                                    const void* so, void* ctx, void* o,
                                    void* out, int x_bf16, int drq,
                                    int compute, int B, int G, int S, int H,
                                    int D, float k_scale_eff, float v_scale,
                                    float zp_k, float zp_v, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return run_mode<__nv_bfloat16>(compute, q, k, v, lengths, x, wo, so, ctx,
                                   o, out, drq != 0, B, G, S, H, D,
                                   k_scale_eff, v_scale, zp_k, zp_v, s);
  return run_mode<float>(compute, q, k, v, lengths, x, wo, so, ctx, o, out,
                         drq != 0, B, G, S, H, D, k_scale_eff, v_scale, zp_k,
                         zp_v, s);
}
