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
//   67 TFLOP/s f32 peak (its scores are f32 FMA chains; the bf16 and int8
//   modes run on the tensor cores); the projection 2.1 GOP of int8.
//
// Design: two launches on the caller's stream (three for DRQ), each the
//   one its unfused part runs. (1) The lengths attention of #7 in the mode
//   (attention_lengths.cuh aeqt::lengths::launch: the split core's lengths
//   form, one CTA a row at B 256 and clusters at B 64, or the one-block
//   body for the shapes the core refuses) writes ctx in T to a scratch
//   [B, G*H] (1 MiB at the bench shape at bf16, read back from L2). (2)
//   The packed projection of the ctx rows with the residual in its
//   epilogue, y = T(T(o) + x_res):
//   * DRQ: #1's launches (int8_tc_gemm.cuh, SplitNibblesRecipB): the row
//     quantize of ctx into int8 codes and scales (scratch), a programmatic
//     dependent launch on the attention, then the int8 wgmma contraction
//     as its programmatic dependent launch, the residual added by its
//     epilogue (kRes). Bit for bit the plain version given ctx: the int32
//     sums are exact in any order.
//   * weight-only, bf16: #12's core (int4_bf16_tc_gemm.cuh,
//     ChannelScaleResidual: ChannelScale as a programmatic dependent launch
//     on the attention, the residual in its epilogue). The low and the high
//     halves sum apart and are added, where the TPU kernel adds head by
//     head, pair by pair: the f32 sums differ in order only.
//   * weight-only, f32: #12's SIMT f32 kernel (qmatmul_int4_simt.cuh) with
//     its residual argument; the same order note.
//   The TPU kernel keeps ctx and o in VMEM; here ctx makes a round trip
//   through L2 and o none.
#include <type_traits>

#include "attention_lengths.cuh"
#include "attention_split_tc.cuh"
#include "int4_bf16_tc_gemm.cuh"
#include "int8_tc_gemm.cuh"
#include "qmatmul_int4_simt.cuh"

namespace {

using aeqt::tc::SplitNibblesRecipB;
using aeqt::w4::ChannelScaleResidual;

// The projection's shapes: DRQ (#1) K % 32 and N up to 65535 tiles of 128;
// weight-only D % 64 and K % 128 (the bf16 core's and the SIMT kernel's).
bool proj_takes(bool drq, int B, int D, int K) {
  if (drq)
    return K % 32 == 0 && (D + aeqt::tc::kBN - 1) / aeqt::tc::kBN <= 65535;
  return aeqt::w4::takes(B, D, K, 0) && D % aeqt::kWpBN == 0;
}

template <typename T, int C>
int run(const void* q, const void* k, const void* v, const void* lengths,
        const void* x, const void* wo, const void* so, void* ctx, void* xq,
        void* xs, void* out, bool drq, int B, int G, int S, int H, int D,
        float k_scale_eff, float v_scale, float zp_k, float zp_v,
        cudaStream_t stream) {
  const int K = G * H;
  if (B <= 0 || G % 2 || !aeqt::lengths::takes<C>(B, G, S, H) ||
      !proj_takes(drq, B, D, K))
    return aeqt::kShapeRefused;
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  int err = aeqt::lengths::launch<C>(q, k, v, lengths, ctx, kBf16, B, 1, G, S,
                                     H, k_scale_eff, v_scale, zp_k, zp_v,
                                     stream);
  if (err != 0) return err;
  if (drq) {
    err = aeqt::tc::launch_quantize<SplitNibblesRecipB, T, true>(
        ctx, xq, xs, B, K, stream);
    if (err != 0) return err;
    return aeqt::tc::launch_gemm<SplitNibblesRecipB, T, true>(
        wo, so, nullptr, out, xq, xs, B, D, K,
        aeqt::tc::make_plan<SplitNibblesRecipB>(B, D, K), stream, x);
  }
  if constexpr (kBf16) {
    return aeqt::w4::run<ChannelScaleResidual>(ctx, wo, so, nullptr, out, B,
                                               D, K, 0, stream, x);
  } else {
    const dim3 grid(D / aeqt::kWpBN, (B + aeqt::kWpBM - 1) / aeqt::kWpBM);
    aeqt::qmatmul_int4_wo_kernel<float, float>
        <<<grid, aeqt::kWpThreads, 0, stream>>>(
            static_cast<const float*>(ctx), static_cast<const uint8_t*>(wo),
            static_cast<const float*>(so), nullptr, static_cast<float*>(out),
            B, D, K, K, static_cast<const float*>(x));
    return (int)cudaGetLastError();
  }
}

}  // namespace

// q f32 [B, G, H] (already rounded to x's dtype); k, v int8 [B, S, H];
// lengths int32 [B]; x_res [B, D] bf16 (x_bf16) or f32, 16-byte aligned;
// wo [D, G*H/2] uint8 split-half packed, rows 16-byte aligned; so [D] f32;
// ctx [B, G*H] scratch in x's dtype (16-byte aligned); xq [B, G*H] int8 and
// xs [B] f32 scratch (DRQ only; else unused); out [B, D] in x's dtype. drq:
// the int8 DRQ projection, else weight-only; compute: the attention's
// aeqt::kF32, kBF16 or kInt8. Refuses with kShapeRefused, before launching
// anything, an odd G and the shapes the attention (#7's: the split core's,
// else the one-block kernel's H % 16, 1024 % H, G x S scores in shared
// memory, int8: G * H / 4 + G <= aeqt::kRedFloats) or the projection (DRQ:
// G*H % 32; weight-only: D % 64, G*H % 128) does not take.
extern "C" int aeqt_attention_oproj(const void* q, const void* k,
                                    const void* v, const void* lengths,
                                    const void* x, const void* wo,
                                    const void* so, void* ctx, void* xq,
                                    void* xs, void* out, int x_bf16, int drq,
                                    int compute, int B, int G, int S, int H,
                                    int D, float k_scale_eff, float v_scale,
                                    float zp_k, float zp_v, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return aeqt::with_compute(compute, [&](auto mode) {
    constexpr int C = decltype(mode)::value;
    if (x_bf16)
      return run<__nv_bfloat16, C>(q, k, v, lengths, x, wo, so, ctx, xq, xs,
                                   out, drq != 0, B, G, S, H, D, k_scale_eff,
                                   v_scale, zp_k, zp_v, s);
    return run<float, C>(q, k, v, lengths, x, wo, so, ctx, xq, xs, out,
                         drq != 0, B, G, S, H, D, k_scale_eff, v_scale, zp_k,
                         zp_v, s);
  });
}

// The launches of a shape (attention.OPROJ_PLAN_FIELDS): the attention's
// (SPLIT_PLAN_FIELDS: cluster size, rows, cache rows a CTA, threads,
// shared memory; cluster 0 the one-block body), then the projection's
// grid x, y, z (split), threads, dynamic shared memory, ring stages and
// tokens a tile: #1's plan_fields and 0 (DRQ), the bf16 core's (bf16
// weight-only), the SIMT kernel's grid, 1, its threads, 0, 0 and its 32
// rows (f32 weight-only); or kShapeRefused.
extern "C" int aeqt_attention_oproj_plan(int B, int G, int S, int H, int D,
                                         int compute, int drq, int x_bf16,
                                         long long* fields) {
  const int K = G * H;
  if (B <= 0 || G % 2 || !proj_takes(drq != 0, B, D, K))
    return aeqt::kShapeRefused;
  const int err = aeqt::with_compute(compute, [&](auto mode) {
    return aeqt::lengths::plan_fields<decltype(mode)::value>(B, G, S, H,
                                                             fields);
  });
  if (err != 0) return err;
  long long* f = fields + 5;
  if (drq) {
    aeqt::tc::plan_fields<SplitNibblesRecipB>(B, D, K, f);
    f[6] = 0;
  } else if (x_bf16) {
    aeqt::w4::plan_fields<ChannelScaleResidual>(B, D, K, 0, f);
  } else {
    f[0] = D / aeqt::kWpBN;
    f[1] = (B + aeqt::kWpBM - 1) / aeqt::kWpBM;
    f[2] = 1;
    f[3] = aeqt::kWpThreads;
    f[4] = 0;
    f[5] = 0;
    f[6] = aeqt::kWpBM;
  }
  return 0;
}
