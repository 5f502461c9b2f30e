// GeGLU MLP with packed int4 weights, weight-only (no activation
// quantization):  y[M, D] = down(act(gate(x)) * up(x))
//
// Replaces: ai_edge_quantizer_tpu/kernels/pallas_mlp.py
//   mlp_pallas_int4_packed with drq=False (_mlp_bf16_kernel), which the JAX
//   executor's default (AEQT_INT4_DRQ=0) runs for every fused FFN.
//
// Arithmetic (the Pallas kernel's): x in its compute dtype (bf16 for bf16
//   x, f32 otherwise); gate and up each = (x_lo . w_lo + x_hi . w_hi) * s,
//   f32 sums; h = act(gate) * up in f32, rounded to the compute dtype; the
//   down partial of each bf-column group (its low and high halves, f32
//   sums) added into an f32 accumulator group by group in order; then
//   y = acc * s_d, stored in the compute dtype.
//
// Bound on the H100: at decode rows (M = 64, Gemma-2B: D 2048, F 16384) the
//   weight stream, 2F x D/2 + D x F/2 = 50 MB, about 15 us at 3.35 TB/s; at
//   a prefill pass (M = 1024) the operations, 3 * 2*M*F*D = 206 GFLOP, about
//   0.21 ms at the bf16 tensor-core peak.
//
// Design (deterministic). The TPU kernel carries its f32 accumulator
//   across its F-groups in grid order; CUDA blocks run in no order, so the
//   work is three launches and the sum over F-groups runs in order inside
//   one thread, without float atomics:
//   1. gate/up: the weight-only kernel (qmatmul_int4_weight_only.cuh, one
//      group of D columns) with an f32 output gu [M, 2F] = acc * s.
//   2. act: h[m, f] = act(gu[m, f]) * gu[m, F + f], rounded to the compute
//      dtype: h [M, F].
//   3. down: the weight-only kernel over h with groups of bf columns, the
//      group-split layout of the down weight, and scale s_d. At decode rows
//      (bf16) its groups are split over the grid, and their partials,
//      written over gu (read by then), are added in group order by a
//      fourth launch.
//   gu and h round-trip device memory (8 MiB and 2 MiB at M = 64; both fit
//   in L2). bf16 x runs the tensor-core kernels, f32 x the SIMT ones.
#include "qmatmul_int4_weight_only.cuh"

namespace {

constexpr int kActThreads = 256;

template <typename TH>
__global__ void __launch_bounds__(kActThreads)
act_mul_kernel(const float* __restrict__ gu, TH* __restrict__ h, int M,
               int F, int act_silu) {
  const size_t n = (size_t)M * F;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t m = i / F, f = i % F;
    const float g = gu[m * 2 * F + f];
    const float a = act_silu ? aeqt::silu(g) : aeqt::gelu_tanh(g);
    aeqt::store_f(h, i, a * gu[m * 2 * F + F + f]);
  }
}

template <typename T>
int launch_all(const void* x, const void* wgu, const void* sgu,
               const void* wd, const void* sd, void* gu, void* h, void* out,
               int M, int D, int F, int bf, int act_silu,
               cudaStream_t stream) {
  if (!aeqt::wo_shape_ok(M, 2 * F, D, D) || !aeqt::wo_shape_ok(M, D, F, bf))
    return aeqt::kShapeRefused;
  int err = aeqt::launch_wo<T, float>(x, wgu, sgu, nullptr, gu, M, 2 * F, D,
                                      D, nullptr, stream);
  if (err != 0) return err;
  const size_t n = (size_t)M * F;
  const int blocks = (int)((n + kActThreads - 1) / kActThreads < 65536
                               ? (n + kActThreads - 1) / kActThreads
                               : 65536);
  act_mul_kernel<T><<<blocks, kActThreads, 0, stream>>>(
      static_cast<const float*>(gu), static_cast<T*>(h), M, F, act_silu);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  return aeqt::launch_wo<T, T>(h, wd, sd, nullptr, out, M, D, F, bf,
                               static_cast<float*>(gu), stream);
}

}  // namespace

// The f32 scratch `gu` of aeqt_mlp_int4_bf16 must hold, in floats: gu
// [M, 2F], and the down projection's group partials where it splits them.
extern "C" long long aeqt_mlp_int4_bf16_scratch(int M, int D, int F, int bf,
                                                int x_bf16) {
  const size_t gu = (size_t)M * 2 * F;
  const size_t part = x_bf16 ? aeqt::wo_scratch_floats(M, D, F, bf) : 0;
  return (long long)std::max(gu, part);
}

// x [M, D] bf16 (x_bf16) or f32; wgu [2F, D/2] uint8 split-half packed
// (gate rows, then up rows); sgu [2F] f32; wd [D, F/2] uint8 group-split
// packed (group bf); sd [D] f32; scratch gu f32
// (aeqt_mlp_int4_bf16_scratch floats) and h [M, F] in x's dtype; out
// [M, D] in x's dtype. Takes D % 128 == 0, bf % 128 == 0 and F % bf == 0;
// refuses any other shape with kShapeRefused (nothing launched).
extern "C" int aeqt_mlp_int4_bf16(const void* x, int x_bf16, const void* wgu,
                                  const void* sgu, const void* wd,
                                  const void* sd, void* gu, void* h,
                                  void* out, int M, int D, int F, int bf,
                                  int act_silu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return launch_all<__nv_bfloat16>(x, wgu, sgu, wd, sd, gu, h, out, M, D, F,
                                     bf, act_silu, s);
  return launch_all<float>(x, wgu, sgu, wd, sd, gu, h, out, M, D, F, bf,
                           act_silu, s);
}
