// GeGLU MLP with packed int4 weights, weight-only (no activation
// quantization):  y[M, D] = down(act(gate(x)) * up(x))
//
// Replaces: ai_edge_quantizer_tpu/kernels/pallas_mlp.py
//   mlp_pallas_int4_packed with drq=False (_mlp_bf16_kernel), which the JAX
//   executor's default (AEQT_INT4_DRQ=0) runs for every fused FFN.
//
// Arithmetic (the Pallas kernel's, pallas_mlp.py:149-193; plain
//   kernels/mlp.py mlp_int4_packed_plain): x in its compute dtype (bf16
//   for bf16 x, f32 otherwise); gate and up each = (x_lo . w_lo + x_hi .
//   w_hi) * s, f32 sums; h = act(gate) * up in f32, rounded to the compute
//   dtype; the down partial of each bf-column group (its low and high
//   halves, f32 sums) added into an f32 accumulator group by group in
//   order; then y = acc * s_d, stored in the compute dtype.
//
// Bound on the H100: at decode rows (M = 64, Gemma-2B: D 2048, F 16384) the
//   weight stream, 2F x D/2 + D x F/2 = 50 MB, about 15 us at 3.35 TB/s; at
//   a prefill pass (M = 1024) the operations, 3 * 2*M*F*D = 206 GFLOP, about
//   0.21 ms at the bf16 tensor-core peak.
//
// Design, bf16 x: two launches on the bf16 tensor-core core
//   (int4_bf16_tc_gemm.cuh: weight rows on wgmma's M side, widened from
//   the packed bytes in registers; x tiles by TMA; lo and hi f32
//   accumulators):
//   1. gate/up, policy GateUpScale: a block's weight tile is gate rows
//      f0 .. f0 + 31 (63 at two warpgroups) and the up rows F + f0 .. of
//      the same columns (two TMA boxes), so the epilogue forms
//      h = bf16(act((lo + hi) * s_g) * ((lo + hi) * s_u)) from the staged
//      tiles and stores h [M, F]; gu never goes to memory. 512 tiles at
//      decode: no split.
//   2. down, policy GroupSum: x = h [M, F]; the group-split weight (byte j
//      of group g holds column g*bf + j low and g*bf + bf/2 + j high), read
//      by the core's split-half step with the x tiles taken at columns
//      j0 + g*bf/2 and that + bf/2 (only the TMA coordinates change); at
//      each group's end y += lo + hi, in group order; y * s_d at the end.
//      Where the tiles leave SMs idle (decode and M 256), K splits over a
//      cluster in whole groups (at one warpgroup counting two blocks an
//      SM: 8 at decode) and the splits' f32 partials are added in split
//      order in distributed shared memory, which changes the association
//      of the group sum (not of any group's own sum): the weight-only
//      branch's checks bound the result, none holds it bit for bit. No
//      global scratch and no float atomics.
//   On the H100 (PERF.md §6, `kernel_study.py launches`) each launch takes
//   about 32 us at decode, the gate/up for 32 MiB of weights.
// f32 x keeps the SIMT tiles of qmatmul_int4_simt.cuh (as #12 and #13 do
//   for f32, PERF.md §6): gate/up with an f32 output gu [M, 2F] = acc * s,
//   act_mul_kernel rounding h to f32, then the down over groups of bf
//   columns, each thread's groups in order.
#include "int4_bf16_tc_gemm.cuh"
#include "qmatmul_int4_simt.cuh"

namespace {

constexpr int kActThreads = 256;

// The shapes both routes take: D % 128 == 0 (whole stages of x in each
// half of the gate/up rows), bf % 128 == 0 (whole stages in each half of a
// group), F % bf == 0.
bool takes(int M, int D, int F, int bf) {
  return M > 0 && D > 0 && D % 128 == 0 && bf > 0 && bf % 128 == 0 &&
         F > 0 && F % bf == 0 && aeqt::w4::takes(M, 2 * F, D, 0) &&
         aeqt::w4::takes(M, D, F, 0);
}

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

// f32 x: the SIMT tiles, group = D for gate/up and bf for down.
int launch_f32(const void* x, const void* wgu, const void* sgu,
               const void* wd, const void* sd, void* gu, void* h, void* out,
               int M, int D, int F, int bf, int act_silu,
               cudaStream_t stream) {
  auto simt = [&](const void* xin, const void* w, const void* s, void* y,
                  int N, int K, int group) {
    const dim3 grid(N / aeqt::kWpBN, (M + aeqt::kWpBM - 1) / aeqt::kWpBM);
    aeqt::qmatmul_int4_wo_kernel<float, float>
        <<<grid, aeqt::kWpThreads, 0, stream>>>(
            static_cast<const float*>(xin), static_cast<const uint8_t*>(w),
            static_cast<const float*>(s), nullptr, static_cast<float*>(y), M,
            N, K, group, nullptr);
    return (int)cudaGetLastError();
  };
  int err = simt(x, wgu, sgu, gu, 2 * F, D, D);
  if (err != 0) return err;
  const size_t n = (size_t)M * F;
  const int blocks = (int)std::min<size_t>((n + kActThreads - 1) / kActThreads,
                                           65536);
  act_mul_kernel<float><<<blocks, kActThreads, 0, stream>>>(
      static_cast<const float*>(gu), static_cast<float*>(h), M, F, act_silu);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  return simt(h, wd, sd, out, D, F, bf);
}

}  // namespace

// The f32 scratch `gu` of aeqt_mlp_int4_bf16 must hold, in floats: gu
// [M, 2F] for f32 x; bf16 x needs none.
extern "C" long long aeqt_mlp_int4_bf16_scratch(int M, int D, int F, int bf,
                                                int x_bf16) {
  return x_bf16 ? 0 : (long long)M * 2 * F;
}

// x [M, D] bf16 (x_bf16) or f32; wgu [2F, D/2] uint8 split-half packed
// (gate rows, then up rows); sgu [2F] f32; wd [D, F/2] uint8 group-split
// packed (group bf); sd [D] f32; scratch gu f32
// (aeqt_mlp_int4_bf16_scratch floats) and h [M, F] in x's dtype; out
// [M, D] in x's dtype; all 16-byte aligned. Takes D % 128 == 0,
// bf % 128 == 0 and F % bf == 0; refuses any other shape with
// kShapeRefused (nothing launched).
extern "C" int aeqt_mlp_int4_bf16(const void* x, int x_bf16, const void* wgu,
                                  const void* sgu, const void* wd,
                                  const void* sd, void* gu, void* h,
                                  void* out, int M, int D, int F, int bf,
                                  int act_silu, void* stream) {
  if (!takes(M, D, F, bf)) return aeqt::kShapeRefused;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!x_bf16)
    return launch_f32(x, wgu, sgu, wd, sd, gu, h, out, M, D, F, bf, act_silu,
                      s);
  const int err = aeqt::w4::run_nb<aeqt::w4::GateUpScale>(
      x, wgu, sgu, nullptr, h, M, 2 * F, D, 0, act_silu, s);
  if (err != 0) return err;
  return aeqt::w4::run<aeqt::w4::GroupSum>(h, wd, sd, nullptr, out, M, D, F,
                                           bf / 2, s);
}

// The bf16 route's launches (kernels/mlp.py BF16_PLAN_FIELDS): gate/up,
// then down, each as int4_bf16_tc_gemm.cuh plan_fields gives it (grid x,
// y, split, threads, shared memory, stages, tokens a tile); or
// kShapeRefused.
extern "C" int aeqt_mlp_int4_bf16_plan(int M, int D, int F, int bf,
                                       long long* fields) {
  if (!takes(M, D, F, bf)) return aeqt::kShapeRefused;
  aeqt::w4::plan_fields<aeqt::w4::GateUpScale>(M, 2 * F, D, 0, fields);
  aeqt::w4::plan_fields<aeqt::w4::GroupSum>(M, D, F, bf / 2, fields + 7);
  return 0;
}
