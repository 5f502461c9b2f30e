// GeGLU MLP with packed int4 weights and DRQ activations:
//   y[M, D] = down(act(gate(x)) * up(x))
//
// Replaces: ai_edge_quantizer_tpu/kernels/pallas_mlp.py
//   mlp_pallas_int4_packed, DRQ branch (_mlp_drq_kernel).
//
// Arithmetic (the Pallas kernel's, pallas_mlp.py:93-146; the plain
//   version kernels/mlp.py mlp_int4_packed_plain), every product and sum
//   rounded on its own (--fmad=false):
//   1. x quantized per row: xs = max(absmax, 1e-9) * (1/127),
//      xq = rint(x * (1 / xs));
//   2. gate = (f32(xq . wg) * xs) * s_g, up = (f32(xq . wu) * xs) * s_u,
//      the int32 sums exact; h = act(gate) * up in f32 (gelu-tanh term by
//      term, or silu);
//   3. per (row, group t of bf columns): hs = max(absmax(h), 1e-9) *
//      (1/127), hq = rint(h * (1 / hs));
//   4. per group in order, the exact int32 partial of hq against the
//      group's down weights, acc = acc + f32(part) * hs[row, t]; then
//      y = acc * s_d, stored in x's dtype.
//   The kernels compute this function bit for bit (up to the card's tanh
//   or exp): the int32 sums are exact in any order, every float operation
//   is the plain version's, and the group sum runs in group order in one
//   thread.
//
// Bound on the H100: at Gemma-2B (D 2048, F 16384) the 48 MiB of packed
//   weights (gate/up 32 MiB, down 16 MiB), about 15 us at 3.35 TB/s, up to
//   a few hundred rows; at a prefill pass (M 1024) the 3 * 2*M*F*D = 206 G
//   int8 operations, about 0.10 ms at the 1,979 TOP/s tensor-core peak.
//
// Design: four launches on the int8 tensor-core core's pieces
//   (int8_tc_gemm.cuh: its row quantize, wgmma m64n128k32 s8 tiles fed by
//   a TMA ring, the split-half unpack), each a programmatic dependent
//   launch where it can start before its predecessor ends:
//   1. the core's quantize_rows_kernel: xq [M, D] int8 and xs [M];
//   2. gate/up: one block a 64 x 64-column (or 128 x 64) tile of h. Its B
//      tile of a stage is the packed [128 rows, 128 bytes] of gate rows
//      f0 .. f0 + 63 and up rows F + f0 .. F + f0 + 63, two TMA boxes of
//      64 rows into the halves of one 128-row swizzled tile (the halves
//      start 1024-byte aligned, so the swizzle is the one a single box
//      gives). The accumulator's columns 0-63 are then gate and 64-127 up
//      of the same F columns, and the epilogue forms h = act(gate) * up
//      from the two halves of the staged int32 tile: gu [M, 2F] never
//      goes to memory, h [M, F] f32 does (the group's absmax spans bf
//      columns, more than a tile). At one warpgroup (M <= 64) a block
//      keeps two ring stages and one unpack buffer (99 KB), so two blocks
//      share an SM: the 256 tiles at decode run in one wave, one block's
//      unpack beside the other's wgmma. With one buffer, every warp's
//      wgmma of step i ends (a barrier) before step i + 1 unpacks into it.
//      D splits into no K slices.
//   3. hquant_kernel: one block a (row, group): the group's h read once
//      into shared memory, its absmax (a maximum: any order gives the
//      plain version's), hs and hq [M, F] int8.
//   4. down: the core's tile over hq [M, F] against the group-split down
//      weight [D, F/2] (pack_int4_split_grouped: byte j of group g holds
//      column g*bf + j in its low nibble and g*bf + bf/2 + j in its high
//      one). A stage's 128 packed bytes at P lie in one group (bf % 256 ==
//      0), so its lo codes are hq columns P + g*bf/2 .. + 127 and its hi
//      codes those + bf/2: only the A tiles' TMA coordinates differ from
//      the core's split-half loader, the unpack is the same. At the end of
//      each group (bf/256 stages) the int32 sums are flushed into an f32
//      accumulator with the group's hs (|part| <= bf * 127 * 8 < 2^24:
//      f32(part) is exact) and zeroed: R[g] = R[g - 1] + f32(part) * hs,
//      the plain version's association, which chip_smoke.py's fused-block
//      check holds bit for bit (the block's x_ffn against this kernel).
//      Where the tiles leave SMs idle (16 at decode, 64 at M 256), a
//      tile's groups go round-robin to the `chain` blocks of a cluster
//      (group g to block g % chain; as many blocks as the SMs take, at
//      most 8, and whose clusters all fit at once by the occupancy query:
//      6 at decode on the H100): each block forms f32(part) * hs of its
//      groups on its own, and R[g - 1] comes from the block before it in
//      the chain, each thread's 64 sums stored straight from its
//      registers into that block's inbox (st.async, completing on its
//      barrier); the block of the last group stores y = R * s_d. The
//      chain's hops are serial, one a group, so many small groups (bf
//      512) gain less than few large ones. At one warpgroup step i + 1's
//      tile unpacks while step i's wgmma run (two unpack buffers).
//   Both contractions unpack with the core's `unpack_split_tile`. The
//   kernels are in mlp_int4_drq.cuh, shared with the fused decode block
//   (fused_block.cu), which adds a residual epilogue to the down and runs
//   the same pair tile for its QKV projection. No float
//   atomics and no global scratch beyond the caller's: h, xq and xs live in
//   the caller's gu buffer ([M, 2F] f32), hq and hs in its own.
//
// Shapes: D % 32 == 0, bf % 256 == 0 (a stage of the down lies in one
//   group; the TPU kernel's (d, bf/2) block needs bf/2 % 128 == 0 too),
//   bf <= 8192, F % bf == 0 and room for xq and xs beside h in gu; else
//   kShapeRefused.
#include "mlp_int4_drq.cuh"

namespace {

using namespace aeqt::mlp;  // and its alias tc of aeqt::tc

// The byte offsets of h, xq and xs in the caller's f32 scratch gu [M, 2F].
inline size_t xq_offset(int M, int F) { return (size_t)M * F * 4; }
inline size_t xs_offset(int M, int D, int F) {
  return xq_offset(M, F) + (((size_t)M * D + 15) & ~(size_t)15);
}

bool takes(int M, int D, int F, int bf) {
  return shape_ok(M, D, F, bf) &&
         xs_offset(M, D, F) + (size_t)M * 4 <= (size_t)M * F * 8;
}

template <typename TIn>
int launch_all(const void* x, const void* wgu, const void* sgu,
               const void* wd, const void* sd, void* gu, void* hq, void* hs,
               void* out, int M, int D, int F, int bf, int act_silu,
               cudaStream_t stream) {
  float* h = static_cast<float*>(gu);
  uint8_t* base = static_cast<uint8_t*>(gu);
  int8_t* xq = reinterpret_cast<int8_t*>(base + xq_offset(M, F));
  float* xs = reinterpret_cast<float*>(base + xs_offset(M, D, F));
  int err = tc::launch_quantize<Loader, TIn>(x, xq, xs, M, D, stream);
  if (err != 0) return err;
  err = launch_gemm<kGateUp, float>(
      gate_up_plan(M, D, F), xq, D, wgu, D / 2, 2 * F, xs,
      static_cast<const float*>(sgu), h, M, F, D, F, bf, act_silu, stream);
  if (err != 0) return err;
  err = launch_hquant(h, static_cast<int8_t*>(hq), static_cast<float*>(hs), M,
                      F, bf, stream);
  if (err != 0) return err;
  return launch_gemm<kDown, TIn>(
      down_plan<TIn>(M, D, F, bf), hq, F, wd, F / 2, D,
      static_cast<const float*>(hs), static_cast<const float*>(sd),
      static_cast<TIn*>(out), M, D, D, F, bf, act_silu, stream);
}

}  // namespace

// x [M, D] f32 or bf16 (x_bf16); wgu [2F, D/2] uint8 split-half packed;
// sgu [2F] f32; wd [D, F/2] uint8 group-split packed (group bf); sd [D] f32;
// scratch gu f32 [M, 2F] (h, xq and xs), hq int8 [M, F], hs f32 [M, F/bf];
// out [M, D] in x's dtype. Takes D % 32 == 0, bf % 256 == 0 (at most
// 8192), F % bf == 0; refuses any other shape with kShapeRefused before
// any launch.
extern "C" int aeqt_mlp_int4_drq(const void* x, int x_bf16, const void* wgu,
                                 const void* sgu, const void* wd,
                                 const void* sd, void* gu, void* hq, void* hs,
                                 void* out, int M, int D, int F, int bf,
                                 int act_silu, void* stream) {
  if (!takes(M, D, F, bf)) return aeqt::kShapeRefused;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return launch_all<__nv_bfloat16>(x, wgu, sgu, wd, sd, gu, hq, hs, out, M,
                                     D, F, bf, act_silu, s);
  return launch_all<float>(x, wgu, sgu, wd, sd, gu, hq, hs, out, M, D, F, bf,
                           act_silu, s);
}

// The two contractions' launches (kernels/mlp.py DRQ_PLAN_FIELDS): for
// gate/up, then down, grid x (row tiles), grid y (column tiles), grid z
// (the down's chain: blocks of a cluster), threads, ring stages and
// dynamic shared memory; or kShapeRefused.
extern "C" int aeqt_mlp_int4_drq_plan(int M, int D, int F, int bf,
                                      long long* fields) {
  if (!takes(M, D, F, bf)) return aeqt::kShapeRefused;
  const Gemm gs[2] = {gate_up_plan(M, D, F),
                      down_plan<__nv_bfloat16>(M, D, F, bf)};
  for (int i = 0; i < 2; ++i) gemm_fields(gs[i], fields + 6 * i);
  return 0;
}
