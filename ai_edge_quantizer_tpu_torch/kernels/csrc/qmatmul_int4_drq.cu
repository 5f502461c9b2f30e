// C entry point of the int4 DRQ matmul; the kernel and its design note are
// in qmatmul_int4_drq.cuh (shared with the MLP's gate/up projection).
#include "qmatmul_int4_drq.cuh"

// x [M, K] f32 or bf16 (x_bf16); w [N, K/2] uint8 split-half packed;
// scale [N] f32; bias [N] f32 or null; out [M, N] in x's dtype.
// Requires K % 32 == 0 and 16-byte aligned w rows.
extern "C" int aeqt_qmatmul_int4_drq(const void* x, int x_bf16, const void* w,
                                     const void* scale, const void* bias,
                                     void* out, int M, int N, int K,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return aeqt::launch_qmatmul<__nv_bfloat16, __nv_bfloat16>(
        x, w, scale, bias, out, M, N, K, s);
  return aeqt::launch_qmatmul<float, float>(x, w, scale, bias, out, M, N, K,
                                            s);
}
