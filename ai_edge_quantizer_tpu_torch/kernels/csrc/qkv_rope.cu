// The decode layer's attention prologue: RMS norm + packed int4 QKV
// projection + head split + RoPE of q and k.
//
// Replaces: ai_edge_quantizer_tpu/kernels/pallas_qkv.py qkv_rope_pallas
//   (_qkv_rope_kernel), the JAX executor's AEQT_ATTN_BLOCK prologue. With T
//   the activation dtype (bf16 for bf16 x, else f32):
//     xn  = T(T(x * T(r)) * gamma), r = 1 / sqrt(mean(x^2) + eps)
//     DRQ: xs = max(absmax(xn), 1e-9) * (1/127), xq = rint(xn * (1/xs)),
//          head i's projection T((acc_i * xs) * s), int32 sums;
//     weight-only: T((xn_lo . w_lo^T + xn_hi . w_hi^T) * s), f32 sums;
//     q, k: half-split RoPE of each head in f32 (x1*cos - x2*sin,
//          x2*cos + x1*sin, column j paired with j + h/2), cast to T;
//     v: the value heads as they are.
//
// Bound on the H100 at bench.py's decode (Gemma-2B: M 256, D 2048, 8 query
//   heads and 1 KV head of 256, N 2560): the int8 work 2 * M * N * D =
//   2.7 GOP at 1,979 TOP/s, 1.4 us, above the bytes (2.6 MB of packed
//   weight, 1 MB of x, 1.3 MB of outputs: 1.5 us at 3.35 TB/s): about
//   0.0015 ms either way.
//
// Design (simple first): three launches on the caller's stream, each
//   written once and read after it. (1) the norm (norm_rows.cuh, one warp a
//   row) into an xn scratch in T; (2) the projection of all heads at once
//   into a qkv scratch [M, N] in T, by the port's packed-FC tiles: the DRQ
//   one (qmatmul_int4_drq.cuh: 16 rows quantized into shared memory with
//   the formula above, __dp4a int32 sums, so bit for bit the plain
//   version) or the weight-only one (qmatmul_int4_weight_only.cuh,
//   mma.sync bf16 with f32 sums); (3) the RoPE and the split into q, k and
//   v, one thread an output element. The TPU kernel keeps xn, the
//   projection and the pre-rope heads in VMEM; here they make a round trip
//   through L2 (1 MiB and 1.3 MiB at the bench shape). Rotating a whole
//   head in the projection's epilogue, so that only q, k and v leave the
//   chip, is later work.
#include "norm_rows.cuh"
#include "qmatmul_int4_drq.cuh"
#include "qmatmul_int4_weight_only.cuh"

namespace {

constexpr int kRopeThreads = 256;

// q [M, nq*h] and k [M, nk*h] rope'd from heads 0..nq+nk-1 of qkv
// [M, (nq+2nk)*h]; v [M, nk*h] = heads nq+nk.. as they are.
template <typename T>
__global__ void __launch_bounds__(kRopeThreads)
rope_split_kernel(const T* __restrict__ qkv, const float* __restrict__ cos,
                  const float* __restrict__ sin, T* __restrict__ q,
                  T* __restrict__ k, T* __restrict__ v, int M, int nq, int nk,
                  int h) {
  const int n = (nq + 2 * nk) * h, half = h / 2;
  const size_t total = (size_t)M * n;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int m = (int)(i / n), c = (int)(i % n);
    const int head = c / h, j = c % h;
    const T* row = qkv + (size_t)m * n + (size_t)head * h;
    if (head >= nq + nk) {  // v: the head as it is
      v[(size_t)m * nk * h + (size_t)(head - nq - nk) * h + j] = row[j];
      continue;
    }
    const int jj = j < half ? j : j - half;
    const float x1 = aeqt::load_f(row, jj), x2 = aeqt::load_f(row, jj + half);
    const float cs = cos[(size_t)m * half + jj], sn = sin[(size_t)m * half + jj];
    const float y = j < half ? x1 * cs - x2 * sn : x2 * cs + x1 * sn;
    if (head < nq)
      aeqt::store_f(q, (size_t)m * nq * h + (size_t)head * h + j, y);
    else
      aeqt::store_f(k, (size_t)m * nk * h + (size_t)(head - nq) * h + j, y);
  }
}

template <typename T>
int run(const void* x, const float* gamma, const void* w, const void* scale,
        const float* cos, const float* sin, void* xn, void* qkv, void* q,
        void* k, void* v, int M, int D, int nq, int nk, int h, float eps,
        bool drq, cudaStream_t stream) {
  const int N = (nq + 2 * nk) * h;
  // DRQ tiles: K % 32 (16-byte weight chunks of each half) and 16 rows of
  // xq in shared memory; weight-only tiles: N % 64 and K % 128.
  const bool ok = drq ? D % 32 == 0 &&
                            aeqt::smem_fits(aeqt::qmatmul_smem_bytes(D))
                      : aeqt::wo_shape_ok(M, N, D, D);
  if (M <= 0 || h % 2 || nq < 1 || nk < 1 || !ok) return aeqt::kShapeRefused;
  int err = aeqt::launch_rmsnorm_rows<T, false>(x, gamma, xn, M, D, eps,
                                                 stream);
  if (err != 0) return err;
  err = drq ? aeqt::launch_qmatmul<T, T>(xn, w, scale, nullptr, qkv, M, N, D,
                                         stream)
            : aeqt::launch_wo<T, T>(xn, w, scale, nullptr, qkv, M, N, D, D,
                                    nullptr, stream);
  if (err != 0) return err;
  const size_t total = (size_t)M * N;
  const int blocks =
      (int)std::min<size_t>((total + kRopeThreads - 1) / kRopeThreads, 65536);
  rope_split_kernel<T><<<blocks, kRopeThreads, 0, stream>>>(
      static_cast<const T*>(qkv), cos, sin, static_cast<T*>(q),
      static_cast<T*>(k), static_cast<T*>(v), M, nq, nk, h);
  return (int)cudaGetLastError();
}

}  // namespace

// x [M, D] bf16 (x_bf16) or f32; gamma [D] f32; w [(nq+2nk)*h, D/2] uint8
// split-half packed, rows 16-byte aligned; scale [(nq+2nk)*h] f32; cos, sin
// [M, h/2] f32; xn [M, D] and qkv [M, (nq+2nk)*h] scratch, q [M, nq*h],
// k and v [M, nk*h], all in x's dtype. drq: the int8 DRQ projection, else
// weight-only. Refuses with kShapeRefused, before launching anything, an
// odd h, and a D (DRQ: D % 32, 16 rows of D int8 in shared memory) or N
// (weight-only: N % 64, D % 128) that the projection tiles do not take.
extern "C" int aeqt_qkv_rope(const void* x, int x_bf16, const void* gamma,
                             const void* w, const void* scale,
                             const void* cos, const void* sin, void* xn,
                             void* qkv, void* q, void* k, void* v, int M,
                             int D, int nq, int nk, int h, float eps, int drq,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* c = static_cast<const float*>(cos);
  const float* sn = static_cast<const float*>(sin);
  if (x_bf16)
    return run<__nv_bfloat16>(x, g, w, scale, c, sn, xn, qkv, q, k, v, M, D,
                              nq, nk, h, eps, drq != 0, s);
  return run<float>(x, g, w, scale, c, sn, xn, qkv, q, k, v, M, D, nq, nk, h,
                    eps, drq != 0, s);
}
