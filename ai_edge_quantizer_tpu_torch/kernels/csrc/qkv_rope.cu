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
//     q, k: half-split RoPE of each head's projection (already rounded to
//          T) in f32 (x1*cos - x2*sin, x2*cos + x1*sin, column j paired
//          with j + h/2), cast to T;
//     v: the value heads as they are.
//
// Bound on the H100 at bench.py's decode (Gemma-2B: M 256, D 2048, 8 query
//   heads and 1 KV head of 256, N 2560): the int8 work 2 * M * N * D =
//   2.7 GOP at 1,979 TOP/s, 1.4 us, above the bytes (2.6 MB of packed
//   weight, 1 MB of x, 1.3 MB of outputs: 1.5 us at 3.35 TB/s): about
//   0.0015 ms either way.
//
// Design: the launches of the unfused parts' cores, each a programmatic
//   dependent launch on the one before where the core takes it (its first
//   weight tiles load while the launch before runs), every step of the
//   arithmetic the plain version's (kernels/qkv.py), each product and sum
//   rounded on its own (--fmad=false). Routes, by a fixed rule on the
//   shape:
//   * DRQ, h % 128 == 0 (bench.py's path), two launches: (1) the norm
//     ending in the row's DRQ codes, one block a row (norm_rows.cuh
//     rmsnorm_quant_rows_kernel: xq int8 and xs, no xn; the norm and the
//     int8 core's row quantize as two dependent launches measured 2-3 us
//     slower at bench.py's 256 rows on the H100, kernel_study.py variants
//     'norm_then_quantize'); (2) the QKV on the int8 core in pair tiles
//     (mlp_int4_drq.cuh mlp_tc_kernel, kind kQkvRope, the fused block's
//     QKV tile with its own epilogue): a tile's B rows are rows e0 .. and
//     e0 + H/2 .. of one head, so one thread holds both halves of a
//     rotation; the epilogue rounds the projection to T, rotates the query
//     and key heads and stores q, k and v. No [M, N] scratch, no RoPE
//     launch.
//   * weight-only, bf16 x, h % 128 == 0, two launches: (1) the norm
//     (norm_rows.cuh, xn in T into the xn scratch); (2) the bf16 wgmma core
//     (int4_bf16_tc_gemm.cuh, policy QkvRopePairs: #14's contraction in
//     pair tiles of 64 tokens, lo and hi summed apart and added, split-K
//     in a cluster where the tiles leave SMs idle) with the same RoPE
//     epilogue. The f32 sums differ from the plain version's in order
//     only.
//   * the other shapes the tiles take: the same norm launch, the same
//     core's plain column tile into the qkv scratch [M, N] in T (DRQ: the
//     int8 core, SplitNibblesRecipB, as #1 runs it; weight-only bf16 x:
//     #14's ChannelScaleAfterNorm; weight-only f32 x: #12's SIMT kernel,
//     qmatmul_int4_simt.cuh), then rope_split_kernel, one thread an output
//     element. Weight-only f32 x takes this route at every h, as #14 and
//     #19 keep SIMT for f32 x.
//   The DRQ codes and row scales live in the xn scratch (M * D bytes of
//   codes, then the M scales 16-byte aligned: 2 * M * D bytes hold them for
//   D >= 32), so the C interface keeps its scratch arguments.
#include <limits.h>

#include <type_traits>

#include "int4_bf16_tc_gemm.cuh"
#include "mlp_int4_drq.cuh"
#include "norm_rows.cuh"
#include "qmatmul_int4_simt.cuh"

namespace {

namespace mlp = aeqt::mlp;
namespace tc = aeqt::tc;
namespace w4 = aeqt::w4;

constexpr int kRopeThreads = 256;
constexpr int kPairH = 128;  // the pair tiles take h % kPairH == 0

// The launches of a shape, by the fixed rule of the header.
enum Route : int {
  kDrqPair = 0,     // norm + codes, int8 pair tile with RoPE
  kDrqColumns = 1,  // norm + codes, int8 column tile, rope_split_kernel
  kBf16Pair = 2,    // norm, bf16 core's pair tile with RoPE
  kBf16Columns = 3, // norm, bf16 core's column tile, rope_split_kernel
  kF32Simt = 4,     // norm, SIMT f32 tile, rope_split_kernel
};

// The route of a shape, or -1 where no route takes it.
int route_of(int M, int D, int nq, int nk, int h, bool drq, bool x_bf16) {
  if (M <= 0 || D <= 0 || h <= 0 || h % 2 || nq < 1 || nk < 1) return -1;
  const long long n = (long long)(nq + 2 * nk) * h;
  if (drq) {
    // The int8 core: K % 32 (16-byte halves of each packed row).
    if (D % 32 || (n + tc::kBN - 1) / tc::kBN > 65535) return -1;
    return h % kPairH == 0 ? kDrqPair : kDrqColumns;
  }
  // The weight-only tiles: N % 64, K % 128 (whole 64-byte stages).
  if (n > INT_MAX || !w4::takes(M, (int)n, D, 0) || n % aeqt::kWpBN)
    return -1;
  if (!x_bf16) return kF32Simt;
  return h % kPairH == 0 ? kBf16Pair : kBf16Columns;
}

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
int launch_rope_split(const void* qkv, const float* cos, const float* sin,
                      void* q, void* k, void* v, int M, int nq, int nk, int h,
                      cudaStream_t stream) {
  const size_t total = (size_t)M * (nq + 2 * nk) * h;
  const int blocks =
      (int)std::min<size_t>((total + kRopeThreads - 1) / kRopeThreads, 65536);
  rope_split_kernel<T><<<blocks, kRopeThreads, 0, stream>>>(
      static_cast<const T*>(qkv), cos, sin, static_cast<T*>(q),
      static_cast<T*>(k), static_cast<T*>(v), M, nq, nk, h);
  return (int)cudaGetLastError();
}

// The codes and the row scales in the xn scratch.
void* row_scales(void* xn, int M, int D) {
  const size_t at = ((size_t)M * D + 15) / 16 * 16;
  return static_cast<uint8_t*>(xn) + at;
}

template <typename T>
int run(int route, const void* x, const float* gamma, const void* w,
        const void* scale, const float* cos, const float* sin, void* xn,
        void* qkv, void* q, void* k, void* v, int M, int D, int nq, int nk,
        int h, float eps, cudaStream_t stream) {
  const int N = (nq + 2 * nk) * h;
  int err = 0;
  if (route == kDrqPair || route == kDrqColumns) {
    void* xs = row_scales(xn, M, D);
    err = aeqt::launch_rmsnorm_quant_rows<T>(x, gamma, xn, xs, M, D, eps,
                                              stream);
    if (err != 0) return err;
    if (route == kDrqPair) {
      mlp::BlockEpilogue ep = {};
      ep.cos = cos;
      ep.sin = sin;
      ep.k = k;
      ep.v = v;
      ep.H = h;
      ep.NQ = nq;
      ep.NK = nk;
      return mlp::launch_gemm<mlp::kQkvRope, T>(
          mlp::qkv_plan(M, D, N), xn, D, w, D / 2, N,
          static_cast<const float*>(xs), static_cast<const float*>(scale),
          static_cast<T*>(q), M, N, D, 0, 0, 0, stream, ep);
    }
    using B = tc::SplitNibblesRecipB;
    err = tc::launch_gemm<B, T>(w, scale, nullptr, qkv, xn, xs, M, N, D,
                                tc::make_plan<B>(M, N, D), stream);
    if (err != 0) return err;
    return launch_rope_split<T>(qkv, cos, sin, q, k, v, M, nq, nk, h, stream);
  }
  err = aeqt::launch_rmsnorm_rows<T, false>(x, gamma, xn, M, D, eps, stream);
  if (err != 0) return err;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (route == kBf16Pair) {
      const w4::RopeOut ro = {cos, sin, k, v, h, nq, nk};
      return w4::run<w4::QkvRopePairs>(xn, w, scale, nullptr, q, M, N, D, 0,
                                       stream, nullptr, ro);
    }
    err = w4::run<w4::ChannelScaleAfterNorm>(xn, w, scale, nullptr, qkv, M,
                                             N, D, 0, stream);
  } else {
    const dim3 grid(N / aeqt::kWpBN, (M + aeqt::kWpBM - 1) / aeqt::kWpBM);
    aeqt::qmatmul_int4_wo_kernel<float, float>
        <<<grid, aeqt::kWpThreads, 0, stream>>>(
            static_cast<const float*>(xn), static_cast<const uint8_t*>(w),
            static_cast<const float*>(scale), nullptr,
            static_cast<float*>(qkv), M, N, D, D, nullptr);
    err = (int)cudaGetLastError();
  }
  if (err != 0) return err;
  return launch_rope_split<T>(qkv, cos, sin, q, k, v, M, nq, nk, h, stream);
}

}  // namespace

// x [M, D] bf16 (x_bf16) or f32; gamma [D] f32; w [(nq+2nk)*h, D/2] uint8
// split-half packed, rows 16-byte aligned; scale [(nq+2nk)*h] f32; cos, sin
// [M, h/2] f32; xn [M, D] (16-byte aligned; DRQ: the codes and row scales)
// and qkv [M, (nq+2nk)*h] scratch, q [M, nq*h], k and v [M, nk*h], all in
// x's dtype. drq: the int8 DRQ projection, else weight-only. Refuses with
// kShapeRefused, before launching anything, an odd h, and a D or N the
// tiles do not take (DRQ: D % 32; weight-only: N % 64, D % 128).
extern "C" int aeqt_qkv_rope(const void* x, int x_bf16, const void* gamma,
                             const void* w, const void* scale,
                             const void* cos, const void* sin, void* xn,
                             void* qkv, void* q, void* k, void* v, int M,
                             int D, int nq, int nk, int h, float eps, int drq,
                             void* stream) {
  const int route = route_of(M, D, nq, nk, h, drq != 0, x_bf16 != 0);
  if (route < 0) return aeqt::kShapeRefused;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* c = static_cast<const float*>(cos);
  const float* sn = static_cast<const float*>(sin);
  if (x_bf16)
    return run<__nv_bfloat16>(route, x, g, w, scale, c, sn, xn, qkv, q, k, v,
                              M, D, nq, nk, h, eps, s);
  return run<float>(route, x, g, w, scale, c, sn, xn, qkv, q, k, v, M, D, nq,
                    nk, h, eps, s);
}

// The launches a shape gets (kernels/qkv.py PLAN_FIELDS): the route (the
// Route enum), the number of launches, the norm's grid and threads, then
// the contraction's grid x, y, z (split or chain), threads, dynamic shared
// memory, ring stages and rows (tokens) a tile; or kShapeRefused.
extern "C" int aeqt_qkv_rope_plan(int M, int D, int nq, int nk, int h,
                                  int drq, int x_bf16, long long* fields) {
  const int route = route_of(M, D, nq, nk, h, drq != 0, x_bf16 != 0);
  if (route < 0) return aeqt::kShapeRefused;
  const int N = (nq + 2 * nk) * h;
  fields[0] = route;
  fields[1] = route == kDrqPair || route == kBf16Pair ? 2 : 3;
  fields[2] = M;
  fields[3] = aeqt::kNormThreads;
  long long* f = fields + 4;
  if (route == kDrqPair) {
    const mlp::Gemm g = mlp::qkv_plan(M, D, N);
    f[0] = g.m_tiles;
    f[1] = g.n_tiles;
    f[2] = g.chain;
    f[3] = 128 * g.wgs + 32;
    f[4] = (long long)g.smem;
    f[5] = g.stages;
    f[6] = tc::kWgRows * g.wgs;
  } else if (route == kDrqColumns) {
    tc::plan_fields<tc::SplitNibblesRecipB>(M, N, D, f);
    f[6] = tc::kWgRows * tc::make_plan<tc::SplitNibblesRecipB>(M, N, D).wgs;
  } else if (route == kBf16Pair) {
    w4::plan_fields<w4::QkvRopePairs>(M, N, D, 0, f);
  } else if (route == kBf16Columns) {
    w4::plan_fields<w4::ChannelScaleAfterNorm>(M, N, D, 0, f);
  } else {
    f[0] = N / aeqt::kWpBN;
    f[1] = (M + aeqt::kWpBM - 1) / aeqt::kWpBM;
    f[2] = 1;
    f[3] = aeqt::kWpThreads;
    f[4] = 0;
    f[5] = 0;
    f[6] = aeqt::kWpBM;
  }
  return 0;
}
