// Blockwise packed int4 matmul: y[M, N] = x . unpack(w[N, K/2])^T with one
// f32 scale per block of bs K-columns (scale [N, K/bs]), f32 sums, then the
// bias, cast to x's dtype.
//
// Replaces: ai_edge_quantizer_tpu/kernels/pallas_qmatmul.py
//   qmatmul_pallas_int4_packed_blockwise (_int4_blockwise_2d_kernel). The
//   JAX executor sends every packed blockwise int4 FC here (block size a
//   multiple of 128): under add_dynamic_config(..., granularity=
//   BLOCKWISE_128) each FC of a Gemma layer (QKV N 2560, out N 2048,
//   gate/up N 32768 at K 2048; down N 2048 at K 16384) and the tied head
//   (N 256128), since no MLP, head or QKV fusion takes a blockwise weight.
//
// Arithmetic (the Pallas kernel's, in its order): the weight is split-half
//   packed (byte j of a row holds column j in its low nibble and column
//   K/2 + j in its high nibble), so byte block jb (bytes [jb*bs, (jb+1)*bs))
//   holds K-block jb in its low nibbles and K-block nb/2 + jb in its high
//   nibbles (nb = K/bs). For each byte block in order:
//     p_lo = x[:, jb*bs : +bs] . lo^T,  p_hi = x[:, K/2 + jb*bs : +bs] . hi^T
//     y    = y + (p_lo * s[:, jb] + p_hi * s[:, nb/2 + jb])
//   each product and sum rounded on its own (--fmad=false); after the last
//   block y = y + bias; the result is cast to x's dtype. x is an operand in
//   its compute dtype (bf16 for bf16 x, else f32); a bf16 value times an
//   int4 value is exact in f32, so only the order of the f32 sums within a
//   block differs from the plain version and the MXU.
//
// Bound on the H100: at decode rows (M = 64) the packed weight and its
//   scales, N*K/2 + 4*N*K/bs bytes over 3.35 TB/s (0.8 us for N 2048, K
//   2048, bs 128); at a prefill pass's rows (M = 1024) the operations,
//   2*M*N*K at the bf16 tensor-core peak (both operands exact in bf16).
//
// Design:
//   * bf16 x: the bf16 tensor-core core int4_bf16_tc_gemm.cuh, policy
//     BlockScale: a TMA ring of x and packed weight tiles, the weights
//     widened in registers into wgmma's A fragments, wgmma m64nNk16 into lo
//     and hi accumulators that the byte block's end scales into y every
//     bs/64 steps. Where the tiles leave SMs idle (decode), whole byte
//     blocks split over a thread-block cluster, whose partial tiles add in
//     distributed shared memory: one launch, no global scratch.
//   * f32 x: SIMT f32, a 128-thread block computes a 32 x 64 tile over
//     steps of 32 packed bytes (qmatmul_int4_simt.cuh's weight-only kernel
//     with a block epilogue every bs/32 steps).
#include "int4_bf16_tc_gemm.cuh"
#include "qmatmul_int4_simt.cuh"

namespace {

using namespace aeqt;

// f32 x: SIMT. As qmatmul_int4_wo_kernel with group K, the partials scaled
// and added into y at the end of each byte block of bs bytes.
template <typename TOut>
__global__ void __launch_bounds__(kWpThreads)
blockwise_simt_kernel(const float* __restrict__ x,
                      const uint8_t* __restrict__ w,
                      const float* __restrict__ scale,
                      const float* __restrict__ bias, TOut* __restrict__ out,
                      int M, int N, int K, int bs) {
  __shared__ __align__(16) float xlo[kWpBK][kWpBM + 4];
  __shared__ __align__(16) float xhi[kWpBK][kWpBM + 4];
  __shared__ __align__(16) float wlo[kWpBK][kWpBN + 4];
  __shared__ __align__(16) float whi[kWpBK][kWpBN + 4];
  const int tid = threadIdx.x;
  const int tm = tid / (kWpBN / 4);
  const int tn = tid % (kWpBN / 4);
  const int m0 = blockIdx.y * kWpBM;
  const int n0 = blockIdx.x * kWpBN;
  const int K2 = K / 2, nb = K / bs, nb2 = nb / 2;

  float y[4][4] = {};
  float plo[4][4] = {};
  float phi[4][4] = {};
  for (int j0 = 0; j0 < K2; j0 += kWpBK) {
    for (int e = tid; e < kWpBM * kWpBK; e += kWpThreads) {
      const int r = e / kWpBK, c = e % kWpBK;
      float lo = 0.0f, hi = 0.0f;
      if (m0 + r < M) {
        const size_t row = (size_t)(m0 + r) * K;
        lo = x[row + j0 + c];
        hi = x[row + K2 + j0 + c];
      }
      xlo[c][r] = lo;
      xhi[c][r] = hi;
    }
    {
      const int r = tid / 2, c = (tid % 2) * 16;
      const int4 v = __ldg(reinterpret_cast<const int4*>(
          w + (size_t)(n0 + r) * K2 + j0 + c));
      const int words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int byte = (words[q] >> (8 * b)) & 0xFF;
          wlo[c + 4 * q + b][r] = (float)(((byte & 0xF) ^ 8) - 8);
          whi[c + 4 * q + b][r] = (float)(((byte >> 4) ^ 8) - 8);
        }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kWpBK; ++kk) {
      const float4 al = *reinterpret_cast<const float4*>(&xlo[kk][tm * 4]);
      const float4 bl = *reinterpret_cast<const float4*>(&wlo[kk][tn * 4]);
      const float4 ah = *reinterpret_cast<const float4*>(&xhi[kk][tm * 4]);
      const float4 bh = *reinterpret_cast<const float4*>(&whi[kk][tn * 4]);
      const float alv[4] = {al.x, al.y, al.z, al.w};
      const float blv[4] = {bl.x, bl.y, bl.z, bl.w};
      const float ahv[4] = {ah.x, ah.y, ah.z, ah.w};
      const float bhv[4] = {bh.x, bh.y, bh.z, bh.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          plo[i][j] = __fmaf_rn(alv[i], blv[j], plo[i][j]);
          phi[i][j] = __fmaf_rn(ahv[i], bhv[j], phi[i][j]);
        }
    }
    __syncthreads();
    if ((j0 + kWpBK) % bs == 0) {  // the end of byte block jb
      const int jb = j0 / bs;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tn * 4 + j;
        const float slo = scale[(size_t)n * nb + jb];
        const float shi = scale[(size_t)n * nb + nb2 + jb];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float acc = plo[i][j] * slo + phi[i][j] * shi;
          y[i][j] = y[i][j] + acc;
          plo[i][j] = 0.0f;
          phi[i][j] = 0.0f;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + tm * 4 + i;
    if (m >= M) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tn * 4 + j;
      float v = y[i][j];
      if (bias != nullptr) v = v + bias[n];
      store_f(out, (size_t)m * N + n, v);
    }
  }
}

// N % 64 == 0 (whole tiles), bs % 128 == 0 (whole stages of 64 bytes and
// steps of 32 in a block), K/bs even and K/2 % bs == 0 (the split-half
// layout pairs byte block jb with K-blocks jb and nb/2 + jb): the core's
// `takes` with bs.
bool blockwise_shape_ok(int M, int N, int K, int bs) {
  return bs > 0 && aeqt::w4::takes(M, N, K, bs) && N % kWpBN == 0;
}

}  // namespace

// x [M, K] bf16 (x_bf16) or f32, 16-byte aligned; w [N, K/2] uint8
// split-half packed, 16-byte aligned; scale [N, K/bs] f32; bias [N] f32 or
// null; out [M, N] in x's dtype. Refuses (kShapeRefused), before any
// launch, unless N % 64 == 0, bs % 128 == 0 and K % (2 * bs) == 0.
extern "C" int aeqt_qmatmul_int4_blockwise(const void* x, int x_bf16,
                                           const void* w, const void* scale,
                                           const void* bias, void* out,
                                           int M, int N, int K, int bs,
                                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!blockwise_shape_ok(M, N, K, bs)) return kShapeRefused;
  if (x_bf16)
    return aeqt::w4::run<aeqt::w4::BlockScale>(x, w, scale, bias, out, M, N,
                                               K, bs, s);
  const dim3 grid(N / kWpBN, (M + kWpBM - 1) / kWpBM);
  blockwise_simt_kernel<float><<<grid, kWpThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const uint8_t*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<float*>(out), M, N, K, bs);
  return (int)cudaGetLastError();
}

// The launch the bf16 path gives this shape (int4_bf16_tc_gemm.cuh
// plan_fields: grid x, y, z, threads, shared memory, stages, tokens a tile),
// or kShapeRefused.
extern "C" int aeqt_qmatmul_int4_blockwise_plan(int M, int N, int K, int bs,
                                                long long* fields) {
  if (!blockwise_shape_ok(M, N, K, bs)) return kShapeRefused;
  aeqt::w4::plan_fields<aeqt::w4::BlockScale>(M, N, K, bs, fields);
  return 0;
}
