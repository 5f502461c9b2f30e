// GeGLU MLP with packed int4 weights and DRQ activations:
//   y[M, D] = down(act(gate(x)) * up(x))
//
// Replaces: ai_edge_quantizer_tpu/kernels/pallas_mlp.py
//   mlp_pallas_int4_packed, DRQ branch (_mlp_drq_kernel).
//
// Bound on the H100: the weight stream. At Gemma-2B shapes (D = 2048,
//   F = 16384) the gate/up weight is 2F x D/2 = 32 MiB and the down weight
//   D x F/2 = 16 MiB: about 15 us at 3.35 TB/s. At M = 64 the int8 work
//   (3 * 2*M*F*D = 13 GOP) would take about 6.5 us at the 1,979 TOP/s peak.
//
// Design (simple first, deterministic). The TPU kernel carries an f32
//   accumulator across its F-groups in grid order; CUDA blocks run in no
//   order, so the work is split into three launches and the sum over
//   F-groups runs in order inside one thread, without float atomics:
//   1. gate/up: the int4 DRQ matmul (qmatmul_int4_drq.cuh) against the
//      [2F, D/2] weight with an f32 output gu [M, 2F]: the same
//      (float(acc) * xs) * s values the TPU kernel forms per tile.
//   2. act + quantize: one block per (row, F-group of bf columns) computes
//      h = act(gate) * up, its absmax, hs = max(absmax, 1e-9) * (1/127) and
//      hq = rint(h * (1/hs)): hq int8 [M, F] and hs f32 [M, F/bf].
//   3. down: a block takes 8 rows x 64 output columns with the 8 rows of
//      hq in shared memory; each warp walks 8 columns of the group-split
//      weight [D, F/2] and, group by group in order, forms the exact int32
//      partial with __dp4a and adds float(part) * hs[row, group] to an f32
//      accumulator; the output is acc * s_d.
//   gu and hq round-trip device memory (8 MiB and 1 MiB at M = 64; both fit
//   in L2). A later PR can keep them on chip.
#include "qmatmul_int4_drq.cuh"

namespace {

constexpr int kActThreads = 256;
constexpr int kDownBM = 8;
constexpr int kDownWarps = 8;
constexpr int kDownColsPerWarp = 8;
constexpr int kDownBN = kDownWarps * kDownColsPerWarp;

// pallas_mlp._gelu_tanh, term by term: 0.5 * x * (1 + tanh(c * (x +
// 0.044715 * x * x * x))), every product rounded (the library is built
// with --fmad=false).
__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;
  float cube = 0.044715f * x;
  cube = cube * x;
  cube = cube * x;
  const float t = tanhf(c * (x + cube));
  return (0.5f * x) * (1.0f + t);
}

__device__ __forceinline__ float silu(float x) {
  return x * (1.0f / (1.0f + expf(-x)));
}

// gu [M, 2F] f32 -> hq [M, F] int8, hs [M, F / bf] f32.
// grid (M, F / bf); h for the group is staged in shared memory.
__global__ void __launch_bounds__(kActThreads)
act_quant_kernel(const float* __restrict__ gu, int8_t* __restrict__ hq,
                 float* __restrict__ hs, int F, int bf, int act_silu) {
  extern __shared__ float hbuf[];  // [bf]
  __shared__ float wmax[kActThreads / 32];
  const int m = blockIdx.x, t = blockIdx.y;
  const float* gate = gu + (size_t)m * 2 * F + (size_t)t * bf;
  const float* up = gate + F;
  float amax = 0.0f;
  for (int j = threadIdx.x; j < bf; j += blockDim.x) {
    const float g = gate[j];
    const float a = act_silu ? silu(g) : gelu_tanh(g);
    const float h = a * up[j];
    hbuf[j] = h;
    amax = fmaxf(amax, fabsf(h));
  }
  amax = aeqt::warp_max(amax);
  if ((threadIdx.x & 31) == 0) wmax[threadIdx.x >> 5] = amax;
  __syncthreads();
  float bmax = 0.0f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) bmax = fmaxf(bmax, wmax[w]);
  const float s = fmaxf(bmax, 1e-9f) * aeqt::kInv127;
  const float inv = 1.0f / s;
  int8_t* dst = hq + (size_t)m * F + (size_t)t * bf;
  for (int j = threadIdx.x; j < bf; j += blockDim.x)
    dst[j] = (int8_t)__float2int_rn(hbuf[j] * inv);
  if (threadIdx.x == 0) hs[(size_t)m * (F / bf) + t] = s;
}

template <typename TOut>
__global__ void __launch_bounds__(kDownWarps * 32)
down_kernel(const int8_t* __restrict__ hq, const float* __restrict__ hs,
            const uint8_t* __restrict__ wd, const float* __restrict__ sd,
            TOut* __restrict__ out, int M, int D, int F, int bf) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* hrows = reinterpret_cast<int8_t*>(smem);  // [kDownBM][F]
  const int m0 = blockIdx.x * kDownBM;
  const int d0 = blockIdx.y * kDownBN;
  const int ngroups = F / bf;
  // Stage the block's rows of hq (rows past M are zeros), 16 bytes a thread.
  for (int i = threadIdx.x * 16; i < kDownBM * F; i += blockDim.x * 16) {
    const int r = i / F, col = i % F;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (m0 + r < M)
      v = *reinterpret_cast<const uint4*>(hq + (size_t)(m0 + r) * F + col);
    *reinterpret_cast<uint4*>(hrows + i) = v;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int f2 = F / 2, b2 = bf / 2;
  const bool row_ok = lane < kDownBM && m0 + lane < M;
  for (int c = 0; c < kDownColsPerWarp; ++c) {
    const int d = d0 + warp * kDownColsPerWarp + c;
    if (d >= D) break;  // warp-uniform
    const uint8_t* wrow = wd + (size_t)d * f2;
    float facc = 0.0f;
    for (int t = 0; t < ngroups; ++t) {
      int acc[kDownBM] = {};
      aeqt::dot_packed<kDownBM>(wrow + (size_t)t * b2, b2, hrows + t * bf,
                                hrows + t * bf + b2, F, lane, acc);
      aeqt::warp_reduce_rows<kDownBM>(acc);
      const int mine = aeqt::pick_row<kDownBM>(acc, lane);
      if (row_ok) facc = facc + (float)mine * hs[(size_t)(m0 + lane) * ngroups + t];
    }
    if (row_ok) aeqt::store_f(out, (size_t)(m0 + lane) * D + d, facc * sd[d]);
  }
}

template <typename TIn>
int launch_all(const void* x, const void* wgu, const void* sgu,
               const void* wd, const void* sd, void* gu, void* hq, void* hs,
               void* out, int M, int D, int F, int bf, int act_silu,
               cudaStream_t stream) {
  int err = aeqt::launch_qmatmul<TIn, float>(x, wgu, sgu, nullptr, gu, M,
                                             2 * F, D, stream);
  if (err != 0) return err;
  act_quant_kernel<<<dim3(M, F / bf), kActThreads, bf * sizeof(float),
                     stream>>>(static_cast<const float*>(gu),
                               static_cast<int8_t*>(hq),
                               static_cast<float*>(hs), F, bf, act_silu);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const size_t smem = (size_t)kDownBM * F;
  auto* kernel = down_kernel<TIn>;
  err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != 0) return err;
  const dim3 grid((M + kDownBM - 1) / kDownBM, (D + kDownBN - 1) / kDownBN);
  kernel<<<grid, kDownWarps * 32, smem, stream>>>(
      static_cast<const int8_t*>(hq), static_cast<const float*>(hs),
      static_cast<const uint8_t*>(wd), static_cast<const float*>(sd),
      static_cast<TIn*>(out), M, D, F, bf);
  return (int)cudaGetLastError();
}

}  // namespace

// x [M, D] f32 or bf16 (x_bf16); wgu [2F, D/2] uint8 split-half packed;
// sgu [2F] f32; wd [D, F/2] uint8 group-split packed (group bf); sd [D] f32;
// scratch gu f32 [M, 2F], hq int8 [M, F], hs f32 [M, F/bf]; out [M, D] in
// x's dtype. D % 32 == 0, bf % 32 == 0, F % bf == 0.
extern "C" int aeqt_mlp_int4_drq(const void* x, int x_bf16, const void* wgu,
                                 const void* sgu, const void* wd,
                                 const void* sd, void* gu, void* hq, void* hs,
                                 void* out, int M, int D, int F, int bf,
                                 int act_silu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return launch_all<__nv_bfloat16>(x, wgu, sgu, wd, sd, gu, hq, hs, out, M,
                                     D, F, bf, act_silu, s);
  return launch_all<float>(x, wgu, sgu, wd, sd, gu, hq, hs, out, M, D, F, bf,
                           act_silu, s);
}
