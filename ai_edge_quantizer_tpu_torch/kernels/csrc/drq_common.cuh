// Device helpers shared by the port's DRQ (dynamic-range quantized) kernels.
//
// The formulas copy the Pallas kernels of ai_edge_quantizer_tpu/kernels
// exactly, so that each kernel is bit-equal to its plain PyTorch version:
//   xs = max(absmax(row), 1e-9) * (1/127)      (f32; 1/127 rounded once)
//   xq = rint(x * (1.0f / xs))                 (IEEE divide, half to even)
// The library is built with --fmad=false, so no product and sum below is
// contracted into one FMA.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace aeqt {

constexpr float kInv127 = (float)(1.0 / 127.0);  // jnp: f32(1.0 / 127.0)

// Returned by a C entry point, before any launch, for a shape its kernel
// does not take (never a cudaError_t value). The Python wrapper raises.
constexpr int kShapeRefused = -1;

// Whether `bytes` of dynamic shared memory fit one block on this device.
inline bool smem_fits(size_t bytes) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return false;
  return bytes <= (size_t)optin;
}

__device__ __forceinline__ float load_f(const float* p, size_t i) {
  return p[i];
}
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, size_t i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store_f(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_sum_int(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ double warp_sum_double(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

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

// RMS norm of one row of K values fused with its per-row DRQ (one warp):
//   var = mean(x^2), xn = (x * (1 / sqrt(var + eps))) * gamma,
//   xs  = max(absmax(xn), 1e-9) * (1/127), xq = rint(xn * (1 / xs)).
// The sum of squares is taken in f64 (each square is exact there) and
// rounded to f32 once, which makes a difference between orders of the sum
// very unlikely, though not impossible: the plain PyTorch versions
// (ops/impl.py RMS_NORM, kernels/block.py) sum in f64 in another order
// and, in every check so far, get the same f32.
// x may have been written earlier in the same launch (plain loads only).
template <typename T>
__device__ void rmsnorm_quant_row(const T* x, const float* gamma, int K,
                                  float eps, int8_t* xq, float* xs,
                                  int lane) {
  double ss = 0.0;
  for (int k = lane; k < K; k += 32) {
    const double v = (double)load_f(x, k);
    ss += v * v;
  }
  ss = warp_sum_double(ss);
  const float var = (float)(ss / (double)K);
  const float r = 1.0f / sqrtf(var + eps);
  float amax = 0.0f;
  for (int k = lane; k < K; k += 32)
    amax = fmaxf(amax, fabsf((load_f(x, k) * r) * gamma[k]));
  amax = warp_max(amax);
  const float s = fmaxf(amax, 1e-9f) * kInv127;
  const float inv = 1.0f / s;
  for (int k = lane; k < K; k += 32)
    xq[k] = (int8_t)__float2int_rn(((load_f(x, k) * r) * gamma[k]) * inv);
  if (lane == 0) *xs = s;
}

// Per-row DRQ of rows [m0, m0 + bm) of x [M, K] into shared memory:
// xq [bm][K] int8 and xs [bm] f32. One warp per row. Rows past M are 0.
template <typename T>
__device__ void quantize_rows(const T* __restrict__ x, int M, int K, int m0,
                              int bm, int8_t* xq, float* xs) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int r = warp; r < bm; r += nwarps) {
    int8_t* dst = xq + (size_t)r * K;
    const int m = m0 + r;
    if (m >= M) {
      for (int k = lane; k < K; k += 32) dst[k] = 0;
      if (lane == 0) xs[r] = 0.0f;
      continue;
    }
    const T* src = x + (size_t)m * K;
    float amax = 0.0f;
    for (int k = lane; k < K; k += 32) amax = fmaxf(amax, fabsf(load_f(src, k)));
    amax = warp_max(amax);
    const float s = fmaxf(amax, 1e-9f) * kInv127;
    const float inv = 1.0f / s;
    for (int k = lane; k < K; k += 32)
      dst[k] = (int8_t)__float2int_rn(load_f(src, k) * inv);
    if (lane == 0) xs[r] = s;
  }
}

// Sign-extended int4 nibbles of a packed word as four int8 lanes:
// ((v ^ 8) - 8) per byte, the Pallas kernels' unpack.
__device__ __forceinline__ int nib_lo(uint32_t w) {
  return (int)__vsub4((w & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}
__device__ __forceinline__ int nib_hi(uint32_t w) {
  return (int)__vsub4(((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

// One warp: acc[r] += sum_j unpack(wrow[j]) . xq[r] over a split-half packed
// row of k2 bytes. Byte j holds column j (low nibble, paired with xlo[j])
// and column k2 + j (high nibble, paired with xhi[j]). Lanes take 16-byte
// chunks, so a warp reads 512 contiguous bytes per step. Partial sums per
// lane; the caller reduces across the warp. k2 % 16 == 0; xlo, xhi and
// the row stride ld are 16-byte aligned.
template <int BM>
__device__ __forceinline__ void dot_packed(const uint8_t* __restrict__ wrow,
                                           int k2, const int8_t* xlo,
                                           const int8_t* xhi, int ld,
                                           int lane, int (&acc)[BM]) {
  for (int j = lane * 16; j < k2; j += 512) {
    const uint4 wv = __ldg(reinterpret_cast<const uint4*>(wrow + j));
    const int lo[4] = {nib_lo(wv.x), nib_lo(wv.y), nib_lo(wv.z), nib_lo(wv.w)};
    const int hi[4] = {nib_hi(wv.x), nib_hi(wv.y), nib_hi(wv.z), nib_hi(wv.w)};
#pragma unroll
    for (int r = 0; r < BM; ++r) {
      const int4 xl = *reinterpret_cast<const int4*>(xlo + (size_t)r * ld + j);
      const int4 xh = *reinterpret_cast<const int4*>(xhi + (size_t)r * ld + j);
      int a = acc[r];
      a = __dp4a(lo[0], xl.x, a);
      a = __dp4a(lo[1], xl.y, a);
      a = __dp4a(lo[2], xl.z, a);
      a = __dp4a(lo[3], xl.w, a);
      a = __dp4a(hi[0], xh.x, a);
      a = __dp4a(hi[1], xh.y, a);
      a = __dp4a(hi[2], xh.z, a);
      a = __dp4a(hi[3], xh.w, a);
      acc[r] = a;
    }
  }
}

// One warp: acc[r] += wrow . xq[r] over an int8 row of k bytes (k % 16 == 0).
template <int BM>
__device__ __forceinline__ void dot_int8(const int8_t* __restrict__ wrow,
                                         int k, const int8_t* xq, int ld,
                                         int lane, int (&acc)[BM]) {
  for (int j = lane * 16; j < k; j += 512) {
    const int4 wv = __ldg(reinterpret_cast<const int4*>(wrow + j));
#pragma unroll
    for (int r = 0; r < BM; ++r) {
      const int4 xv = *reinterpret_cast<const int4*>(xq + (size_t)r * ld + j);
      int a = acc[r];
      a = __dp4a(wv.x, xv.x, a);
      a = __dp4a(wv.y, xv.y, a);
      a = __dp4a(wv.z, xv.z, a);
      a = __dp4a(wv.w, xv.w, a);
      acc[r] = a;
    }
  }
}

template <int BM>
__device__ __forceinline__ void warp_reduce_rows(int (&acc)[BM]) {
#pragma unroll
  for (int r = 0; r < BM; ++r) acc[r] = warp_sum_int(acc[r]);
}

// Lane r's own row out of a warp-uniform array (static register indices).
template <int BM>
__device__ __forceinline__ int pick_row(const int (&acc)[BM], int lane) {
  int v = 0;
#pragma unroll
  for (int r = 0; r < BM; ++r)
    if (lane == r) v = acc[r];
  return v;
}

}  // namespace aeqt
