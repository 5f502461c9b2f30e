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

// v rounded to the type of p's elements (f32: v itself).
__device__ __forceinline__ float round_to(const float*, float v) { return v; }
__device__ __forceinline__ float round_to(const __nv_bfloat16*, float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
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

// Sign-extended int4 nibbles of a packed word as four int8 lanes:
// ((v ^ 8) - 8) per byte, the Pallas kernels' unpack.
__device__ __forceinline__ int nib_lo(uint32_t w) {
  return (int)__vsub4((w & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}
__device__ __forceinline__ int nib_hi(uint32_t w) {
  return (int)__vsub4(((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

}  // namespace aeqt
