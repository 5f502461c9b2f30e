// The stale-cache decode attention's kernels and launches (#2,
// attention_stale.cu, whose header gives their arithmetic and design),
// shared with the fused decode block (#5, fused_block.cu), which hands its
// rotated queries and new rows to the same launch.
#pragma once

#include "attention_common.cuh"
#include "attention_split_tc.cuh"

namespace aeqt {
namespace stale {

using aeqt::split::Args;
using aeqt::split::Kernel;
constexpr int kThreads = aeqt::kAttnThreads;

template <int C, int H, int NTS>
__global__ void __launch_bounds__(aeqt::split::kThreads, 2)
stale_attention_split_kernel(const Args a) {
  aeqt::split::attend<aeqt::split::kStale, C, H, NTS>(a);
}

template <int C>
inline Kernel kernel_for(int H, int G) {
  const bool two = G > 8;  // query rows in two n-tiles
  switch (H) {
    case 64:
      return two ? &stale_attention_split_kernel<C, 64, 2>
                 : &stale_attention_split_kernel<C, 64, 1>;
    case 128:
      return two ? &stale_attention_split_kernel<C, 128, 2>
                 : &stale_attention_split_kernel<C, 128, 1>;
    case 256:
      return two ? &stale_attention_split_kernel<C, 256, 2>
                 : &stale_attention_split_kernel<C, 256, 1>;
  }
  return nullptr;
}

// The split kernel of a compute mode and shape; nullptr for a shape the
// core does not take (the one-block kernel's).
inline Kernel kernel_for(int compute, int R, int G, int S, int H) {
  if (!aeqt::split::takes(aeqt::split::kStale, compute, R, G, S, H))
    return nullptr;
  switch (compute) {
    case aeqt::kF32: return kernel_for<aeqt::kF32>(H, G);
    case aeqt::kBF16: return kernel_for<aeqt::kBF16>(H, G);
    case aeqt::kInt8: return kernel_for<aeqt::kInt8>(H, G);
  }
  return nullptr;
}

inline aeqt::split::Plan plan_of(Kernel kernel, int compute, int R, int G,
                                 int S, int H) {
  return aeqt::split::choose_plan(
      kernel, aeqt::split::Int8Smem{aeqt::split::kStale, compute, G, H}, S,
      R);
}

template <int C, typename TOut>
__global__ void __launch_bounds__(kThreads)
stale_attention_kernel(const float* __restrict__ q,
                       const int8_t* __restrict__ k,
                       const int8_t* __restrict__ v,
                       const int8_t* __restrict__ k_new,
                       const int8_t* __restrict__ v_new,
                       const int* __restrict__ lengths,
                       TOut* __restrict__ out, int NK, int G, int S, int H,
                       float k_scale_eff, float v_scale, float zp_k,
                       float zp_v) {
  extern __shared__ __align__(16) float sm[];
  const int row = blockIdx.x;
  const int b = row / NK;
  const int L = min(max(lengths[b] - 1, 0), S);
  const float* qr = q + (size_t)row * G * H;
  for (int i = threadIdx.x; i < G * H; i += blockDim.x) sm[i] = qr[i];
  __syncthreads();
  aeqt::stale_attention_row<C>(sm, G, S, H, L, k + (size_t)row * S * H,
                            v + (size_t)row * S * H, k_new + (size_t)row * H,
                            v_new + (size_t)row * H, out + (size_t)row * G * H,
                            k_scale_eff, v_scale, zp_k, zp_v);
}

template <int C, typename TOut>
int launch(const void* q, const void* k, const void* v, const void* k_new,
           const void* v_new, const void* lengths, void* out, int R, int NK,
           int G, int S, int H, float k_scale_eff, float v_scale, float zp_k,
           float zp_v, cudaStream_t stream) {
  const size_t smem = aeqt::stale_smem_floats(G, S, H) * sizeof(float);
  if (!aeqt::head_dim_fits(H) || !aeqt::compute_fits(C, G, H) ||
      !aeqt::smem_fits(smem))
    return aeqt::kShapeRefused;
  auto* kernel = stale_attention_kernel<C, TOut>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<R, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), static_cast<const int8_t*>(k_new),
      static_cast<const int8_t*>(v_new), static_cast<const int*>(lengths),
      static_cast<TOut*>(out), NK, G, S, H, k_scale_eff, v_scale, zp_k, zp_v);
  return (int)cudaGetLastError();
}

template <typename TOut>
int launch_mode(int compute, const void* q, const void* k, const void* v,
                const void* k_new, const void* v_new, const void* lengths,
                void* out, int R, int NK, int G, int S, int H,
                float k_scale_eff, float v_scale, float zp_k, float zp_v,
                cudaStream_t s) {
  return aeqt::with_compute(compute, [&](auto mode) {
    return launch<decltype(mode)::value, TOut>(q, k, v, k_new, v_new, lengths,
                                               out, R, NK, G, S, H,
                                               k_scale_eff, v_scale, zp_k,
                                               zp_v, s);
  });
}


// The launch of a call (aeqt_attention_stale's arguments): the split core
// where it takes the shape, else the one-block kernel.
inline int run(const void* q, const void* k, const void* v,
               const void* k_new, const void* v_new, const void* lengths,
               void* out, int out_bf16, int compute, int R, int NK, int G,
               int S, int H, float k_scale_eff, float v_scale, float zp_k,
               float zp_v, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Kernel kernel = kernel_for(compute, R, G, S, H);
  if (kernel == nullptr) {
    if (out_bf16)
      return launch_mode<__nv_bfloat16>(compute, q, k, v, k_new, v_new,
                                        lengths, out, R, NK, G, S, H,
                                        k_scale_eff, v_scale, zp_k, zp_v, s);
    return launch_mode<float>(compute, q, k, v, k_new, v_new, lengths, out,
                              R, NK, G, S, H, k_scale_eff, v_scale, zp_k,
                              zp_v, s);
  }
  Args a = {};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const int8_t*>(k);
  a.v = static_cast<const int8_t*>(v);
  a.k_new = static_cast<const int8_t*>(k_new);
  a.v_new = static_cast<const int8_t*>(v_new);
  a.out = out;
  a.out_bf16 = out_bf16;
  a.lengths = static_cast<const int*>(lengths);
  a.NK = NK;
  a.G = G;
  a.S = S;
  a.ks = k_scale_eff;
  a.v_scale = v_scale;
  a.zp_k = zp_k;
  a.zp_v = zp_v;
  return aeqt::split::launch(kernel, a, plan_of(kernel, compute, R, G, S, H),
                             R, s);
}


// The launch of a shape (chip_smoke.SPLIT_PLAN_FIELDS: cluster size, rows,
// cache rows a CTA, threads, shared memory); a shape on the one-block
// kernel gives cluster 0, R blocks of all S rows and its shared memory.
inline int plan(int R, int G, int S, int H, int compute, long long* fields) {
  const Kernel kernel = kernel_for(compute, R, G, S, H);
  if (kernel != nullptr) {
    aeqt::split::plan_fields(plan_of(kernel, compute, R, G, S, H), R, fields);
    return 0;
  }
  const size_t smem = aeqt::stale_smem_floats(G, S, H) * sizeof(float);
  if (compute < aeqt::kF32 || compute > aeqt::kInt8 ||
      !aeqt::head_dim_fits(H) || !aeqt::compute_fits(compute, G, H) ||
      !aeqt::smem_fits(smem))
    return aeqt::kShapeRefused;
  fields[0] = 0;
  fields[1] = R;
  fields[2] = S;
  fields[3] = aeqt::kAttnThreads;
  fields[4] = (long long)smem;
  return 0;
}

}  // namespace stale
}  // namespace aeqt
