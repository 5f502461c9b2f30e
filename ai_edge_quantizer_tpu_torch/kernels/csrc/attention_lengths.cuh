// The lengths-masked int8 decode attention of attention_lengths.cu (#7):
// its launch, the split core's lengths form (attention_split_tc.cuh) where
// the core takes the shape and else, by that fixed rule, the one-block
// kernel below (a template over the compute mode and the output type).
// Shared with attention_oproj.cu (#19: the attention of the out-projection
// epilogue, in its mode) and attention_int8_basic.cu (#22: f32, zero
// points 0). Its contract and design note are in attention_lengths.cu.
#pragma once

#include "attention_common.cuh"
#include "attention_split_tc.cuh"

namespace aeqt {

template <int C, typename TOut>
__global__ void __launch_bounds__(kAttnThreads)
lengths_attention_kernel(const float* __restrict__ q,
                         const int8_t* __restrict__ k,
                         const int8_t* __restrict__ v,
                         const int* __restrict__ lengths,
                         TOut* __restrict__ out, int NK, int G, int S, int H,
                         float k_scale_eff, float v_scale, float zp_k,
                         float zp_v) {
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;                          // [G][H]
  float* sc = qs + (size_t)G * H;          // [G][S] scores, then probs
  float* qsum = sc + (size_t)G * S;        // [G] sum(q), then p_sum (int8)
  float* red = qsum + G;                   // [RG][kGC][H] context partials
  const int row = blockIdx.x;
  const int b = row / NK;
  const int len = lengths[b];
  const bool none = len <= 0;  // every TPU score is -1e30
  const int L = none ? S : min(len, S);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;

  const float* qr = q + (size_t)row * G * H;
  for (int i = threadIdx.x; i < G * H; i += blockDim.x) qs[i] = qr[i];
  __syncthreads();

  prepare_queries<C>(qs, qsum, red, G, H);
  __syncthreads();

  // Scores: one thread per live cache row.
  const int8_t* kr = k + (size_t)row * S * H;
  for (int j = threadIdx.x; j < L; j += blockDim.x) {
    const int8_t* krow = kr + (size_t)j * H;
    for (int g0 = 0; g0 < G; g0 += kGC) {
      float s[kGC];
      if (!none)
        score_rows<C>(qs, qsum, red, G, H, g0, krow, zp_k, k_scale_eff, s);
#pragma unroll
      for (int i = 0; i < kGC; ++i)
        if (g0 + i < G) sc[(size_t)(g0 + i) * S + j] = none ? kNegInf : s[i];
    }
  }
  __syncthreads();

  // Softmax over the L live scores: one warp per query row.
  for (int g = warp; g < G; g += nwarps) {
    const float codes = softmax_row<C>(sc + (size_t)g * S, L, kNegInf, lane);
    if constexpr (C == kInt8)
      if (lane == 0) qsum[g] = fmaxf(codes, 1.0f);
  }
  __syncthreads();

  context_phase<C>(sc, qsum, red, G, S, H, L, v + (size_t)row * S * H,
                   nullptr, -1, out + (size_t)row * G * H, zp_v, v_scale);
}

template <typename TOut, int C>
int launch_lengths_attention(const void* q, const void* k, const void* v,
                             const void* lengths, void* out, int R, int NK,
                             int G, int S, int H, float k_scale_eff,
                             float v_scale, float zp_k, float zp_v,
                             cudaStream_t stream) {
  const size_t smem = scores_smem_floats(G, S, H) * sizeof(float);
  if (!head_dim_fits(H) || !compute_fits(C, G, H) || !smem_fits(smem))
    return kShapeRefused;
  auto* kernel = lengths_attention_kernel<C, TOut>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<R, kAttnThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), static_cast<const int*>(lengths),
      static_cast<TOut*>(out), NK, G, S, H, k_scale_eff, v_scale, zp_k, zp_v);
  return (int)cudaGetLastError();
}

namespace lengths {

template <int C, int H, int NTS>
__global__ void __launch_bounds__(split::kThreads, 2)
lengths_attention_split_kernel(const split::Args a) {
  split::attend<split::kLengths, C, H, NTS>(a);
}

template <int C>
split::Kernel kernel_for(int H, int G) {
  const bool two = G > 8;  // query rows in two n-tiles
  switch (H) {
    case 64:
      return two ? &lengths_attention_split_kernel<C, 64, 2>
                 : &lengths_attention_split_kernel<C, 64, 1>;
    case 128:
      return two ? &lengths_attention_split_kernel<C, 128, 2>
                 : &lengths_attention_split_kernel<C, 128, 1>;
    case 256:
      return two ? &lengths_attention_split_kernel<C, 256, 2>
                 : &lengths_attention_split_kernel<C, 256, 1>;
  }
  return nullptr;
}

// The split kernel of mode C for a shape; nullptr for a shape the core
// does not take (the one-block kernel's).
template <int C>
split::Kernel split_kernel(int R, int G, int S, int H) {
  if (!split::takes(split::kLengths, C, R, G, S, H)) return nullptr;
  return kernel_for<C>(H, G);
}

template <int C>
split::Plan plan_of(split::Kernel kernel, int R, int G, int S, int H) {
  return split::choose_plan(kernel, split::Int8Smem{split::kLengths, C, G, H},
                            S, R);
}

// Whether the one-block kernel takes a shape of mode C: H % 16 == 0,
// 1024 % H == 0, the G x S scores in shared memory and (int8) G * H / 4 +
// G <= kRedFloats.
template <int C>
bool one_block_takes(int G, int S, int H) {
  return aeqt::head_dim_fits(H) && compute_fits(C, G, H) &&
         smem_fits(scores_smem_floats(G, S, H) * sizeof(float));
}

// Whether mode C takes a shape at all (the split core or the one-block
// kernel).
template <int C>
bool takes(int R, int G, int S, int H) {
  return split_kernel<C>(R, G, S, H) != nullptr ||
         one_block_takes<C>(G, S, H);
}

// q f32 [R, G, H] with R = B * NK; k, v int8 [R, S, H]; lengths int32 [B];
// out [R, G, H] f32 or bf16 (out_bf16). The split core where it takes the
// shape, else the one-block kernel; kShapeRefused (nothing launched) where
// neither does.
template <int C>
int launch(const void* q, const void* k, const void* v, const void* lens,
           void* out, int out_bf16, int R, int NK, int G, int S, int H,
           float k_scale_eff, float v_scale, float zp_k, float zp_v,
           cudaStream_t stream) {
  const split::Kernel kernel = split_kernel<C>(R, G, S, H);
  if (kernel == nullptr) {
    if (out_bf16)
      return launch_lengths_attention<__nv_bfloat16, C>(
          q, k, v, lens, out, R, NK, G, S, H, k_scale_eff, v_scale, zp_k,
          zp_v, stream);
    return launch_lengths_attention<float, C>(q, k, v, lens, out, R, NK, G,
                                              S, H, k_scale_eff, v_scale,
                                              zp_k, zp_v, stream);
  }
  split::Args a = {};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const int8_t*>(k);
  a.v = static_cast<const int8_t*>(v);
  a.out = out;
  a.out_bf16 = out_bf16;
  a.lengths = static_cast<const int*>(lens);
  a.NK = NK;
  a.G = G;
  a.S = S;
  a.ks = k_scale_eff;
  a.v_scale = v_scale;
  a.zp_k = zp_k;
  a.zp_v = zp_v;
  return split::launch(kernel, a, plan_of<C>(kernel, R, G, S, H), R, stream);
}

// The launch of a shape (chip_smoke.SPLIT_PLAN_FIELDS: cluster size, rows,
// cache rows a CTA, threads, shared memory); a shape on the one-block
// kernel gives cluster 0, R blocks of all S rows and its shared memory.
template <int C>
int plan_fields(int R, int G, int S, int H, long long* fields) {
  const split::Kernel kernel = split_kernel<C>(R, G, S, H);
  if (kernel != nullptr) {
    split::plan_fields(plan_of<C>(kernel, R, G, S, H), R, fields);
    return 0;
  }
  if (!one_block_takes<C>(G, S, H)) return kShapeRefused;
  fields[0] = 0;
  fields[1] = R;
  fields[2] = S;
  fields[3] = kAttnThreads;
  fields[4] = (long long)(scores_smem_floats(G, S, H) * sizeof(float));
  return 0;
}

}  // namespace lengths
}  // namespace aeqt
