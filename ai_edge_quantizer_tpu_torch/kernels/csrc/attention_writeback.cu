// Lengths-masked decode attention over an int8 KV cache whose row `pos` is
// replaced by the new token's K/V rows, which it also writes into the
// caches, in the f32, bf16 or int8 compute mode.
//
// Replaces: ai_edge_quantizer_tpu/kernels/pallas_attention.py
//   decode_attention_int8_lengths_writeback (_ctx_prefix_len over the
//   spliced cache, its three compute branches; the modes' operands are at
//   the top of attention_common.cuh). The JAX executor runs it for each
//   decode attention whose cache row write it folds in, under
//   AEQT_ATTN_WRITEBACK_MODE=splice with AEQT_ATTN_LENGTHS=1 (18 a step for
//   Gemma-2B). For each (batch, kv-head) row r with L = lengths[b] live
//   rows and p = clip(pos, 0, S - 1):
//     k'[j] = k_new if j == p else k[j]   (v' likewise)
//     s[g, j] = (q[g] . k'[j] - zp_k * sum(q[g])) * k_scale_eff, j < L
//     ctx[g]  = (sum_j softmax(s)[g, j] v'[j] - zp_v) * v_scale
//   and k[p] = k_new, v[p] = v_new are written into the caches, whose
//   storage is the output (the TPU kernel aliases its cache outputs to its
//   inputs), for every row, also one whose length does not reach p. With
//   L == 0 every score is -1e30 and each of the S rows gets weight 1/S, the
//   spliced row among them (in int8 each of the S codes is rint(127 / S):
//   1 at S 128, so all S rows are summed; 0 from S 256 on, so p_sum is 1
//   and ctx is -zp_v * v_scale).
//
// Bound on the H100: the cache bytes of the live rows, 2 * L * H a row,
//   plus the two new rows read and written (at the bench shape, B 256, H
//   256, 897 live rows: 117.6 MB, 35 us).
//
// Design: attention_split_tc.cuh, the splice form (`attend<kSplice, C>`):
//   the lengths form (#7) with row p substituted in shared memory, never
//   in the cache. The CTA whose slice holds p waits for the bulk copy of
//   the chunk holding it (its mbarrier), overwrites that row of the ring
//   stage with k_new's H bytes (V: v_new's), fences the generic writes
//   against the stage's next bulk copy (fence.proxy.async) and only then,
//   after a __syncthreads, lets the chunk be read: before the chained f32
//   mode's pad_rows, before score_chunk / context_* in the others. K is
//   substituted where p < kr, V where p < vr (a zero-length row reads every
//   V row: V always), so row p feeds the score dot, the probability operand
//   and the int8 code sum in every mode. The same CTA writes the two
//   global rows at its end, after gather_partials: every bulk copy of its
//   slice has landed by then, and no other CTA reads row p of its row. The
//   TPU kernel writes back the whole 32-row tile around p (HBM writes must
//   cover full tiles); here only the two rows move. The wrapper and this
//   entry point keep the TPU gate S % 32 == 0 so that the routes agree.
//
// Shapes the core does not take (H other than 64, 128 or 256, G > 16,
//   R > 65535, or a slice's scores past shared memory) go, by that fixed
//   rule, to the one-block kernel below: the lengths kernel of
//   attention_common.cuh with the row pointer chosen per cache row (row p
//   read from k_new / v_new, never from the cache), its own write of row p
//   after its last read, at the end.
#include "attention_common.cuh"
#include "attention_split_tc.cuh"

namespace {

using aeqt::kGC;
using aeqt::split::Args;
using aeqt::split::Kernel;
constexpr int kThreads = aeqt::kAttnThreads;

template <int C, int H, int NTS>
__global__ void __launch_bounds__(aeqt::split::kThreads, 2)
splice_attention_split_kernel(const Args a) {
  aeqt::split::attend<aeqt::split::kSplice, C, H, NTS>(a);
}

template <int C>
Kernel kernel_for(int H, int G) {
  const bool two = G > 8;  // query rows in two n-tiles
  switch (H) {
    case 64:
      return two ? &splice_attention_split_kernel<C, 64, 2>
                 : &splice_attention_split_kernel<C, 64, 1>;
    case 128:
      return two ? &splice_attention_split_kernel<C, 128, 2>
                 : &splice_attention_split_kernel<C, 128, 1>;
    case 256:
      return two ? &splice_attention_split_kernel<C, 256, 2>
                 : &splice_attention_split_kernel<C, 256, 1>;
  }
  return nullptr;
}

// The split kernel of a compute mode and shape; nullptr for a shape the
// core does not take (the one-block kernel's).
Kernel kernel_for(int compute, int R, int G, int S, int H) {
  if (!aeqt::split::takes(aeqt::split::kSplice, compute, R, G, S, H))
    return nullptr;
  switch (compute) {
    case aeqt::kF32: return kernel_for<aeqt::kF32>(H, G);
    case aeqt::kBF16: return kernel_for<aeqt::kBF16>(H, G);
    case aeqt::kInt8: return kernel_for<aeqt::kInt8>(H, G);
  }
  return nullptr;
}

aeqt::split::Plan plan_of(Kernel kernel, int compute, int R, int G, int S,
                          int H) {
  return aeqt::split::choose_plan(
      kernel, aeqt::split::Int8Smem{aeqt::split::kSplice, compute, G, H}, S,
      R);
}

template <int C, typename TOut>
__global__ void __launch_bounds__(kThreads)
writeback_attention_kernel(const float* __restrict__ q, int8_t* k, int8_t* v,
                           const int8_t* __restrict__ k_new,
                           const int8_t* __restrict__ v_new,
                           const int* __restrict__ lengths,
                           const int* __restrict__ pos_ptr,
                           TOut* __restrict__ out, int NK, int G, int S,
                           int H, float k_scale_eff, float v_scale,
                           float zp_k, float zp_v) {
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
  const int p = min(max(*pos_ptr, 0), S - 1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  int8_t* kr = k + (size_t)row * S * H;
  int8_t* vr = v + (size_t)row * S * H;
  const int8_t* knr = k_new + (size_t)row * H;
  const int8_t* vnr = v_new + (size_t)row * H;

  const float* qr = q + (size_t)row * G * H;
  for (int i = threadIdx.x; i < G * H; i += blockDim.x) qs[i] = qr[i];
  __syncthreads();

  aeqt::prepare_queries<C>(qs, qsum, red, G, H);
  __syncthreads();

  // Scores: one thread per live cache row, row p from k_new.
  for (int j = threadIdx.x; j < L; j += blockDim.x) {
    const int8_t* krow = j == p ? knr : kr + (size_t)j * H;
    for (int g0 = 0; g0 < G; g0 += kGC) {
      float s[kGC];
      if (!none)
        aeqt::score_rows<C>(qs, qsum, red, G, H, g0, krow, zp_k, k_scale_eff,
                            s);
#pragma unroll
      for (int i = 0; i < kGC; ++i)
        if (g0 + i < G)
          sc[(size_t)(g0 + i) * S + j] = none ? aeqt::kNegInf : s[i];
    }
  }
  __syncthreads();

  for (int g = warp; g < G; g += nwarps) {
    const float codes =
        aeqt::softmax_row<C>(sc + (size_t)g * S, L, aeqt::kNegInf, lane);
    if constexpr (C == aeqt::kInt8)
      if (lane == 0) qsum[g] = fmaxf(codes, 1.0f);
  }
  __syncthreads();

  aeqt::context_phase<C>(sc, qsum, red, G, S, H, L, vr, vnr, p,
                         out + (size_t)row * G * H, zp_v, v_scale);

  // The row write, after every read of this row's caches (none of which
  // reads row p).
  for (int i = threadIdx.x; i < H; i += blockDim.x) {
    kr[(size_t)p * H + i] = knr[i];
    vr[(size_t)p * H + i] = vnr[i];
  }
}

template <int C, typename TOut>
int launch(const void* q, void* k, void* v, const void* k_new,
           const void* v_new, const void* lengths, const void* pos, void* out,
           int R, int NK, int G, int S, int H, float k_scale_eff,
           float v_scale, float zp_k, float zp_v, cudaStream_t stream) {
  const size_t smem = aeqt::scores_smem_floats(G, S, H) * sizeof(float);
  if (!aeqt::head_dim_fits(H) || S % 32 != 0 ||
      !aeqt::compute_fits(C, G, H) || !aeqt::smem_fits(smem))
    return aeqt::kShapeRefused;
  auto* kernel = writeback_attention_kernel<C, TOut>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<R, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<int8_t*>(k),
      static_cast<int8_t*>(v), static_cast<const int8_t*>(k_new),
      static_cast<const int8_t*>(v_new), static_cast<const int*>(lengths),
      static_cast<const int*>(pos), static_cast<TOut*>(out), NK, G, S, H,
      k_scale_eff, v_scale, zp_k, zp_v);
  return (int)cudaGetLastError();
}

template <typename TOut>
int launch_mode(int compute, const void* q, void* k, void* v,
                const void* k_new, const void* v_new, const void* lengths,
                const void* pos, void* out, int R, int NK, int G, int S,
                int H, float k_scale_eff, float v_scale, float zp_k,
                float zp_v, cudaStream_t s) {
  return aeqt::with_compute(compute, [&](auto mode) {
    return launch<decltype(mode)::value, TOut>(q, k, v, k_new, v_new,
                                               lengths, pos, out, R, NK, G,
                                               S, H, k_scale_eff, v_scale,
                                               zp_k, zp_v, s);
  });
}

}  // namespace

// q f32 [R, G, H] with R = B * NK; k, v int8 [R, S, H] (written at row
// clip(*pos, 0, S - 1)); k_new, v_new int8 [R, H]; lengths int32 [B]; pos
// int32 [1] on the device; out [R, G, H] f32 or bf16 (out_bf16); compute
// aeqt::kF32, kBF16 or kInt8. The split core where it takes the shape, else
// the one-block kernel; returns aeqt::kShapeRefused (nothing launched)
// unless S % 32 == 0 and, on the one-block kernel, H % 16 == 0,
// 1024 % H == 0, the G x S scores fit in shared memory and (int8)
// G * H / 4 + G <= aeqt::kRedFloats.
extern "C" int aeqt_attention_writeback(const void* q, void* k, void* v,
                                        const void* k_new, const void* v_new,
                                        const void* lengths, const void* pos,
                                        void* out, int out_bf16, int compute,
                                        int R, int NK, int G, int S, int H,
                                        float k_scale_eff, float v_scale,
                                        float zp_k, float zp_v,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S % 32 != 0) return aeqt::kShapeRefused;
  const Kernel kernel = kernel_for(compute, R, G, S, H);
  if (kernel == nullptr) {
    if (out_bf16)
      return launch_mode<__nv_bfloat16>(compute, q, k, v, k_new, v_new,
                                        lengths, pos, out, R, NK, G, S, H,
                                        k_scale_eff, v_scale, zp_k, zp_v, s);
    return launch_mode<float>(compute, q, k, v, k_new, v_new, lengths, pos,
                              out, R, NK, G, S, H, k_scale_eff, v_scale, zp_k,
                              zp_v, s);
  }
  Args a = {};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const int8_t*>(k);
  a.v = static_cast<const int8_t*>(v);
  a.k_new = static_cast<const int8_t*>(k_new);
  a.v_new = static_cast<const int8_t*>(v_new);
  a.pos = static_cast<const int*>(pos);
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
extern "C" int aeqt_attention_writeback_plan(int R, int G, int S, int H,
                                             int compute, long long* fields) {
  if (S % 32 != 0) return aeqt::kShapeRefused;
  const Kernel kernel = kernel_for(compute, R, G, S, H);
  if (kernel != nullptr) {
    aeqt::split::plan_fields(plan_of(kernel, compute, R, G, S, H), R, fields);
    return 0;
  }
  const size_t smem = aeqt::scores_smem_floats(G, S, H) * sizeof(float);
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
