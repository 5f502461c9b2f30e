// Decode attention over a stale (pre-write) int8 KV cache plus the new
// token's k/v row as one inline softmax column, f32 compute.
//
// Replaces: ai_edge_quantizer_tpu/kernels/pallas_attention.py
//   decode_attention_int8_lengths_stale (_ctx_prefix_len_cur, f32 branch).
//   For each (batch, kv-head) row r with L = lengths[b] - 1 stale rows:
//     s[g, j]  = (q[g] . k[j] - zp_k * sum(q[g])) * k_scale_eff, j < L
//     s_cur[g] = (q[g] . k_new - zp_k * sum(q[g])) * k_scale_eff
//     p = softmax over [s[g, :L], s_cur[g]]
//     ctx[g]   = ((sum_j p[g, j] v[j] + p_cur[g] v_new) - zp_v) * v_scale
//   where k_scale_eff = k_scale / sqrt(H) is formed by the caller. Rows at
//   index >= L are masked in the TPU kernel (exp underflows to exactly 0),
//   so this kernel does not read them at all.
//
// Bound on the H100: the cache bytes of the live rows, 2 * L * H per
//   (batch, kv-head) row over 3.35 TB/s: at Gemma-2B (H = 256, one KV head)
//   with B = 64 and full rows (L = 1023) that is 33.5 MB, about 10 us.
//
// Design (simple first): one block of 256 threads per (batch, kv-head)
//   row; the G query rows (G <= 31 at decode) are staged in shared memory.
//   Scores: one thread per cache row reads its row in 16-byte chunks, four
//   in flight at once, and
//   keeps 8 query rows' dot products in registers; the [G, L] scores live
//   in shared memory. Softmax: one warp per query row (max, exp, sum,
//   divide, as the TPU kernel orders them). Context: each thread takes 4
//   head columns and one of RG = 1024 / H row groups (rows rg, rg + RG,
//   ...), so a warp reads contiguous 128-byte pieces of a V row and four
//   rows of every group are in flight together; the partial sums meet in shared
//   memory and are added in row-group order, so the result does not depend
//   on timing. The new row's column is added last. The body is
//   aeqt::stale_attention_row (attention_common.cuh), which the fused
//   decode block (fused_block.cu) runs too.
#include "attention_common.cuh"

namespace {

constexpr int kThreads = aeqt::kAttnThreads;

template <typename TOut>
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
  aeqt::stale_attention_row(sm, G, S, H, L, k + (size_t)row * S * H,
                            v + (size_t)row * S * H, k_new + (size_t)row * H,
                            v_new + (size_t)row * H, out + (size_t)row * G * H,
                            k_scale_eff, v_scale, zp_k, zp_v);
}

template <typename TOut>
int launch(const void* q, const void* k, const void* v, const void* k_new,
           const void* v_new, const void* lengths, void* out, int R, int NK,
           int G, int S, int H, float k_scale_eff, float v_scale, float zp_k,
           float zp_v, cudaStream_t stream) {
  const size_t smem = aeqt::stale_smem_floats(G, S, H) * sizeof(float);
  if (!aeqt::head_dim_fits(H) || !aeqt::smem_fits(smem))
    return aeqt::kShapeRefused;
  auto* kernel = stale_attention_kernel<TOut>;
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

}  // namespace

// q f32 [R, G, H] with R = B * NK; k, v int8 [R, S, H]; k_new, v_new int8
// [R, H]; lengths int32 [B] (counting the new token); out [R, G, H] f32 or
// bf16 (out_bf16). Returns aeqt::kShapeRefused unless H % 16 == 0,
// 1024 % H == 0 and the G x S scores fit in shared memory.
extern "C" int aeqt_attention_stale(const void* q, const void* k,
                                    const void* v, const void* k_new,
                                    const void* v_new, const void* lengths,
                                    void* out, int out_bf16, int R, int NK,
                                    int G, int S, int H, float k_scale_eff,
                                    float v_scale, float zp_k, float zp_v,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    return launch<__nv_bfloat16>(q, k, v, k_new, v_new, lengths, out, R, NK,
                                 G, S, H, k_scale_eff, v_scale, zp_k, zp_v, s);
  return launch<float>(q, k, v, k_new, v_new, lengths, out, R, NK, G, S, H,
                       k_scale_eff, v_scale, zp_k, zp_v, s);
}
