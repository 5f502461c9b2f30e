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
// Design (simple first), on the tiles of qmatmul_int4_weight_only.cuh:
//   * bf16 x: mma.sync m16n8k16 bf16 with f32 sums, one warp per 16 x 64
//     tile of y, chunks of 64 packed bytes a weight row (the .cuh's k-index
//     map and nibble-to-bf16 trick). A block's bs/64 chunks sum into two
//     f32 fragments (low and high nibbles); at the block's end they are
//     scaled by the block's two scale columns and added into y. Where the
//     tiles give few warps (decode rows at N 2048), the byte blocks are
//     split over the grid, one block a warp, each block's scaled partial
//     written to scratch; a second launch adds them in block order (0 + a
//     is a, so the sum is the one-pass sum bit for bit), then the bias.
//   * f32 x: SIMT f32, a 128-thread block computes a 32 x 64 tile over
//     steps of 32 packed bytes (the .cuh's weight-only SIMT kernel with a
//     block epilogue every bs/32 steps).
#include "qmatmul_int4_weight_only.cuh"

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

// bf16 x: tensor cores. One warp's 16 x 64 tile over the byte blocks
// [jb_begin, jb_end); y = sum of the blocks' scaled partials in block order
// (+ bias) into out, or, with splits > 1, the warp's one block's scaled
// partial into part [splits][M][N] (blockIdx.z its block).
template <typename TOut>
__global__ void __launch_bounds__(kMmaWarps * 32)
blockwise_mma_kernel(const __nv_bfloat16* __restrict__ x,
                     const uint8_t* __restrict__ w,
                     const float* __restrict__ scale,
                     const float* __restrict__ bias, TOut* __restrict__ out,
                     float* __restrict__ part, int M, int N, int K, int bs) {
  const int n0 = (blockIdx.y * kMmaWarps + (threadIdx.x >> 5)) * kMmaBN;
  if (n0 >= N) return;  // warp-uniform; no block-wide barrier below
  const int m0 = blockIdx.x * kMmaBM;
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int K2 = K / 2, nb = K / bs, nb2 = nb / 2;
  const int splits = gridDim.z;
  const int jb_begin = splits > 1 ? blockIdx.z : 0;
  const int jb_end = splits > 1 ? jb_begin + 1 : nb2;

  float y[kMmaNT][4];
#pragma unroll
  for (int nt = 0; nt < kMmaNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) y[nt][e] = 0.0f;
  for (int jb = jb_begin; jb < jb_end; ++jb) {
    float lo[kMmaNT][4] = {}, hi[kMmaNT][4] = {};
    for (int j = jb * bs; j < (jb + 1) * bs; j += kMmaChunk) {
      uint32_t xl0[8], xl1[8], xh0[8], xh1[8];
      load_x16(x, m0 + gid, M, K, j + 16 * tig, xl0);
      load_x16(x, m0 + gid + 8, M, K, j + 16 * tig, xl1);
      load_x16(x, m0 + gid, M, K, K2 + j + 16 * tig, xh0);
      load_x16(x, m0 + gid + 8, M, K, K2 + j + 16 * tig, xh1);
      uint4 wv[kMmaNT];
#pragma unroll
      for (int nt = 0; nt < kMmaNT; ++nt) {
        const int n = n0 + 8 * nt + gid;
        wv[nt] = n < N ? __ldg(reinterpret_cast<const uint4*>(
                             w + (size_t)n * K2 + j + 16 * tig))
                       : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        uint32_t al[4], ah[4];
        a_frag(xl0, xl1, s, al);
        a_frag(xh0, xh1, s, ah);
#pragma unroll
        for (int nt = 0; nt < kMmaNT; ++nt) {
          const uint32_t word = s == 0 ? wv[nt].x : s == 1 ? wv[nt].y
                              : s == 2 ? wv[nt].z : wv[nt].w;
          const uint32_t v = word ^ 0x88888888u;
          mma_bf16(lo[nt], al, nibbles_bf16x2(v), nibbles_bf16x2(v >> 8));
          mma_bf16(hi[nt], ah, nibbles_bf16x2(v >> 4),
                   nibbles_bf16x2(v >> 12));
        }
      }
    }
    // The block's epilogue: y += p_lo * s[:, jb] + p_hi * s[:, nb/2 + jb].
#pragma unroll
    for (int nt = 0; nt < kMmaNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = min(n0 + 8 * nt + 2 * tig + (e & 1), N - 1);
        const float slo = scale[(size_t)n * nb + jb];
        const float shi = scale[(size_t)n * nb + nb2 + jb];
        const float acc = lo[nt][e] * slo + hi[nt][e] * shi;
        y[nt][e] = y[nt][e] + acc;
      }
  }
#pragma unroll
  for (int nt = 0; nt < kMmaNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m0 + gid + 8 * (e >> 1);
      const int n = n0 + 8 * nt + 2 * tig + (e & 1);
      if (m >= M || n >= N) continue;
      if (splits > 1) {
        part[((size_t)blockIdx.z * M + m) * N + n] = y[nt][e];
      } else {
        float v = y[nt][e];
        if (bias != nullptr) v = v + bias[n];
        store_f(out, (size_t)m * N + n, v);
      }
    }
}

// out = (sum over byte blocks t in order of part[t]) (+ bias).
template <typename TOut>
__global__ void __launch_bounds__(256)
blocks_sum_kernel(const float* __restrict__ part,
                  const float* __restrict__ bias, TOut* __restrict__ out,
                  int M, int N, int splits) {
  const size_t mn = (size_t)M * N;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < mn;
       i += (size_t)gridDim.x * blockDim.x) {
    float acc = 0.0f;
    for (int t = 0; t < splits; ++t) acc = acc + part[t * mn + i];
    if (bias != nullptr) acc = acc + bias[(int)(i % N)];
    store_f(out, i, acc);
  }
}

// The number of byte blocks the bf16 kernel splits over the grid (1: none).
int blockwise_splits(int M, int N, int K, int bs) {
  const int warps = ((M + kMmaBM - 1) / kMmaBM) * ((N + kMmaBN - 1) / kMmaBN);
  const int nb2 = K / bs / 2;
  return (nb2 > 1 && warps < kMmaSplitBelow) ? nb2 : 1;
}

// N % 64 == 0 (whole tiles), bs % 128 == 0 (whole chunks of 64 bytes and
// steps of 32 in a block), K/bs even and K/2 % bs == 0 (the split-half
// layout pairs byte block jb with K-blocks jb and nb/2 + jb).
bool blockwise_shape_ok(int M, int N, int K, int bs) {
  return M > 0 && N > 0 && K > 0 && bs > 0 && N % kWpBN == 0 &&
         bs % 128 == 0 && K % (2 * bs) == 0;
}

}  // namespace

// f32 floats of scratch the bf16 kernel needs for a shape (0: none).
extern "C" long long aeqt_qmatmul_int4_blockwise_scratch(int M, int N, int K,
                                                         int bs) {
  if (!blockwise_shape_ok(M, N, K, bs)) return 0;
  const int splits = blockwise_splits(M, N, K, bs);
  return splits > 1 ? (long long)splits * M * N : 0;
}

// x [M, K] bf16 (x_bf16) or f32; w [N, K/2] uint8 split-half packed, rows
// 16-byte aligned; scale [N, K/bs] f32; bias [N] f32 or null; out [M, N]
// in x's dtype; part: aeqt_qmatmul_int4_blockwise_scratch floats (bf16 x
// only; null when that is 0). Refuses (kShapeRefused) unless N % 64 == 0,
// bs % 128 == 0 and K % (2 * bs) == 0.
extern "C" int aeqt_qmatmul_int4_blockwise(const void* x, int x_bf16,
                                           const void* w, const void* scale,
                                           const void* bias, void* out,
                                           void* part, int M, int N, int K,
                                           int bs, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!blockwise_shape_ok(M, N, K, bs)) return kShapeRefused;
  const float* sc = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  const uint8_t* wp = static_cast<const uint8_t*>(w);
  if (!x_bf16) {
    const dim3 grid(N / kWpBN, (M + kWpBM - 1) / kWpBM);
    blockwise_simt_kernel<float><<<grid, kWpThreads, 0, s>>>(
        static_cast<const float*>(x), wp, sc, b, static_cast<float*>(out), M,
        N, K, bs);
    return (int)cudaGetLastError();
  }
  const int splits = blockwise_splits(M, N, K, bs);
  if (splits > 1 && part == nullptr) return kShapeRefused;
  using bf16 = __nv_bfloat16;
  const dim3 grid((M + kMmaBM - 1) / kMmaBM,
                  (N / kMmaBN + kMmaWarps - 1) / kMmaWarps, splits);
  blockwise_mma_kernel<bf16><<<grid, kMmaWarps * 32, 0, s>>>(
      static_cast<const bf16*>(x), wp, sc, b, static_cast<bf16*>(out),
      static_cast<float*>(part), M, N, K, bs);
  int err = (int)cudaGetLastError();
  if (err != 0 || splits == 1) return err;
  const size_t mn = (size_t)M * N;
  const int blocks = (int)std::min<size_t>((mn + 255) / 256, 65536);
  blocks_sum_kernel<bf16><<<blocks, 256, 0, s>>>(
      static_cast<const float*>(part), b, static_cast<bf16*>(out), M, N,
      splits);
  return (int)cudaGetLastError();
}
