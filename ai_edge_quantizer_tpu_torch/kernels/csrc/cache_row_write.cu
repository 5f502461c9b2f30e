// One-row DYNAMIC_UPDATE_SLICE written in place: operand[p, pos, :] =
// update[p, 0, :] for every prefix row p (the product of the dims before
// the last two), pos = clip(starts[ndim - 2], 0, S - 1) read on the device.
//
// Replaces: ai_edge_quantizer_tpu/kernels/pallas_cache.py
//   dus_row_inplace_pallas (_dus_kernel). The JAX executor runs it for each
//   int8 KV-cache row write of a decode step under AEQT_CACHE_WRITE_PALLAS=1
//   (36 a step for Gemma-2B), on an aliased cache: the output is the input
//   buffer. Here the kernel writes into the operand's own storage and the
//   wrapper returns that tensor.
//
// Arithmetic: none; a byte copy, bit for bit lax.dynamic_update_slice. Every
//   start but the row's is 0 after lax's clipping (the update spans those
//   dims whole), so only starts[ndim - 2] is read.
//
// Bound on the H100: the update read once and the row written once, 2 * P *
//   row_bytes over 3.35 TB/s (128 KB, 0.04 us, at the bench shape: P = 256
//   rows of 256 int8 values); a launch costs more than that.
//
// Design: one thread per 16 bytes of the update, so every load and store is
//   one 16-byte access (the wrapper's gate makes row_bytes a multiple of 16
//   and both tensors 16-byte aligned). The TPU kernel reads and writes back
//   the whole aligned 32-row tile around the row (its DMAs must cover full
//   tiles); the card needs no tile, so only the row moves.
#include "drq_common.cuh"

namespace {

__global__ void __launch_bounds__(256)
row_write_kernel(uint4* __restrict__ operand, const uint4* __restrict__ update,
                 const int* __restrict__ starts, int ndim, long long P, int S,
                 int row_vecs) {
  const long long total = P * row_vecs;
  const int pos = min(max(starts[ndim - 2], 0), S - 1);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long p = i / row_vecs;
    const int c = (int)(i - p * row_vecs);
    operand[(p * S + pos) * row_vecs + c] = update[i];
  }
}

}  // namespace

// operand [P, S, row_bytes] bytes (any dtype, contiguous), update
// [P, 1, row_bytes], starts int32 [ndim] on the device. Refuses
// (kShapeRefused) unless row_bytes % 16 == 0, P > 0 and S > 0.
extern "C" int aeqt_cache_row_write(void* operand, const void* update,
                                    const void* starts, int ndim, long long P,
                                    int S, int row_bytes, void* stream) {
  if (row_bytes <= 0 || row_bytes % 16 || P <= 0 || S <= 0 || ndim < 2)
    return aeqt::kShapeRefused;
  const int row_vecs = row_bytes / 16;
  const long long total = P * row_vecs;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256
                                                       : 4096);
  row_write_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(operand), static_cast<const uint4*>(update),
      static_cast<const int*>(starts), ndim, P, S, row_vecs);
  return (int)cudaGetLastError();
}
