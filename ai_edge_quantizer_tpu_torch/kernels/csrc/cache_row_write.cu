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
//   rows of 256 int8 values); the launch and one trip to memory cost more
//   than that.
//
// Design: one thread per 16 bytes of the update, so every load and store is
//   one 16-byte access (the wrapper's gate makes row_bytes a multiple of 16
//   and both tensors 16-byte aligned). The vectors spread over every SM: a
//   block takes the warps that one SM's share of the vectors needs (at the
//   bench shape 4096 vectors, 32-thread blocks, 128 of them on 132 SMs), so
//   no SM runs more than one wave. The kernel is a programmatic dependent
//   launch (cudaLaunchKernelEx with programmatic stream serialization): its
//   blocks may start while the kernel before it on the stream finishes,
//   and wait in griddepcontrol.wait, before they read `starts` and
//   `update`, until that kernel's writes are visible; it lets a dependent
//   launch after it start at once. The TPU kernel reads and writes back the
//   whole aligned 32-row tile around the row (its DMAs must cover full
//   tiles); the card needs no tile, so only the row moves.
//
// aeqt_cache_row_write_floor launches an empty kernel with the same grid,
//   block and attribute: the launch floor that a study times beside the
//   kernel.
#include "drq_common.cuh"

namespace {

constexpr int kMaxThreads = 256;

__device__ __forceinline__ void allow_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ void wait_for_previous_grid() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

__global__ void __launch_bounds__(kMaxThreads)
row_write_kernel(uint4* __restrict__ operand, const uint4* __restrict__ update,
                 const int* __restrict__ starts, int ndim, long long P, int S,
                 int row_vecs) {
  allow_dependents();
  const long long total = P * row_vecs;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  wait_for_previous_grid();
  const int pos = min(max(starts[ndim - 2], 0), S - 1);
  for (long long i = first; i < total; i += stride) {
    const long long p = i / row_vecs;
    const int c = (int)(i - p * row_vecs);
    operand[(p * S + pos) * row_vecs + c] = update[i];
  }
}

// One argument, as the launch of a kernel with none would build an empty
// argument array.
__global__ void __launch_bounds__(kMaxThreads) floor_kernel(int) {
  allow_dependents();
  wait_for_previous_grid();
}

struct Launch {
  int blocks;
  int threads;
};

// The device's SM count, read once; 0 if it cannot be read.
int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) == cudaSuccess &&
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) ==
            cudaSuccess)
      sms = n;
  }
  return sms;
}

// Threads a block: the warps one SM's share of the vectors needs (32 to
// kMaxThreads); blocks: enough for every vector, at most 8 an SM (a
// grid-stride loop covers the rest). sms > 0.
Launch launch_of(long long total, int sms) {
  const long long share = (total + sms - 1) / sms;
  const long long warps = (share + 31) / 32;
  const int threads = (int)(warps * 32 < kMaxThreads ? warps * 32
                                                      : kMaxThreads);
  const long long blocks = (total + threads - 1) / threads;
  return {(int)(blocks < 8LL * sms ? blocks : 8LL * sms), threads};
}

template <typename... Params, typename... Actual>
int launch_dependent(void (*kernel)(Params...), Launch l, cudaStream_t stream,
                     Actual... args) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(l.blocks);
  config.blockDim = dim3(l.threads);
  config.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  config.attrs = &attr;
  config.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&config, kernel, args...);
}

bool takes(long long P, int S, int row_bytes) {
  return row_bytes > 0 && row_bytes % 16 == 0 && P > 0 && S > 0;
}

}  // namespace

// operand [P, S, row_bytes] bytes (any dtype, contiguous), update
// [P, 1, row_bytes], starts int32 [ndim] on the device. Refuses
// (kShapeRefused) unless row_bytes % 16 == 0, P > 0 and S > 0.
extern "C" int aeqt_cache_row_write(void* operand, const void* update,
                                    const void* starts, int ndim, long long P,
                                    int S, int row_bytes, void* stream) {
  if (!takes(P, S, row_bytes) || ndim < 2) return aeqt::kShapeRefused;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const int row_vecs = row_bytes / 16;
  return launch_dependent(
      row_write_kernel, launch_of(P * row_vecs, sms),
      static_cast<cudaStream_t>(stream), static_cast<uint4*>(operand),
      static_cast<const uint4*>(update), static_cast<const int*>(starts),
      ndim, P, S, row_vecs);
}

// The empty kernel at the launch aeqt_cache_row_write makes for P rows of
// row_bytes.
extern "C" int aeqt_cache_row_write_floor(long long P, int row_bytes,
                                          void* stream) {
  if (!takes(P, 1, row_bytes)) return aeqt::kShapeRefused;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  return launch_dependent(floor_kernel, launch_of(P * (row_bytes / 16), sms),
                          static_cast<cudaStream_t>(stream), 0);
}

// fields: blocks, threads of aeqt_cache_row_write's launch.
extern "C" int aeqt_cache_row_write_plan(int P, int row_bytes,
                                         long long* fields) {
  if (!takes(P, 1, row_bytes)) return aeqt::kShapeRefused;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const Launch l = launch_of((long long)P * (row_bytes / 16), sms);
  fields[0] = l.blocks;
  fields[1] = l.threads;
  return 0;
}
