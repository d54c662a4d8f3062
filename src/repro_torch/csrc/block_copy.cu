// In-place block copy over a pool (RowClone over the PUMA KV pool), for
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/pud_bulk/kernel.py:block_copy
// (body _block_copy_kernel): pool[dst_i] <- pool[src_i] for each (src, dst)
// pair of an int32 (n_pairs, 2) list; blocks that are not listed are not
// touched.  The caller guarantees that sources and destinations are
// disjoint and destinations unique (checked on the host by the wrapper), so
// all pairs are copied at once with no ordering between them.
//
// Bound: device-memory bytes, 2 x n_pairs x block_bytes at 3.35 TB/s; there
// is no arithmetic.  Design: a 2-D grid, one row of thread blocks per pair
// and a few blocks along each pair's bytes; every thread moves 16-byte
// vectors, neighbouring threads on neighbouring addresses, so each warp
// issues 512-byte coalesced loads and stores.  Pools whose block size or
// base address is not 16-byte aligned take a byte-wise loop.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecsPerThread = 4;  // work per thread before adding a block

__global__ void __launch_bounds__(kThreads)
block_copy_vec16(uint4* pool, const int* src_dst, long long vecs_per_block) {
  const long long src = src_dst[2 * blockIdx.x];
  const long long dst = src_dst[2 * blockIdx.x + 1];
  const uint4* s = pool + src * vecs_per_block;
  uint4* d = pool + dst * vecs_per_block;
  const long long step = (long long)gridDim.y * blockDim.x;
  for (long long i = (long long)blockIdx.y * blockDim.x + threadIdx.x;
       i < vecs_per_block; i += step) {
    d[i] = s[i];
  }
}

__global__ void __launch_bounds__(kThreads)
block_copy_bytes(unsigned char* pool, const int* src_dst, long long block_bytes) {
  const long long src = src_dst[2 * blockIdx.x];
  const long long dst = src_dst[2 * blockIdx.x + 1];
  const unsigned char* s = pool + src * block_bytes;
  unsigned char* d = pool + dst * block_bytes;
  const long long step = (long long)gridDim.y * blockDim.x;
  for (long long i = (long long)blockIdx.y * blockDim.x + threadIdx.x;
       i < block_bytes; i += step) {
    d[i] = s[i];
  }
}

unsigned chunks_for(long long items) {
  long long c = (items + (long long)kThreads * kVecsPerThread - 1) /
                ((long long)kThreads * kVecsPerThread);
  if (c < 1) c = 1;
  if (c > 65535) c = 65535;
  return (unsigned)c;
}

}  // namespace

extern "C" int block_copy(void* pool, const void* src_dst, int n_pairs,
                          long long block_bytes, void* stream) {
  if (n_pairs <= 0 || block_bytes <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* pairs = static_cast<const int*>(src_dst);
  if (block_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(pool) % 16 == 0) {
    const long long vecs = block_bytes / 16;
    dim3 grid((unsigned)n_pairs, chunks_for(vecs));
    block_copy_vec16<<<grid, kThreads, 0, st>>>(static_cast<uint4*>(pool), pairs, vecs);
  } else {
    dim3 grid((unsigned)n_pairs, chunks_for(block_bytes));
    block_copy_bytes<<<grid, kThreads, 0, st>>>(static_cast<unsigned char*>(pool), pairs,
                                                block_bytes);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
