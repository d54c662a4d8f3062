// Elementwise PUD bulk ops (Ambit AND/OR/NOT/MAJ, RowClone zero/copy, XOR)
// over raw bytes, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/pud_bulk/kernel.py:bulk_op
// (bodies _zero/_copy/_not/_and/_or/_xor/_maj_kernel): out = op(x, y, z)
// elementwise, with maj = (x & y) | (y & z) | (x & z).  Every op is
// bitwise, so the result does not depend on the element type: one kernel
// over the operands' bytes serves every dtype.  NOT is an XOR with a byte
// mask: 0xFF for integers, 0x01 for bool (so a bool stays 0 or 1).
//
// Bound: device-memory bytes, (arity + 1) x n_bytes at 3.35 TB/s; there is
// one logic op per byte.  Design: 16-byte vectors (uint4), neighbouring
// threads on neighbouring vectors, kUnroll independent vectors per thread
// in flight, one block per kThreads x kUnroll vectors (a grid-stride loop
// covers a grid past the launch limit), plain loads and stores.  On an
// H100 a first version with evict-first cache hints, 4 vectors in flight
// and a grid capped at 8 blocks per SM ran about 9 % slower than this one
// (PERF.md).  Byte counts and offsets are 64-bit: a 2 GiB operand
// overflows 32-bit indexing.  The vector path runs only when every pointer
// is 16-byte aligned; the bytes past the last whole vector, and any view
// off a 16-byte boundary, take a byte loop.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;

enum Op { kZero = 0, kCopy = 1, kNot = 2, kAnd = 3, kOr = 4, kXor = 5, kMaj = 6 };

template <int OP>
struct Arity {
  static constexpr int value = OP == kZero ? 0 : OP == kMaj ? 3 : (OP >= kAnd ? 2 : 1);
};

template <int OP, typename T>
__device__ __forceinline__ T apply(T x, T y, T z, T mask) {
  if (OP == kZero) return T(0);
  if (OP == kCopy) return x;
  if (OP == kNot) return T(x ^ mask);
  if (OP == kAnd) return T(x & y);
  if (OP == kOr) return T(x | y);
  if (OP == kXor) return T(x ^ y);
  return T((x & y) | (y & z) | (x & z));  // kMaj
}

template <int OP>
__device__ __forceinline__ uint4 apply4(uint4 x, uint4 y, uint4 z, uint32_t m) {
  uint4 r;
  r.x = apply<OP, uint32_t>(x.x, y.x, z.x, m);
  r.y = apply<OP, uint32_t>(x.y, y.y, z.y, m);
  r.z = apply<OP, uint32_t>(x.z, y.z, z.z, m);
  r.w = apply<OP, uint32_t>(x.w, y.w, z.w, m);
  return r;
}

// out[i] = op(a[i], b[i], c[i]) for bytes i in [begin, n), grid-stride.
template <int OP>
__device__ __forceinline__ void byte_loop(uint8_t* out, const uint8_t* a,
                                          const uint8_t* b, const uint8_t* c,
                                          long long begin, long long n,
                                          uint8_t mask) {
  constexpr int ar = Arity<OP>::value;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = begin + (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    uint8_t x = ar >= 1 ? a[i] : 0, y = ar >= 2 ? b[i] : 0, z = ar >= 3 ? c[i] : 0;
    out[i] = apply<OP, uint8_t>(x, y, z, mask);
  }
}

template <int OP>
__global__ void __launch_bounds__(kThreads)
bulk_vec16(uint8_t* out, const uint8_t* a, const uint8_t* b, const uint8_t* c,
           long long n_bytes, uint32_t mask32) {
  constexpr int ar = Arity<OP>::value;
  const long long n_vec = n_bytes / 16;
  const uint4* va = reinterpret_cast<const uint4*>(a);
  const uint4* vb = reinterpret_cast<const uint4*>(b);
  const uint4* vc = reinterpret_cast<const uint4*>(c);
  uint4* vo = reinterpret_cast<uint4*>(out);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (long long base = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       base < n_vec; base += stride * kUnroll) {
    uint4 x[kUnroll], y[kUnroll], z[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * stride;
      const bool in = i < n_vec;
      x[u] = (ar >= 1 && in) ? va[i] : zero;
      y[u] = (ar >= 2 && in) ? vb[i] : zero;
      z[u] = (ar >= 3 && in) ? vc[i] : zero;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * stride;
      if (i < n_vec) vo[i] = apply4<OP>(x[u], y[u], z[u], mask32);
    }
  }
  byte_loop<OP>(out, a, b, c, n_vec * 16, n_bytes, (uint8_t)mask32);
}

template <int OP>
__global__ void __launch_bounds__(kThreads)
bulk_bytes(uint8_t* out, const uint8_t* a, const uint8_t* b, const uint8_t* c,
           long long n_bytes, uint32_t mask32) {
  byte_loop<OP>(out, a, b, c, 0, n_bytes, (uint8_t)mask32);
}

bool aligned16(const void* p) { return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <int OP>
cudaError_t launch(uint8_t* out, const uint8_t* a, const uint8_t* b, const uint8_t* c,
                   long long n_bytes, uint32_t mask32, cudaStream_t st) {
  const bool vec = aligned16(out) && aligned16(a) && aligned16(b) && aligned16(c);
  const long long items = vec ? (n_bytes / 16 + kUnroll - 1) / kUnroll : n_bytes;
  long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) blocks = 0x7fffffffLL;  // the launch limit of gridDim.x
  if (blocks < 1) blocks = 1;
  if (vec) {
    bulk_vec16<OP><<<(unsigned)blocks, kThreads, 0, st>>>(out, a, b, c, n_bytes, mask32);
  } else {
    bulk_bytes<OP><<<(unsigned)blocks, kThreads, 0, st>>>(out, a, b, c, n_bytes, mask32);
  }
  return cudaGetLastError();
}

}  // namespace

// op: 0 zero, 1 copy, 2 not, 3 and, 4 or, 5 xor, 6 maj.  Unused operand
// pointers are null.  not_mask is the byte NOT flips (0xFF, or 0x01 for bool).
extern "C" int bulk_op(int op, void* out, const void* a, const void* b, const void* c,
                       long long n_bytes, int not_mask, void* stream) {
  if (n_bytes <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint8_t* o = static_cast<uint8_t*>(out);
  const uint8_t* x = static_cast<const uint8_t*>(a);
  const uint8_t* y = static_cast<const uint8_t*>(b);
  const uint8_t* z = static_cast<const uint8_t*>(c);
  const uint32_t m = (uint32_t)(not_mask & 0xFF) * 0x01010101u;
  switch (op) {
    case kZero: return (int)launch<kZero>(o, x, y, z, n_bytes, m, st);
    case kCopy: return (int)launch<kCopy>(o, x, y, z, n_bytes, m, st);
    case kNot: return (int)launch<kNot>(o, x, y, z, n_bytes, m, st);
    case kAnd: return (int)launch<kAnd>(o, x, y, z, n_bytes, m, st);
    case kOr: return (int)launch<kOr>(o, x, y, z, n_bytes, m, st);
    case kXor: return (int)launch<kXor>(o, x, y, z, n_bytes, m, st);
    case kMaj: return (int)launch<kMaj>(o, x, y, z, n_bytes, m, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
