// Paged decode attention over the PUMA KV pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/kernel.py:
// paged_attention (body _paged_kernel).  For every sequence b and KV head h,
// the `group` query heads of that KV head attend to the first seq_lens[b]
// tokens of the sequence's KV stream, which lives as block_size-token pages
// listed in an int32 block table (-1 entries clamp to page 0; positions
// >= seq_lens[b] are masked).  Online softmax with an f32 running max, sum
// and accumulator; a sequence of length 0 gives zeros.  q, pools and output
// share one type, float32 or bfloat16.
//
// Bound: device-memory bytes (the K and V pages a sequence needs, read
// once), at 3.35 TB/s; the arithmetic (4 x group x D flops per token) is far
// below the card's rate.  Design: one thread block per (b, h) walks only the
// ceil(len / block_size) table entries the sequence needs (the TPU grid
// visits all max_blocks).  Each iteration stages a tile of one or more
// pages of K and V in shared memory as f32 with 16-byte loads, neighbouring
// threads on neighbouring addresses of a head row; all query heads of the
// group share the staged tile (one warp per (head, token) score, one warp per
// head for the softmax update, one thread per (head, channel) accumulator
// held in registers).  Staging several pages per iteration shortens the
// serial chain of load-then-compute steps of a long sequence.  No cp.async
// pipelining, no tensor cores: that is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kAccPerThread = 16;  // group * D <= kThreads * kAccPerThread
constexpr int kTileElems = 4096;   // K (or V) elements staged per tile, at least one page
constexpr float kNegInf = -1e30f;

// Floats of shared memory the kernel carves (q_s, k_s, v_s, p_s, m_s, l_s,
// a_s below, in that order); launch() sizes the allocation with it.
__host__ __device__ __forceinline__ long long smem_floats(int group, int D, int tile_rows) {
  return (long long)group * D + 2LL * tile_rows * D + (long long)group * tile_rows + 3LL * group;
}

// 16 bytes of T -> f32, by bit manipulation (exact for both types)
__device__ __forceinline__ void unpack(const uint4& r, float* d, const float*) {
  d[0] = __uint_as_float(r.x);
  d[1] = __uint_as_float(r.y);
  d[2] = __uint_as_float(r.z);
  d[3] = __uint_as_float(r.w);
}

__device__ __forceinline__ void unpack(const uint4& r, float* d, const __nv_bfloat16*) {
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    d[2 * i] = __uint_as_float(w[i] << 16);
    d[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool, const T* __restrict__ v_pool,
    const int* __restrict__ block_tables, const int* __restrict__ seq_lens,
    T* __restrict__ out, int Hkv, int group, int D, int bs, int max_blocks,
    int num_blocks, int tile_pages, float scale) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  extern __shared__ float smem[];       // smem_floats(group, D, tile_rows) floats
  const int tile_rows = tile_pages * bs;
  float* q_s = smem;                    // [group][D]
  float* k_s = q_s + group * D;         // [tile_rows][D]
  float* v_s = k_s + tile_rows * D;     // [tile_rows][D]
  float* p_s = v_s + tile_rows * D;     // [group][tile_rows] scores, then weights
  float* m_s = p_s + group * tile_rows; // [group] running max
  float* l_s = m_s + group;             // [group] running sum
  float* a_s = l_s + group;             // [group] rescale of this tile

  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x - b * Hkv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int vpr = D / kVec;             // 16-byte vectors per head row
  const int GD = group * D;
  const long long row_stride = (long long)Hkv * D;  // token to token in a page
  const long long qo = ((long long)b * Hkv + h) * GD;
  const int* tbl = block_tables + (long long)b * max_blocks;

  for (int i = threadIdx.x; i < group * vpr; i += kThreads) {
    const int r = i / vpr, c = (i - r * vpr) * kVec;
    unpack(*reinterpret_cast<const uint4*>(q + qo + (long long)r * D + c),
           q_s + r * D + c, q);
  }
  for (int g = threadIdx.x; g < group; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  float acc[kAccPerThread];
#pragma unroll
  for (int i = 0; i < kAccPerThread; ++i) acc[i] = 0.f;

  int len = seq_lens[b];
  if (len > max_blocks * bs) len = max_blocks * bs;
  __syncthreads();

  for (int start = 0; start < len; start += tile_rows) {
    const int n = min(tile_rows, len - start);  // valid tokens in this tile
    const int page0 = start / bs;
    for (int i = threadIdx.x; i < n * vpr; i += kThreads) {
      const int r = i / vpr, c = (i - r * vpr) * kVec;
      int blk = tbl[page0 + r / bs];
      blk = blk < 0 ? 0 : (blk >= num_blocks ? num_blocks - 1 : blk);
      const long long off =
          ((long long)blk * bs + r % bs) * row_stride + (long long)h * D + c;
      unpack(*reinterpret_cast<const uint4*>(k_pool + off), k_s + r * D + c, k_pool);
      unpack(*reinterpret_cast<const uint4*>(v_pool + off), v_s + r * D + c, v_pool);
    }
    __syncthreads();

    // scores: one warp per (query head, token), lanes split the channels
    for (int pr = warp; pr < group * n; pr += kWarps) {
      const int g = pr / n, t = pr - g * n;
      float s = 0.f;
      for (int d = lane; d < D; d += 32) s = fmaf(q_s[g * D + d], k_s[t * D + d], s);
      s = warp_sum(s);
      if (lane == 0) p_s[g * tile_rows + t] = s * scale;
    }
    __syncthreads();

    // online-softmax update: one warp per query head
    for (int g = warp; g < group; g += kWarps) {
      float* row = p_s + g * tile_rows;
      float mx = kNegInf;
      for (int t = lane; t < n; t += 32) mx = fmaxf(mx, row[t]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < n; t += 32) {
        const float p = expf(row[t] - m_new);
        row[t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[g] = alpha;
        l_s[g] = alpha * l_s[g] + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p @ V, one thread per (query head, channel)
#pragma unroll
    for (int i = 0; i < kAccPerThread; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      if (idx < GD) {
        const int g = idx / D, d = idx - g * D;
        const float* row = p_s + g * tile_rows;
        float a = acc[i] * a_s[g];
        for (int t = 0; t < n; ++t) a = fmaf(row[t], v_s[t * D + d], a);
        acc[i] = a;
      }
    }
    __syncthreads();  // the next tile overwrites k_s, v_s and p_s
  }

#pragma unroll
  for (int i = 0; i < kAccPerThread; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    if (idx < GD) {
      const float l = l_s[idx / D];
      store_as(out + qo + idx, acc[i] / (l == 0.f ? 1.f : l));
    }
  }
}

// Sizes the tile and the shared memory for these shapes and launches; a
// shape the kernel cannot take gives cudaErrorInvalidValue.
template <typename T>
int launch(const void* q, const void* k, const void* v, const void* tbl,
           const void* lens, void* out, int B, int Hkv, int group, int D, int bs,
           int max_blocks, int num_blocks, float scale, void* stream) {
  if (B <= 0 || Hkv <= 0) return 0;
  if (group <= 0 || D <= 0 || bs <= 0 || group * D > kThreads * kAccPerThread ||
      D % (16 / (int)sizeof(T)) != 0)
    return (int)cudaErrorInvalidValue;
  const int tile_pages = D * bs >= kTileElems ? 1 : kTileElems / (D * bs);
  const long long smem = sizeof(float) * smem_floats(group, D, tile_pages * bs);
  int device = 0, max_smem = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return (int)e;
  if (smem > max_smem) return (int)cudaErrorInvalidValue;
  const int smem_bytes = (int)smem;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  paged_attention_kernel<T><<<B * Hkv, kThreads, smem_bytes,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(tbl), static_cast<const int*>(lens),
      static_cast<T*>(out), Hkv, group, D, bs, max_blocks, num_blocks, tile_pages,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int paged_attention_f32(const void* q, const void* k, const void* v,
                                   const void* tbl, const void* lens, void* out,
                                   int B, int Hkv, int group, int D, int bs,
                                   int max_blocks, int num_blocks, float scale,
                                   void* stream) {
  return launch<float>(q, k, v, tbl, lens, out, B, Hkv, group, D, bs, max_blocks,
                       num_blocks, scale, stream);
}

extern "C" int paged_attention_bf16(const void* q, const void* k, const void* v,
                                    const void* tbl, const void* lens, void* out,
                                    int B, int Hkv, int group, int D, int bs,
                                    int max_blocks, int num_blocks, float scale,
                                    void* stream) {
  return launch<__nv_bfloat16>(q, k, v, tbl, lens, out, B, Hkv, group, D, bs,
                               max_blocks, num_blocks, scale, stream);
}

extern "C" const char* cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
