// Flash (online-softmax) attention forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:
// flash_attention (body _flash_kernel) with the padding of its wrapper
// ops.py:flash_attention.  For q (B, Hq, Sq, D) against k, v (B, Hkv, Sk, D),
// query head h attends to KV head h / (Hq / Hkv): out = softmax(q k^T * scale) v.
// The mask is kpos < Sk and, when causal, qpos >= kpos, both positions
// counted from 0 (top-left alignment, as the TPU kernel: for Sq != Sk this is
// not the bottom-right convention).  A fully masked row gives 0.  The running
// max, sum and accumulator are f32; the output is in q's type.  Forward only:
// the TPU kernel has no backward pass either.
//
// Ragged Sq and Sk are masked here (keys past Sk are staged as zeros and
// masked out, rows past Sq are computed and not stored), so the TPU wrapper's
// zero-padding of Sq, Sk and D to its tiles is not carried over.  Tensors are
// taken through their strides with D contiguous, so the (B, S, H, D) ->
// (B, H, S, D) transposed views of the model's attention need no copy; the
// output is written through its own strides.
//
// Bounds at the main shape (B 4, H 32, S 2048, D 64, causal, bf16):
//   * operations: the visible pairs' q.k and p.v, 2 * 2 * B * H * D * S(S+1)/2
//     = 6.9e10, take 0.0695 ms at 989 TFLOP/s;
//   * bytes: q, k, v read once and out written once, 134 MB, take 0.040 ms
//     at 3.35 TB/s;
//   * exponentials: one ex2 per computed pair at 16 per SM per clock (the
//     multi-function unit), as many pairs per clock as the tensor cores
//     manage at D = 64, so about 0.07 ms: the softmax has to overlap the
//     products to come near the operations bound;
//   * L2 -> shared memory: q tile i reads the K and V rows of (i+1) tiles, so
//     with 64-row q tiles about 1.1 GB cross from L2, with 128-row tiles
//     about 0.57 GB.
// So it is bound by operations, with the exponentials level with them.  At
// mistral_nemo_12b's shape (q B 4, H 32, S 2048, D 128 against k, v of 8
// heads, causal, bf16) the same pairs cost twice the operations, 1.375e11 or
// 0.139 ms, against 0.050 ms of bytes (168 MB), and the exponentials stay
// at about 0.07 ms: bound by operations, the exponentials half of them.
// But K and V cross from L2 to shared memory once per 128-row q tile, 1.14
// GB in all, which takes about as long as the products at the rate the L2
// gives: without its products the kernel still takes 0.21 ms.
//
// In f32 (q/k/v (4, 32, 2048, 64) causal) the same pairs' operations take
// 1.026 ms at the 67 TFLOP/s of float32 on CUDA cores; on TF32 tensor cores
// three products a fragment (below) take 3 x 6.9e10 at 495 TFLOP/s, 0.417
// ms, against 0.080 ms of bytes (268 MB): bound by operations either way.
//
// Four paths, chosen before the launch by type, D and alignment alone (a
// path that fails raises; none falls back to another):
//   * "wgmma": bf16 with D = 64 or 128, and q, k, v and out each with a
//     16-byte aligned base and, for batch, head and seq of size > 1, a
//     positive stride of a multiple of 16 bytes (the main path's transposed
//     views qualify).  One persistent block per SM (a producer warpgroup
//     and two consumer warpgroups of 64 query rows) walks work items of 128
//     query rows of one (b, h); the items come in pairs, q tiles nq-1-i and
//     i, so that every pair carries the same causal work.  The producer's
//     one thread loads Q into one of two buffers and K/V tiles of 128 keys
//     into a ring with TMA (tensor maps encoded on the host for each call,
//     the 128-byte swizzle, zeros past S), paced by full and empty
//     mbarriers, so the next item's Q and first K/V tiles load while this
//     item ends.  setmaxnreg moves registers from the producer (24) to the
//     consumers (240).  Each consumer runs S = Q K^T as wgmma m64n128k16
//     (both from shared memory, D / 16 k-steps) and O += P V as one wgmma
//     of width D per 16 keys with P from registers (the S accumulator's
//     layout is mma.sync's C layout repeated, so it packs to bf16 as the A
//     fragment) and V read MN-major.  S of tile j is started with P V of
//     tile j-1, and the softmax of tile j runs while P V of tile j-1 is on
//     the tensor cores.  The softmax is base 2 (ex2.approx), with the scale
//     folded into the exponent's FMA when it is positive, the mask applied
//     only on tiles that cross the diagonal or the end of the keys, and
//     each row's sum kept per thread until the item ends.  K/V tiles wholly
//     above the diagonal are skipped: their weights are exactly 0.
//     At D = 64 the ring has three stages, K and V of a stage share one
//     full and one empty barrier, and O is stored from registers.  At
//     D = 128 a 256-byte row is two 128-byte swizzle atoms, so every tile is
//     stored as two column halves, loaded as two boxes on one barrier, and
//     the second half's k-steps and P V's second 64 columns take descriptors
//     an atom stride on; two Q buffers then leave room for two stages (192
//     KB), so K and V have barriers of their own and the producer loads K of
//     a tile ahead of V of the one before: K is freed once S is done and
//     loads under the softmax and P V.  There the two consumer warpgroups
//     also take turns to issue their products (named barriers), and O goes
//     out through each warpgroup's rows of its Q buffer by TMA.
//     (PERF_HISTORY.md holds the variants measured and not kept: cp.async
//     consumers without a producer; at D = 64 the turns of the two
//     warpgroups, the split barriers and the TMA store; at D = 128 two
//     products of width 64 for P V, a skipped rescale of O, 256-byte L2
//     promotion.)
//   * "mma": other bf16 with D a multiple of 16 up to 128, K/V rows on
//     16-byte boundaries and q/out rows on 4-byte ones: one block per (q
//     tile of 64 rows, query head, batch), the q tiles of a head in reverse
//     order so the longest causal rows start first; four warps of 16 query
//     rows on mma.sync m16n8k16, K/V tiles of 64 keys through two cp.async
//     stages (rows padded against bank conflicts), V read transposed by
//     ldmatrix.trans, the same base-2 softmax.
//   * "tf32x3": f32 with D a multiple of 8 up to 128, k, v and out each with
//     a 16-byte aligned base and, for batch, head and seq of size > 1, a
//     stride of a multiple of 4 elements (q is read a float at a time; the
//     model's transposed views qualify).  The reference holds f32 to 2e-5,
//     which one TF32 product misses by 10-70x; so every operand x is split
//     as its fragment loads, hi = x rounded to TF32 and lo = x - hi (passed
//     as it is: the tensor core reads its top 19 bits), and each product is
//     three mma.sync m16n8k8 TF32 products, lo.hi + hi.lo + hi.hi.  The
//     tensor core cuts each sum it makes to its own 24 bits, so where the
//     products accumulate matters as much as the split: S keeps hi.hi and
//     the two small products in two accumulators, added once a tile's
//     k-steps are done, and each K/V tile's P V is summed from zero, 64
//     columns at a time, and added to the rescaled O in one FMA.  At the
//     main shape that is 1.6e-6 from float64 on the card, where plain f32
//     is 1.1e-6 and one accumulator for all of it 5.9e-6
//     (scripts/flash_precision.py models the adder).  The grid of the "mma"
//     path: one block per (q tile of 64 rows, query head, batch), the q
//     tiles longest-causal-first, four warps of 16 query rows.  The q tile,
//     scaled by scale x log2(e), sits in shared memory beside two cp.async
//     stages of 32-key K/V tiles (rows padded to D + 4 floats, so the reads
//     below hit distinct banks); an ldmatrix of f32 rows (an 8 x 16-byte
//     matrix is an 8 x 4 block of f32) gives the tf32 A fragments of q and
//     the B fragments of K.  S stays in registers, and so does P: the tf32
//     C fragment (keys 2t, 2t+1) is not the A fragment (keys t, t+4), so
//     P V takes key 2t as k-index t and 2t + 1 as t + 4 and reads V's rows
//     in that order, two columns a float2, which also gives each thread
//     four neighbouring output columns to store at once.  The softmax is
//     the "mma" path's (base 2, ex2.approx, masks only on edge tiles, quad
//     shuffles), the row sums kept per thread until the end; tiles above
//     the diagonal are skipped, by a block and by a warp.  At the main
//     shape it takes 1.38 ms, about 150 TFLOP/s of TF32 products: half of
//     what mma.sync TF32 reaches with nothing else to issue
//     (scripts/mma_rate.py, 319 TFLOP/s at 16 warps an SM); the splits,
//     loads and softmax issue beside every product (PERF.md §6).
//   * "simt": f32 and bf16 shapes no tensor-core path takes (D not a
//     multiple of 8 or over 128, unaligned rows): the same grid, 256
//     threads on CUDA cores in f32, a 4 x 4 score micro-tile and a
//     4 x ceil(D/16) output micro-tile per thread, the softmax in shared
//     memory.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 64;  // keys per staged tile

struct Params {
  int B, Hq, Hkv, Sq, Sk, D, causal;
  float scale;
  long long q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s;  // element strides
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ bool visible(int qpos, int kpos, int Sk, int causal) {
  return kpos < Sk && (!causal || qpos >= kpos);
}

// Keys a q tile starting at q0 can see: all of them, or under the causal
// mask none past its last row.
__device__ __forceinline__ int key_end(const Params& p, int q0) {
  return p.causal ? min(p.Sk, q0 + kBQ) : p.Sk;
}

// -- f32 math on CUDA cores -----------------------------------------------

constexpr int kSimtThreads = 256;

__host__ __device__ __forceinline__ long long simt_smem_floats(int D) {
  // q_s [kBQ][D], k_s [kBK][D+1], v_s [kBK][D], p_s [kBQ][kBK+1], m_s, l_s, a_s [kBQ]
  return (long long)kBQ * D + (long long)kBK * (D + 1) + (long long)kBK * D +
         (long long)kBQ * (kBK + 1) + 3LL * kBQ;
}

template <typename T, int MAXC>  // MAXC >= ceil(D / 16) output columns per thread
__global__ void __launch_bounds__(kSimtThreads) flash_simt_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, Params p) {
  extern __shared__ float smem[];
  const int D = p.D, KS = D + 1, PS = kBK + 1;
  float* q_s = smem;
  float* k_s = q_s + kBQ * D;
  float* v_s = k_s + kBK * KS;
  float* p_s = v_s + kBK * D;
  float* m_s = p_s + kBQ * PS;
  float* l_s = m_s + kBQ;
  float* a_s = l_s + kBQ;

  const int tid = threadIdx.x;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const T* qb = q + b * p.q_b + h * p.q_h;
  const T* kb = k + b * p.k_b + hk * p.k_h;
  const T* vb = v + b * p.v_b + hk * p.v_h;
  T* ob = out + b * p.o_b + h * p.o_h;

  for (int i = tid; i < kBQ * D; i += kSimtThreads) {
    const int r = i / D, c = i - r * D;
    q_s[i] = q0 + r < p.Sq ? to_f32(qb[(q0 + r) * p.q_s + c]) : 0.f;
  }
  for (int r = tid; r < kBQ; r += kSimtThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  const int rg = tid / 16, cg = tid % 16;  // rows rg*4 + i, columns cg + 16*j
  float acc[4][MAXC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < MAXC; ++j) acc[i][j] = 0.f;

  const int kend = key_end(p, q0);
  for (int k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed (and q_s, m_s, l_s are set)
    const int n = min(kBK, p.Sk - k0);
    for (int i = tid; i < kBK * D; i += kSimtThreads) {
      const int r = i / D, c = i - r * D;
      float kv = 0.f, vv = 0.f;
      if (r < n) {
        kv = to_f32(kb[(k0 + r) * p.k_s + c]);
        vv = to_f32(vb[(k0 + r) * p.v_s + c]);
      }
      k_s[r * KS + c] = kv;
      v_s[r * D + c] = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(rg * 4 + i) * D + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = k_s[(cg + 16 * j) * KS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = rg * 4 + i, c = cg + 16 * j;
        p_s[r * PS + c] = visible(q0 + r, k0 + c, p.Sk, p.causal) ? s[i][j] * p.scale : kNegInf;
      }
    __syncthreads();

    {  // online-softmax update: four threads per row, 16 keys each
      const int r = tid / 4, part = tid % 4;
      float* row = p_s + r * PS;
      float mx = kNegInf;
      for (int c = part * 16; c < part * 16 + 16; ++c) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = part * 16; c < part * 16 + 16; ++c) {
        const float e = visible(q0 + r, k0 + c, p.Sk, p.causal) ? expf(row[c] - m_new) : 0.f;
        row[c] = e;
        sum += e;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[rg * 4 + i];
#pragma unroll
      for (int j = 0; j < MAXC; ++j) acc[i][j] *= alpha;
    }
    for (int t = 0; t < n; ++t) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(rg * 4 + i) * PS + t];
#pragma unroll
      for (int j = 0; j < MAXC; ++j) {
        const int c = cg + 16 * j;
        if (c < D) {
          const float vv = v_s[t * D + c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg * 4 + i;
    if (q0 + r >= p.Sq) continue;
    const float l = l_s[r];
    const float inv = 1.f / (l == 0.f ? 1.f : l);
#pragma unroll
    for (int j = 0; j < MAXC; ++j) {
      const int c = cg + 16 * j;
      if (c < D) store_as(ob + (q0 + r) * p.o_s + c, acc[i][j] * inv);
    }
  }
}

// -- bf16 on tensor cores (mma.sync m16n8k16) --------------------------------

constexpr int kMmaThreads = 128;  // four warps of 16 query rows

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros when !valid (nothing read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8x8 b16 matrices, transposed: lanes 8m..8m+7 give the row addresses of matrix m
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

template <int D>
constexpr int mma_smem_bytes() {  // two stages of K and V tiles, rows padded by 16 bytes
  return 2 * 2 * kBK * (D + 8) * 2;
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads) flash_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, Params p) {
  constexpr int STR = D + 8;     // K and V rows in shared memory (bf16), padded
  constexpr int NKS = D / 16;    // k-steps of Q.K^T over D
  constexpr int NDT = D / 8;     // 8-wide output tiles over D
  constexpr int NKT = kBK / 8;   // 8-wide score tiles over the keys
  constexpr int CPR = D / 8;     // 16-byte chunks per row
  extern __shared__ __align__(16) __nv_bfloat16 mma_smem[];  // [2 stages][K, V][kBK][STR]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group, column pair
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const __nv_bfloat16* qb = q + b * p.q_b + h * p.q_h;
  const __nv_bfloat16* kb = k + b * p.k_b + hk * p.k_h;
  const __nv_bfloat16* vb = v + b * p.v_b + hk * p.v_h;
  __nv_bfloat16* ob = out + b * p.o_b + h * p.o_h;
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;

  // K/V tile of keys k0.. into stage st: cp.async 16-byte chunks, zeros past Sk
  auto stage = [&](int st, int k0) {
    __nv_bfloat16* ks = mma_smem + st * 2 * kBK * STR;
    __nv_bfloat16* vs = ks + kBK * STR;
#pragma unroll
    for (int i = tid; i < kBK * CPR; i += kMmaThreads) {
      const int r = i / CPR, c = (i - r * CPR) * 8;
      const bool ok = k0 + r < p.Sk;
      const long long row = ok ? k0 + r : k0;
      cp_async16(ks + r * STR + c, kb + row * p.k_s + c, ok);
      cp_async16(vs + r * STR + c, vb + row * p.v_s + c, ok);
    }
    cp_async_commit();
  };

  const int kend = key_end(p, q0);
  if (kend > 0) stage(0, 0);

  uint32_t qa[NKS][4];  // A fragments of this warp's 16 q rows
#pragma unroll
  for (int ks = 0; ks < NKS; ++ks) {
    const int c = ks * 16 + t * 2;
    qa[ks][0] = row0 < p.Sq ? ld32(qb + row0 * p.q_s + c) : 0u;
    qa[ks][1] = row1 < p.Sq ? ld32(qb + row1 * p.q_s + c) : 0u;
    qa[ks][2] = row0 < p.Sq ? ld32(qb + row0 * p.q_s + c + 8) : 0u;
    qa[ks][3] = row1 < p.Sq ? ld32(qb + row1 * p.q_s + c + 8) : 0u;
  }
  float o[NDT][4];
#pragma unroll
  for (int dt = 0; dt < NDT; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // running max (base 2) and sum
  const float scale2 = p.scale * 1.4426950408889634f;     // scale * log2(e)

  for (int k0 = 0, it = 0; k0 < kend; k0 += kBK, ++it) {
    // the next tile streams in while this one is used
    if (k0 + kBK < kend) {
      stage((it + 1) & 1, k0 + kBK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* ks = mma_smem + (it & 1) * 2 * kBK * STR;
    const __nv_bfloat16* vs = ks + kBK * STR;

    float s[NKT][4];  // scores: rows g, g+8 of the warp; keys j*8 + t*2 + {0,1}
#pragma unroll
    for (int j = 0; j < NKT; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NKS; ++kk) {
        const __nv_bfloat16* kr = ks + (j * 8 + g) * STR + kk * 16 + t * 2;
        mma_bf16(s[j], qa[kk], ld32(kr), ld32(kr + 8));
      }
    }

    // Softmax in base 2 (scores scaled by scale * log2(e), ex2.approx): one
    // MUFU instruction per weight.  Only tiles that cross the causal
    // diagonal or the end of the keys need the mask.
    const bool masked = k0 + kBK > p.Sk || (p.causal && k0 + kBK - 1 > q0 + warp * 16);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kpos = k0 + j * 8 + t * 2 + e;
        s[j][e] *= scale2;
        s[j][2 + e] *= scale2;
        if (masked) {
          if (!visible(row0, kpos, p.Sk, p.causal)) s[j][e] = kNegInf;
          if (!visible(row1, kpos, p.Sk, p.causal)) s[j][2 + e] = kNegInf;
        }
        mx0 = fmaxf(mx0, s[j][e]);
        mx1 = fmaxf(mx1, s[j][2 + e]);
      }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = exp2_approx(m0 - mn0), alpha1 = exp2_approx(m1 - mn1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] = exp2_approx(s[j][e] - mn0);
        s[j][2 + e] = exp2_approx(s[j][2 + e] - mn1);
        if (masked) {  // a row with nothing visible yet has mn = kNegInf: keep its weights 0
          const int kpos = k0 + j * 8 + t * 2 + e;
          if (!visible(row0, kpos, p.Sk, p.causal)) s[j][e] = 0.f;
          if (!visible(row1, kpos, p.Sk, p.causal)) s[j][2 + e] = 0.f;
        }
        sum0 += s[j][e];
        sum1 += s[j][2 + e];
      }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, o_);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, o_);
    }
    l0 = alpha0 * l0 + sum0;
    l1 = alpha1 * l1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int dt = 0; dt < NDT; ++dt) {
      o[dt][0] *= alpha0;
      o[dt][1] *= alpha0;
      o[dt][2] *= alpha1;
      o[dt][3] *= alpha1;
    }
    const int mrow = (lane & 7) + ((lane >> 3) & 1) * 8;  // ldmatrix row of this lane
    const int mcol = (lane >> 4) * 8;                       // and its 8-column offset
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      // the C fragments of score tiles 2kk and 2kk+1 are the A fragment of keys 16kk..16kk+15
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dt = 0; dt < NDT; dt += 2) {
        // B fragments of output tiles dt and dt+1: V rows 16kk.., transposed
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vs + (kk * 16 + mrow) * STR + dt * 8 + mcol);
        mma_bf16(o[dt], pa, vf[0], vf[1]);
        mma_bf16(o[dt + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // this stage is refilled two tiles on
  }

  const float inv0 = 1.f / (l0 == 0.f ? 1.f : l0), inv1 = 1.f / (l1 == 0.f ? 1.f : l1);
#pragma unroll
  for (int dt = 0; dt < NDT; ++dt) {
    const int c = dt * 8 + t * 2;
    if (row0 < p.Sq)
      *reinterpret_cast<uint32_t*>(ob + row0 * p.o_s + c) = pack_bf16(o[dt][0] * inv0, o[dt][1] * inv0);
    if (row1 < p.Sq)
      *reinterpret_cast<uint32_t*>(ob + row1 * p.o_s + c) = pack_bf16(o[dt][2] * inv1, o[dt][3] * inv1);
  }
}

// -- f32 on TF32 tensor cores, three products a fragment (mma.sync m16n8k8) --

constexpr int kTfThreads = 128;  // four warps of 16 query rows

// The instance for head widths up to DP (a multiple of 16; D itself is a
// multiple of 8, the columns past it zeros).  The block's q tile (64 rows,
// scaled) and two stages of 32-key K/V tiles sit in shared memory: 52 KB at
// DP = 64, so four blocks an SM (16 warps), and 101 KB at DP = 128, two.
// Holding q in registers instead (as hi, lo pairs) and 64-key tiles took
// every register and spilled: 2.5 % slower at D = 64, 24 % at D = 128
// (PERF_HISTORY.md holds the variants measured).
template <int DP>
struct TfShape {
  static_assert(DP % 16 == 0 && DP <= 128, "the tf32x3 path takes D up to 128");
  static constexpr int kKeys = 32;
  // floats a shared row: DP + 4 puts the eight rows an ldmatrix reads and
  // the V rows 2t, 2t + 1 that P V reads in distinct banks
  static constexpr int kStr = DP + 4;
  static constexpr int kMinBlocks = DP <= 64 ? 4 : 2;
  static constexpr int kSmem = (kBQ + 2 * 2 * kKeys) * kStr * 4;  // q, then K, V x 2 stages
};

// x = hi + lo as the tensor core reads them: hi rounded to TF32 (to nearest,
// ties away from zero: cvt.rna.tf32.f32's rounding, in two integer
// operations, which ran faster than the conversion: PERF_HISTORY.md),
// lo = x - hi exact in f32 and passed as it is (the tensor core reads its
// top 19 bits); scripts/flash_precision.py holds the split to float64
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a . b for split operands: lo.hi and hi.lo into c_small, hi.hi into c_big
// (lo.lo, under 2^-22 of the product, is dropped); the two may be one
__device__ __forceinline__ void mma_3xtf32(float (&c_big)[4], float (&c_small)[4],
                                           const uint32_t (&ahi)[4], const uint32_t (&alo)[4],
                                           float b0, float b1) {
  uint32_t h0, l0, h1, l1;
  split_tf32(b0, h0, l0);
  split_tf32(b1, h1, l1);
  mma_tf32(c_small, alo, h0, h1);
  mma_tf32(c_small, ahi, l0, l1);
  mma_tf32(c_big, ahi, h0, h1);
}

__device__ __forceinline__ void split_frag(const float (&x)[4], uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(x[i], hi[i], lo[i]);
}

// four 8 x 16-byte matrices: lanes 8m..8m+7 give the row addresses of matrix
// m; lane (g, t) gets word t of row g of each
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

template <int DP>
__global__ void __launch_bounds__(kTfThreads, TfShape<DP>::kMinBlocks) flash_tf32x3_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ out, Params p) {
  using Shape = TfShape<DP>;
  constexpr int KB = Shape::kKeys, STR = Shape::kStr;
  constexpr int NKS = DP / 8;    // 8-wide k-steps of Q.K^T over D
  constexpr int NKT = KB / 8;    // 8-key score tiles of a K/V tile
  constexpr int NDC = DP / 16;   // 16-wide column chunks of O (two n-tiles each)
  constexpr int GDC = NDC < 4 ? NDC : 4;  // chunks of a P V column group (64 columns)
  constexpr int CPR = DP / 4;    // 16-byte chunks of a shared row
  extern __shared__ __align__(16) float tf_smem[];  // q [kBQ][STR], [2 stages][K, V][KB][STR]
  float* const q_sm = tf_smem;
  float* const kv_sm = tf_smem + kBQ * STR;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group, thread in group
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const float* qb = q + b * p.q_b + h * p.q_h;
  const float* kb = k + b * p.k_b + hk * p.k_h;
  const float* vb = v + b * p.v_b + hk * p.v_h;
  float* ob = out + b * p.o_b + h * p.o_h;
  const int wrow = q0 + warp * 16;  // the warp's first query row
  const int row0 = wrow + g, row1 = row0 + 8;
  const int D = p.D;

  // K/V tile of keys k0.. into stage st: cp.async 16-byte chunks, zeros past
  // Sk and in the columns past D
  auto stage = [&](int st, int k0) {
    float* ks = kv_sm + st * 2 * KB * STR;
    float* vs = ks + KB * STR;
#pragma unroll
    for (int i = tid; i < KB * CPR; i += kTfThreads) {
      const int r = i / CPR, c = (i - r * CPR) * 4;
      const bool ok = k0 + r < p.Sk && c < D;
      const long long off = ok ? (long long)(k0 + r) * p.k_s + c : (long long)k0 * p.k_s;
      const long long voff = ok ? (long long)(k0 + r) * p.v_s + c : (long long)k0 * p.v_s;
      cp_async16(ks + r * STR + c, kb + off, ok);
      cp_async16(vs + r * STR + c, vb + voff, ok);
    }
    cp_async_commit();
  };

  const int kend = key_end(p, q0);
  if (kend > 0) stage(0, 0);

  // the block's q tile, scaled by scale * log2(e) (the softmax runs in base
  // 2), zeros past Sq and D; a float at a time, so q needs no alignment
  const float scale2 = p.scale * 1.4426950408889634f;
  for (int i = tid; i < kBQ * DP; i += kTfThreads) {
    const int r = i / DP, c = i - r * DP;
    q_sm[r * STR + c] = q0 + r < p.Sq && c < D ? qb[(long long)(q0 + r) * p.q_s + c] * scale2 : 0.f;
  }

  // O's n-tiles 2j and 2j + 1 hold columns 16j + 4t + {0, 2} and
  // 16j + 4t + {1, 3} of rows g and g + 8 (P V reads V's columns 16j + 2g and
  // 16j + 2g + 1 as one float2), so a thread stores four neighbours a row
  float o[2 * NDC][4];
#pragma unroll
  for (int j = 0; j < 2 * NDC; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;  // running max (base 2) of rows g, g + 8
  float l0 = 0.f, l1 = 0.f;          // this thread's share of the row sums
  const int lrow = lane & 7, lcol = (lane >> 3) * 4;  // ldmatrix row address of this lane

  for (int k0 = 0, it = 0; k0 < kend; k0 += KB, ++it) {
    // the next tile streams in while this one is used
    if (k0 + KB < kend) {
      stage((it + 1) & 1, k0 + KB);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* ks = kv_sm + (it & 1) * 2 * KB * STR;
    const float* vs = ks + KB * STR;
    // under the causal mask a warp whose rows all precede the tile skips it
    if (!p.causal || k0 <= wrow + 15) {
      // S = Q K^T: an ldmatrix of rows j*8.. and columns 8kp.. gives lane
      // (g, t) K[j*8 + g][8kp + t (+4, +8, +12)]: the B fragments of k-steps
      // kp and kp + 1.  hi.hi goes to s and the two small products to ss,
      // added once the tile's k-steps are done: the tensor core cuts each
      // sum it makes to its own 24 bits, so the small products summed into
      // the large one lose more than they carry (scripts/flash_precision.py)
      float s[NKT][4], ss[NKT][4];
#pragma unroll
      for (int j = 0; j < NKT; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        ss[j][0] = ss[j][1] = ss[j][2] = ss[j][3] = 0.f;
      }
#pragma unroll
      for (int kp = 0; kp < NKS; kp += 2) {
        // the A fragments of k-steps kp and kp + 1 by ldmatrix (rows g and
        // g + 8, columns t and t + 4), split
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          uint32_t qr[4];
          ldmatrix_x4(qr, q_sm + (warp * 16 + ((lane >> 3) & 1) * 8 + lrow) * STR + (kp + e) * 8 +
                              (lane >> 4) * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(qr[i]), ah[e][i], al[e][i]);
        }
#pragma unroll
        for (int j = 0; j < NKT; ++j) {
          uint32_t kr[4];
          ldmatrix_x4(kr, ks + (j * 8 + lrow) * STR + kp * 8 + lcol);
          mma_3xtf32(s[j], ss[j], ah[0], al[0], __uint_as_float(kr[0]), __uint_as_float(kr[1]));
          mma_3xtf32(s[j], ss[j], ah[1], al[1], __uint_as_float(kr[2]), __uint_as_float(kr[3]));
        }
      }
#pragma unroll
      for (int j = 0; j < NKT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[j][i] += ss[j][i];

      // Softmax in base 2 (ex2.approx); only tiles that cross the causal
      // diagonal or the end of the keys need the mask
      const bool masked = k0 + KB > p.Sk || (p.causal && k0 + KB - 1 > wrow);
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int j = 0; j < NKT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (masked) {
            const int kpos = k0 + j * 8 + t * 2 + e;
            if (!visible(row0, kpos, p.Sk, p.causal)) s[j][e] = kNegInf;
            if (!visible(row1, kpos, p.Sk, p.causal)) s[j][2 + e] = kNegInf;
          }
          mx0 = fmaxf(mx0, s[j][e]);
          mx1 = fmaxf(mx1, s[j][2 + e]);
        }
#pragma unroll
      for (int o_ = 1; o_ <= 2; o_ <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float alpha0 = exp2_approx(m0 - mn0), alpha1 = exp2_approx(m1 - mn1);
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < NKT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[j][e] = exp2_approx(s[j][e] - mn0);
          s[j][2 + e] = exp2_approx(s[j][2 + e] - mn1);
          if (masked) {  // a row with nothing visible yet has mn = kNegInf: keep its weights 0
            const int kpos = k0 + j * 8 + t * 2 + e;
            if (!visible(row0, kpos, p.Sk, p.causal)) s[j][e] = 0.f;
            if (!visible(row1, kpos, p.Sk, p.causal)) s[j][2 + e] = 0.f;
          }
          sum0 += s[j][e];
          sum1 += s[j][2 + e];
        }
      l0 = alpha0 * l0 + sum0;
      l1 = alpha1 * l1 + sum1;
      m0 = mn0;
      m1 = mn1;

      // O = O * alpha + P V.  S's C fragment holds keys 2t and 2t + 1 of
      // each 8; taken as P's A fragment it puts key 2t at k-index t and key
      // 2t + 1 at t + 4, so V's B fragment reads rows 2t and 2t + 1 (the
      // order of the keys in a sum does not matter): P never leaves the
      // registers.  The tile's P V is summed from zero, a group of up to 64
      // columns at a time, and added to the rescaled O in one FMA: summed
      // straight into O, each product would be cut to O's magnitude, over
      // every key of the row
#pragma unroll
      for (int jc0 = 0; jc0 < NDC; jc0 += GDC) {
        float pv[2 * GDC][4];
#pragma unroll
        for (int j = 0; j < 2 * GDC; ++j) pv[j][0] = pv[j][1] = pv[j][2] = pv[j][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < NKT; ++kk) {
          const float pf[4] = {s[kk][0], s[kk][2], s[kk][1], s[kk][3]};
          uint32_t ph[4], pl[4];
          split_frag(pf, ph, pl);
          const float* v0 = vs + (kk * 8 + 2 * t) * STR + 2 * g;
#pragma unroll
          for (int jj = 0; jj < GDC; ++jj) {
            const int jc = jc0 + jj;
            if (jc < NDC) {
              const float2 x0 = *reinterpret_cast<const float2*>(v0 + jc * 16);
              const float2 x1 = *reinterpret_cast<const float2*>(v0 + STR + jc * 16);
              mma_3xtf32(pv[2 * jj], pv[2 * jj], ph, pl, x0.x, x1.x);
              mma_3xtf32(pv[2 * jj + 1], pv[2 * jj + 1], ph, pl, x0.y, x1.y);
            }
          }
        }
#pragma unroll
        for (int jj = 0; jj < 2 * GDC; ++jj) {
          const int j = 2 * jc0 + jj;
          if (j < 2 * NDC) {
            o[j][0] = fmaf(o[j][0], alpha0, pv[jj][0]);
            o[j][1] = fmaf(o[j][1], alpha0, pv[jj][1]);
            o[j][2] = fmaf(o[j][2], alpha1, pv[jj][2]);
            o[j][3] = fmaf(o[j][3], alpha1, pv[jj][3]);
          }
        }
      }
    }
    __syncthreads();  // this stage is refilled two tiles on
  }

#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
  }
  const float inv0 = 1.f / (l0 == 0.f ? 1.f : l0), inv1 = 1.f / (l1 == 0.f ? 1.f : l1);
#pragma unroll
  for (int jc = 0; jc < NDC; ++jc) {
    const int c = jc * 16 + t * 4;
    if (c >= D) continue;
    const float* a = o[2 * jc];
    const float* e = o[2 * jc + 1];
    if (row0 < p.Sq)
      *reinterpret_cast<float4*>(ob + (long long)row0 * p.o_s + c) =
          make_float4(a[0] * inv0, e[0] * inv0, a[1] * inv0, e[1] * inv0);
    if (row1 < p.Sq)
      *reinterpret_cast<float4*>(ob + (long long)row1 * p.o_s + c) =
          make_float4(a[2] * inv1, e[2] * inv1, a[3] * inv1, e[3] * inv1);
  }
}

// -- bf16, D = 64 or 128, on warpgroup tensor cores (wgmma) --------------------

constexpr int kWgConsumers = 256;   // two consumer warpgroups of 64 query rows
constexpr int kWgThreads = 128 + kWgConsumers;  // and a producer warpgroup
constexpr int kWgBQ = 128;          // query rows per work item
constexpr int kWgBK = 128;          // keys per K/V tile

// Shared memory of the instance for head width D.  A 128-byte row is one
// swizzle atom, so every Q, K and V tile is stored as D / 64 column halves
// of rows x 128 bytes, each a 64-wide tile under the 128-byte swizzle.
template <int D>
struct WgShape {
  static_assert(D == 64 || D == 128, "the wgmma path takes D = 64 or 128");
  static constexpr int kHalves = D / 64;
  // K/V stages in the ring: three at D = 64; two at D = 128, where the two
  // Q buffers and a third stage would pass the 227 KB a block may use
  static constexpr int kStages = D == 64 ? 3 : 2;
  // K and V of a stage on barriers of their own (K freed once S is done, V
  // once P V is), or both on one pair; two stages need the split, so that K
  // of the next tile loads while this tile's softmax and P V run
  static constexpr bool kSplitKV = kStages == 2;
  // At D = 128 the two consumer warpgroups take turns to issue their
  // products, and O is written through each warpgroup's rows of its Q
  // buffer and out by TMA (each measured faster there: PERF_HISTORY.md);
  // D = 64 takes neither and stores straight from registers.
  static constexpr bool kPingPong = D == 128;
  static constexpr bool kTmaStore = D == 128;
  static constexpr int kHalfQ = kWgBQ * 128;   // bytes of one column half of a tile
  static constexpr int kHalfKV = kWgBK * 128;
  static constexpr int kQTile = kHalves * kHalfQ;
  static constexpr int kKVTile = kHalves * kHalfKV;  // a K or a V tile
  // barriers: full and empty per stage (for K and V apart with kSplitKV),
  // full and empty per Q buffer
  static constexpr int kBars = (kSplitKV ? 4 : 2) * kStages + 4;
  // two Q buffers, the K/V ring, the barriers, alignment slack
  static constexpr int kSmem = 2 * kQTile + 2 * kStages * kKVTile + 8 * kBars + 1024;
  static_assert(kSmem <= 232448, "over the 227 KB of shared memory a block may use");
};

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// waits until at most N committed groups of this warpgroup are pending
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// pins accumulator registers in place around the asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D (64 x 128, f32) = A (64 x 16, shared) . B (128 x 16, shared, K-major)^T, + D when acc
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// D (64 x 64, f32) += A (64 x 16, registers) . B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, f32) += A (64 x 16, registers) . B (16 x 128, shared, MN-major),
// columns 0-63 of D in d0 and 64-127 in d1; B's two 64-wide column blocks
// lie the descriptor's leading byte offset apart
__device__ __forceinline__ void wgmma_rs_n128(float (&d0)[32], float (&d1)[32],
                                              const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d0[0]), "+f"(d0[1]), "+f"(d0[2]), "+f"(d0[3]), "+f"(d0[4]), "+f"(d0[5]), "+f"(d0[6]), "+f"(d0[7]), "+f"(d0[8]), "+f"(d0[9]), "+f"(d0[10]), "+f"(d0[11]), "+f"(d0[12]), "+f"(d0[13]), "+f"(d0[14]), "+f"(d0[15]), "+f"(d0[16]), "+f"(d0[17]), "+f"(d0[18]), "+f"(d0[19]), "+f"(d0[20]), "+f"(d0[21]), "+f"(d0[22]), "+f"(d0[23]), "+f"(d0[24]), "+f"(d0[25]), "+f"(d0[26]), "+f"(d0[27]), "+f"(d0[28]), "+f"(d0[29]), "+f"(d0[30]), "+f"(d0[31]),
        "+f"(d1[0]), "+f"(d1[1]), "+f"(d1[2]), "+f"(d1[3]), "+f"(d1[4]), "+f"(d1[5]), "+f"(d1[6]), "+f"(d1[7]), "+f"(d1[8]), "+f"(d1[9]), "+f"(d1[10]), "+f"(d1[11]), "+f"(d1[12]), "+f"(d1[13]), "+f"(d1[14]), "+f"(d1[15]), "+f"(d1[16]), "+f"(d1[17]), "+f"(d1[18]), "+f"(d1[19]), "+f"(d1[20]), "+f"(d1[21]), "+f"(d1[22]), "+f"(d1[23]), "+f"(d1[24]), "+f"(d1[25]), "+f"(d1[26]), "+f"(d1[27]), "+f"(d1[28]), "+f"(d1[29]), "+f"(d1[30]), "+f"(d1[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// -- mbarriers, TMA and register reallocation --

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// one arrival that also expects `bytes` more from asynchronous copies
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Waits for the phase of the given parity to complete.  A wait that has
// not ended after 2^24 polls is a broken pipeline: trap rather than hang.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  for (int n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (n == (1 << 24)) __trap();
  }
}
// a box of a (D, S, H, B) tensor map at (c, s, h, b) into shared memory,
// completing on `bar`; rows past S are filled with zeros
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c,
                                         int s, int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(s), "r"(h), "r"(b), "r"(bar)
      : "memory");
}
// one tile of `rows` x D at (s, h, b): its D / 64 column halves, one box each,
// one after the other in shared memory, all completing on `bar`
template <int D>
__device__ __forceinline__ void tma_load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                              int rows, int s, int h, int b) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c) tma_load(dst + c * rows * 128, map, bar, 64 * c, s, h, b);
}
// named barrier `id` (1-15) of `n` threads: wait for it, or arrive without waiting
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
// a box of a (D, S, H, B) tensor map at (c, s, h, b) from shared memory, in
// this thread's bulk group; rows past S are not written
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c, int s,
                                          int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%1, %2, %3, %4}], [%5];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(c), "r"(s), "r"(h), "r"(b), "r"(src)
      : "memory");
}
__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Work item `half` (0 or 1) of pair w: q tiles nq-1-i and i of one (b, h),
// so that every pair holds the same number of causal K/V tiles.  False when
// the pair has a single tile (nq odd) and `half` is its second.
__device__ __forceinline__ bool wg_item(const Params& p, int nq, int w, int half, int& q0, int& h,
                                        int& b) {
  const int pph = (nq + 1) / 2, bh = w / pph, i = w - bh * pph;
  const int qt = half ? i : nq - 1 - i;
  if (half && qt == nq - 1 - i) return false;
  q0 = qt * kWgBQ;
  h = bh % p.Hq;
  b = bh / p.Hq;
  return true;
}

__device__ __forceinline__ int wg_tiles(const Params& p, int q0) {
  const int kend = p.causal ? min(p.Sk, q0 + kWgBQ) : p.Sk;
  return (kend + kWgBK - 1) / kWgBK;
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1) flash_wgmma_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap o_map,
    __nv_bfloat16* __restrict__ out, Params p) {
  using S = WgShape<D>;
  constexpr int NH = S::kHalves, NST = S::kStages;
  extern __shared__ uint8_t wg_smem_raw[];
  const uint32_t raw = smem_addr(wg_smem_raw);
  uint8_t* smem = wg_smem_raw + (((raw + 1023u) & ~1023u) - raw);
  // [Q buffer 0, 1][stage 0: K, V]...[stage S-1: K, V][barriers]
  const uint32_t q_addr = smem_addr(smem), ring = q_addr + 2 * S::kQTile;
  // [K full][K empty] per stage, then with kSplitKV [V full][V empty] (else
  // V shares K's), [Q full][Q empty] per buffer
  const uint32_t k_full0 = ring + 2 * NST * S::kKVTile, k_empty0 = k_full0 + 8 * NST;
  const uint32_t v_full0 = S::kSplitKV ? k_empty0 + 8 * NST : k_full0;
  const uint32_t v_empty0 = S::kSplitKV ? v_full0 + 8 * NST : k_empty0;
  const uint32_t q_full0 = k_full0 + 8 * (S::kBars - 4), q_empty0 = q_full0 + 16;

  const int tid = threadIdx.x, wg = tid / 128;
  const int nq = (p.Sq + kWgBQ - 1) / kWgBQ;
  const int npairs = p.B * p.Hq * ((nq + 1) / 2);

  if (tid == 0) {
    for (int st = 0; st < NST; ++st) {
      mbar_init(k_full0 + 8 * st, 1);
      mbar_init(k_empty0 + 8 * st, kWgConsumers / 32);  // one arrival per consumer warp
      if (S::kSplitKV) {
        mbar_init(v_full0 + 8 * st, 1);
        mbar_init(v_empty0 + 8 * st, kWgConsumers / 32);
      }
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(q_full0 + 8 * i, 1);
      mbar_init(q_empty0 + 8 * i, kWgConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // Producer warpgroup: one thread keeps the TMA loads in flight, the
    // next item's Q and first K/V tiles while the consumers finish this one.
    setmaxnreg_dec<24>();
    if (tid == 0) {
      int n = 0, gt = 0;  // items and K/V tiles loaded so far
      // With kSplitKV the V tile of K/V tile vt (keys from vs, KV head vhk,
      // batch vb) waits until K of the next tile is loaded: S needs K first,
      // and K's slot frees a product earlier than V's.
      int vt = -1, vs = 0, vhk = 0, vb = 0;
      auto load_v = [&]() {
        if (vt < 0) return;
        const int st = vt % NST;
        mbar_wait(v_empty0 + 8 * st, ((vt / NST) & 1) ^ 1);
        mbar_expect_tx(v_full0 + 8 * st, S::kKVTile);
        tma_load_tile<D>(ring + (2 * st + 1) * S::kKVTile, &v_map, v_full0 + 8 * st, kWgBK, vs,
                         vhk, vb);
        vt = -1;
      };
      for (int w = blockIdx.x; w < npairs; w += gridDim.x)
        for (int half = 0; half < 2; ++half) {
          int q0, h, b;
          if (!wg_item(p, nq, w, half, q0, h, b)) continue;
          const int hk = h / (p.Hq / p.Hkv), qb = n & 1;
          mbar_wait(q_empty0 + 8 * qb, ((n >> 1) & 1) ^ 1);  // the first round passes
          mbar_expect_tx(q_full0 + 8 * qb, S::kQTile);
          tma_load_tile<D>(q_addr + qb * S::kQTile, &q_map, q_full0 + 8 * qb, kWgBQ, q0, h, b);
          const int ntiles = wg_tiles(p, q0);
          for (int it = 0; it < ntiles; ++it, ++gt) {
            const int st = gt % NST;
            const uint32_t k_addr = ring + 2 * st * S::kKVTile;
            mbar_wait(k_empty0 + 8 * st, ((gt / NST) & 1) ^ 1);
            if constexpr (S::kSplitKV) {
              mbar_expect_tx(k_full0 + 8 * st, S::kKVTile);
              tma_load_tile<D>(k_addr, &k_map, k_full0 + 8 * st, kWgBK, it * kWgBK, hk, b);
              load_v();
              vt = gt, vs = it * kWgBK, vhk = hk, vb = b;
            } else {
              mbar_expect_tx(k_full0 + 8 * st, 2 * S::kKVTile);
              tma_load_tile<D>(k_addr, &k_map, k_full0 + 8 * st, kWgBK, it * kWgBK, hk, b);
              tma_load_tile<D>(k_addr + S::kKVTile, &v_map, k_full0 + 8 * st, kWgBK, it * kWgBK,
                               hk, b);
            }
          }
          ++n;
        }
      load_v();
    }
    return;
  }
  setmaxnreg_inc<240>();

  const int cw = wg - 1, warp = (tid % 128) / 32, lane = tid % 32;  // consumer warpgroup cw
  const int g = lane >> 2, t = lane & 3;
  const float scale2 = p.scale * 1.4426950408889634f;  // scale * log2(e)

  // score registers, 8-key steps and 16-key steps of a K/V tile
  constexpr int NS = kWgBK / 2, NJ = kWgBK / 8, NK = kWgBK / 16;
  float o[NH][32], s[NS];  // O in 64-wide column halves
  uint32_t pa[NK][4];      // P in bf16, the A operand of O += P V
#pragma unroll
  for (int i = 0; i < NS; ++i) s[i] = 0.f;
  float m0, m1, l0, l1;       // running max and (this thread's) sum of rows g and g + 8, base 2
  int wrow, row0, row1;       // this warp's first row, this thread's two rows
  int klim0, klim1;           // keys visible to rows row0 and row1: those before these
  uint32_t qw_addr;           // this warpgroup's 64 rows of Q (in the first column half)

  auto fence_o = [&]() {
#pragma unroll
    for (int c = 0; c < NH; ++c) fence_regs(o[c]);
  };
  // With kPingPong the two consumer warpgroups take turns to issue their
  // products (named barrier 1 + cw is warpgroup cw's turn), so that one's
  // S and P V run on the tensor cores while the other's softmax runs.
  auto my_turn = [&]() {
    if constexpr (S::kPingPong) named_sync(1 + cw, kWgConsumers);
  };
  auto pass_turn = [&]() {
    if constexpr (S::kPingPong) named_arrive(2 - cw, kWgConsumers);
  };
  if constexpr (S::kPingPong)
    if (cw == 0) named_arrive(1, kWgConsumers);  // warpgroup 0 takes the first turn
  // S = Q K^T of the tile in stage st: 4 k-steps of 16 over each column
  // half, each 32 bytes on inside the swizzled rows (started, not waited for)
  auto start_s = [&](int st) {
    const uint32_t k_addr = ring + 2 * st * S::kKVTile;
#pragma unroll
    for (int kk = 0; kk < 4 * NH; ++kk)
      wgmma_ss_n128(s, wg_desc(qw_addr + (kk / 4) * S::kHalfQ + 32 * (kk % 4), 16, 1024),
                    wg_desc(k_addr + (kk / 4) * S::kHalfKV + 32 * (kk % 4), 16, 1024), kk);
    wg_commit();
  };
  // O += P V of the tile in stage st: eight k-steps of 16 keys, each one
  // product over all of D (at D = 128 the two column halves, an atom stride
  // apart, as one m64n128k16); V is read MN-major (transposed), 8 keys of
  // 128 bytes per 1024-byte swizzle period
  auto start_pv = [&](int st) {
    const uint32_t v_addr = ring + (2 * st + 1) * S::kKVTile;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      if constexpr (NH == 2)
        wgmma_rs_n128(o[0], o[1], pa[kk], wg_desc(v_addr + kk * 2048, S::kHalfKV, 1024));
      else
        wgmma_rs_n64(o[0], pa[kk], wg_desc(v_addr + kk * 2048, 16, 1024));
    }
    wg_commit();
  };
  // this warp is done with the buffer of barrier `bar`
  auto release = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  // with kSplitKV V has its own barriers; else it came, and goes, with K
  auto wait_v = [&](int st, int ph) {
    if constexpr (S::kSplitKV) mbar_wait(v_full0 + 8 * st, ph);
  };
  auto release_k = [&](int st) {
    if constexpr (S::kSplitKV) release(k_empty0 + 8 * st);
  };
  // Online softmax of the scores of keys k0.. in s, in place: s becomes the
  // weights; sets the factors that rescale O (rows g and g + 8).  s[4j + e]
  // is row g, key k0 + 8j + 2t + e; s[4j + 2 + e] row g + 8.  Tiles that
  // need no mask take a copy of the code without it (`masked` is a
  // compile-time constant), and the max and the sum run as four
  // independent chains per row.  With a positive scale (`pos`) the max is
  // taken over the raw scores and the scale folded into the exponent's
  // fused multiply-add.
  auto softmax = [&](auto masked, auto pos, int k0, float& alpha0, float& alpha1) {
    float mx0[4], mx1[4], sm0[4], sm1[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) mx0[c] = mx1[c] = kNegInf, sm0[c] = sm1[c] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x0 = s[4 * j + e], x1 = s[4 * j + 2 + e];
        if constexpr (!decltype(pos)::value) x0 *= scale2, x1 *= scale2;
        if constexpr (decltype(masked)::value) {
          const int kpos = k0 + j * 8 + t * 2 + e;
          if (kpos >= klim0) x0 = kNegInf;
          if (kpos >= klim1) x1 = kNegInf;
        }
        s[4 * j + e] = x0;
        s[4 * j + 2 + e] = x1;
        mx0[j & 3] = fmaxf(mx0[j & 3], x0);
        mx1[j & 3] = fmaxf(mx1[j & 3], x1);
      }
    float r0 = fmaxf(fmaxf(mx0[0], mx0[1]), fmaxf(mx0[2], mx0[3]));
    float r1 = fmaxf(fmaxf(mx1[0], mx1[1]), fmaxf(mx1[2], mx1[3]));
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      r0 = fmaxf(r0, __shfl_xor_sync(0xffffffffu, r0, o_));
      r1 = fmaxf(r1, __shfl_xor_sync(0xffffffffu, r1, o_));
    }
    if constexpr (decltype(pos)::value) {
      r0 = r0 == kNegInf ? kNegInf : r0 * scale2;
      r1 = r1 == kNegInf ? kNegInf : r1 * scale2;
    }
    const float mn0 = fmaxf(m0, r0), mn1 = fmaxf(m1, r1);
    // a row with nothing visible yet (mn = kNegInf) takes its weights
    // against 0, so its masked keys weigh exp2(kNegInf) = 0
    const float ms0 = mn0 == kNegInf ? 0.f : mn0, ms1 = mn1 == kNegInf ? 0.f : mn1;
    alpha0 = exp2_approx(m0 - mn0);
    alpha1 = exp2_approx(m1 - mn1);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if constexpr (decltype(pos)::value) {
          s[4 * j + e] = exp2_approx(fmaf(s[4 * j + e], scale2, -ms0));
          s[4 * j + 2 + e] = exp2_approx(fmaf(s[4 * j + 2 + e], scale2, -ms1));
        } else {
          s[4 * j + e] = exp2_approx(s[4 * j + e] - ms0);
          s[4 * j + 2 + e] = exp2_approx(s[4 * j + 2 + e] - ms1);
        }
        sm0[j & 3] += s[4 * j + e];
        sm1[j & 3] += s[4 * j + 2 + e];
      }
    // this thread's share of the row sums: the four threads of a row add
    // theirs once, after the last tile
    l0 = alpha0 * l0 + ((sm0[0] + sm0[1]) + (sm0[2] + sm0[3]));
    l1 = alpha1 * l1 + ((sm1[0] + sm1[1]) + (sm1[2] + sm1[3]));
    m0 = mn0;
    m1 = mn1;
  };
  // only tiles that cross the causal diagonal or the end of the keys are masked
  auto softmax_tile = [&](int k0, float& alpha0, float& alpha1) {
    const bool masked = k0 + kWgBK > p.Sk || (p.causal && k0 + kWgBK - 1 > wrow);
    if (scale2 > 0.f) {
      if (masked) softmax(std::true_type{}, std::true_type{}, k0, alpha0, alpha1);
      else softmax(std::false_type{}, std::true_type{}, k0, alpha0, alpha1);
    } else {
      if (masked) softmax(std::true_type{}, std::false_type{}, k0, alpha0, alpha1);
      else softmax(std::false_type{}, std::false_type{}, k0, alpha0, alpha1);
    }
  };
  // the score tiles 2kk and 2kk+1 (mma.sync's C layout) are the A fragment
  // of keys 16kk..16kk+15
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  };

  int n = 0, gt = 0;  // items and K/V tiles consumed so far
  for (int w = blockIdx.x; w < npairs; w += gridDim.x)
    for (int half = 0; half < 2; ++half) {
      int q0, h, b;
      if (!wg_item(p, nq, w, half, q0, h, b)) continue;
      const int qb = n & 1, ntiles = wg_tiles(p, q0);
      wrow = q0 + cw * 64 + warp * 16;
      row0 = wrow + g;
      row1 = row0 + 8;
      klim0 = p.causal ? min(p.Sk, row0 + 1) : p.Sk;
      klim1 = p.causal ? min(p.Sk, row1 + 1) : p.Sk;
      qw_addr = q_addr + qb * S::kQTile + cw * 64 * 128;
      m0 = m1 = kNegInf;
      l0 = l1 = 0.f;
#pragma unroll
      for (int c = 0; c < NH; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
      mbar_wait(q_full0 + 8 * qb, (n >> 1) & 1);

      // The scores of tile it are computed, and their softmax runs, while
      // the P V product of tile it-1 is on the tensor cores: S and P V are
      // two commit groups, and waiting for all but one completes S alone.
      if (ntiles > 0) {
        float alpha0, alpha1;
        int st = gt % NST, ph = (gt / NST) & 1;
        mbar_wait(k_full0 + 8 * st, ph);
        my_turn();
        wg_fence();
        start_s(st);
        pass_turn();
        wg_wait<0>();
        fence_regs(s);
        release_k(st);  // K of stage st may be refilled
        softmax_tile(0, alpha0, alpha1);
        pack_p();
        for (int it = 1; it < ntiles; ++it) {
          const int prev = st, prev_ph = ph;
          st = (gt + it) % NST;
          ph = ((gt + it) / NST) & 1;
          mbar_wait(k_full0 + 8 * st, ph);
          wait_v(prev, prev_ph);
          fence_o();
          my_turn();
          wg_fence();
          start_s(st);
          start_pv(prev);
          pass_turn();
          wg_wait<1>();
          fence_regs(s);
          release_k(st);
          softmax_tile(it * kWgBK, alpha0, alpha1);
          wg_wait<0>();
          fence_o();
          fence_regs(s);
          release(v_empty0 + 8 * prev);  // V (and K) of stage prev may be refilled
#pragma unroll
          for (int c = 0; c < NH; ++c)
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              o[c][4 * j] *= alpha0;
              o[c][4 * j + 1] *= alpha0;
              o[c][4 * j + 2] *= alpha1;
              o[c][4 * j + 3] *= alpha1;
            }
          pack_p();
        }
        wait_v(st, ph);
        fence_o();
        my_turn();
        wg_fence();
        start_pv(st);
        pass_turn();
        wg_wait<0>();
        fence_o();
        release(v_empty0 + 8 * st);
      }
      if constexpr (!S::kTmaStore) release(q_empty0 + 8 * qb);  // Q buffer qb may be refilled
      ++n;
      gt += ntiles;

      __nv_bfloat16* ob = out + b * p.o_b + h * p.o_h;
#pragma unroll
      for (int o_ = 1; o_ <= 2; o_ <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
        l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
      }
      const float inv0 = 1.f / (l0 == 0.f ? 1.f : l0), inv1 = 1.f / (l1 == 0.f ? 1.f : l1);
      if constexpr (S::kTmaStore) {
        // O goes into this warpgroup's rows of Q buffer qb (its last S is
        // done) in the Q tile's swizzled layout (16-byte chunk j of row r at
        // j ^ (r & 7); rows g and g + 8 of this warp both have r & 7 = g),
        // then out by TMA, which writes no row past Sq
        const uint32_t row_addr = qw_addr + (warp * 16 + g) * 128 + t * 4;
#pragma unroll
        for (int c = 0; c < NH; ++c)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const uint32_t at = row_addr + c * S::kHalfQ + ((j ^ g) << 4);
            st_shared(at, pack_bf16(o[c][4 * j] * inv0, o[c][4 * j + 1] * inv0));
            st_shared(at + 8 * 128, pack_bf16(o[c][4 * j + 2] * inv1, o[c][4 * j + 3] * inv1));
          }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to TMA
        named_sync(3 + cw, 128);  // this warpgroup's rows are written
        if (warp == 0 && lane == 0) {
#pragma unroll
          for (int c = 0; c < NH; ++c)
            tma_store(&o_map, qw_addr + c * S::kHalfQ, 64 * c, q0 + cw * 64, h, b);
          asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
          // the buffer is read out before it is released
          asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        }
        release(q_empty0 + 8 * qb);  // Q buffer qb may be refilled
      } else {
#pragma unroll
        for (int c = 0; c < NH; ++c)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = c * 64 + j * 8 + t * 2;
            if (row0 < p.Sq)
              *reinterpret_cast<uint32_t*>(ob + row0 * p.o_s + col) =
                  pack_bf16(o[c][4 * j] * inv0, o[c][4 * j + 1] * inv0);
            if (row1 < p.Sq)
              *reinterpret_cast<uint32_t*>(ob + row1 * p.o_s + col) =
                  pack_bf16(o[c][4 * j + 2] * inv1, o[c][4 * j + 3] * inv1);
          }
      }
    }
}

// -- launch --------------------------------------------------------------------

template <typename T, int MAXC>
int launch_simt(const T* q, const T* k, const T* v, T* out, const Params& p, cudaStream_t st,
                dim3 grid) {
  const long long smem = sizeof(float) * simt_smem_floats(p.D);
  int device = 0, max_smem = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return (int)e;
  if (smem > max_smem) return (int)cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(flash_simt_kernel<T, MAXC>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  flash_simt_kernel<T, MAXC><<<grid, kSimtThreads, (int)smem, st>>>(q, k, v, out, p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_simt(const T* q, const T* k, const T* v, T* out, const Params& p, cudaStream_t st,
                  dim3 grid) {
  const int cols = (p.D + 15) / 16;
  if (cols <= 2) return launch_simt<T, 2>(q, k, v, out, p, st, grid);
  if (cols <= 4) return launch_simt<T, 4>(q, k, v, out, p, st, grid);
  if (cols <= 8) return launch_simt<T, 8>(q, k, v, out, p, st, grid);
  return launch_simt<T, 16>(q, k, v, out, p, st, grid);  // D <= 256
}

template <int D>
int launch_mma(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
               __nv_bfloat16* out, const Params& p, cudaStream_t st, dim3 grid) {
  constexpr int smem = mma_smem_bytes<D>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  flash_mma_kernel<D><<<grid, kMmaThreads, smem, st>>>(q, k, v, out, p);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_tf32x3(const float* q, const float* k, const float* v, float* out, const Params& p,
                  cudaStream_t st, dim3 grid) {
  constexpr int smem = TfShape<DP>::kSmem;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_tf32x3_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  flash_tf32x3_kernel<DP><<<grid, kTfThreads, smem, st>>>(q, k, v, out, p);
  return (int)cudaGetLastError();
}

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime so
// that the library needs no link against libcuda
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault,
                                         &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(ptr);
  }
  return fn;
}

// The (D, S, H, B) map of a bf16 tensor with D contiguous and element
// strides (sb, sh, ss), read in boxes of 64 x rows (one 128-byte swizzle atom
// wide: a tile of D = 128 takes two, at columns 0 and 64) under the 128-byte
// swizzle, zeros past S.  A dimension of size 1 takes a packed stride: its
// own is never used and may be anything.
int encode_map(CUtensorMap* map, const void* ptr, int D, int rows, int S, int H, int B,
               long long sb, long long sh, long long ss) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (!encode) return (int)cudaErrorNotSupported;
  S = max(S, 1);  // no keys: the map is never read
  const cuuint64_t s_b = S == 1 ? 2 * D : ss * 2;
  const cuuint64_t h_b = H == 1 ? s_b * S : sh * 2;
  const cuuint64_t b_b = B == 1 ? h_b * H : sb * 2;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {s_b, h_b, b_b};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1}, unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int D>
int launch_wgmma(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                 __nv_bfloat16* out, const Params& p, cudaStream_t st) {
  constexpr int smem = WgShape<D>::kSmem;
  CUtensorMap q_map, k_map, v_map, o_map = {};
  int e = encode_map(&q_map, q, D, kWgBQ, p.Sq, p.Hq, p.B, p.q_b, p.q_h, p.q_s);
  if (!e) e = encode_map(&k_map, k, D, kWgBK, p.Sk, p.Hkv, p.B, p.k_b, p.k_h, p.k_s);
  if (!e) e = encode_map(&v_map, v, D, kWgBK, p.Sk, p.Hkv, p.B, p.v_b, p.v_h, p.v_s);
  // the output in boxes of one consumer warpgroup's 64 rows
  if (!e && WgShape<D>::kTmaStore)
    e = encode_map(&o_map, out, D, 64, p.Sq, p.Hq, p.B, p.o_b, p.o_h, p.o_s);
  if (e) return e;
  e = (int)cudaFuncSetAttribute(flash_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem);
  if (e) return e;
  // persistent: at most one block per SM, each walking its pairs of q tiles
  int device = 0, sms = 0;
  e = (int)cudaGetDevice(&device);
  if (!e) e = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e) return e;
  const long long nq = (p.Sq + kWgBQ - 1) / kWgBQ;
  const long long npairs = (long long)p.B * p.Hq * ((nq + 1) / 2);
  if (npairs > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int grid = (int)(npairs < sms ? npairs : sms);
  flash_wgmma_kernel<D><<<grid, kWgThreads, smem, st>>>(q_map, k_map, v_map, o_map, out, p);
  return (int)cudaGetLastError();
}

// The tensor-core path loads q and stores the output as 32-bit bf16 pairs and
// copies K and V rows in 16-byte chunks.
bool aligned_to(const void* ptr, int bytes, long long sb, long long sh, long long ss) {
  const int elems = bytes / 2;
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0 && sb % elems == 0 && sh % elems == 0 &&
         ss % elems == 0;
}

// The wgmma path reads q, k and v through TMA: a 16-byte aligned base, and
// for each of batch, head and seq of size > 1 a positive stride of a multiple
// of 16 bytes.  The output it writes as 32-bit pairs, held to the same rule.
bool tma_ok(const void* ptr, int B, int H, int S, long long sb, long long sh, long long ss) {
  auto ok = [](int n, long long s) { return n == 1 || (s > 0 && s % 8 == 0); };
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && ok(B, sb) && ok(H, sh) && ok(S, ss);
}

// The tf32x3 path copies K and V rows in 16-byte chunks and stores the output
// in 16-byte pieces: a 16-byte aligned base and, for each of batch, head and
// seq of size > 1, a stride of a multiple of 4 elements.  (q it reads a float
// at a time.)
bool rows16_ok(const void* ptr, int B, int H, int S, long long sb, long long sh, long long ss) {
  auto ok = [](int n, long long s) { return n == 1 || s % 4 == 0; };
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && ok(B, sb) && ok(H, sh) && ok(S, ss);
}

// dims: B, Hq, Hkv, Sq, Sk, D; strides: q, k, v, out each (batch, head, seq).
// Returns 3 when the tf32x3 path ran, 2 for the wgmma path, 1 for the
// mma.sync path, 0 for the CUDA-core path, or minus a cudaError_t.
template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, const long long* dims,
           const long long* strides, float scale, int causal, void* stream) {
  Params p;
  p.B = (int)dims[0], p.Hq = (int)dims[1], p.Hkv = (int)dims[2];
  p.Sq = (int)dims[3], p.Sk = (int)dims[4], p.D = (int)dims[5];
  p.causal = causal;
  p.scale = scale;
  long long* s[12] = {&p.q_b, &p.q_h, &p.q_s, &p.k_b, &p.k_h, &p.k_s,
                      &p.v_b, &p.v_h, &p.v_s, &p.o_b, &p.o_h, &p.o_s};
  for (int i = 0; i < 12; ++i) *s[i] = strides[i];
  if (p.B <= 0 || p.Hq <= 0 || p.Sq <= 0) return 0;
  if (p.Hkv <= 0 || p.Hq % p.Hkv || p.D <= 0 || p.D > 256 || p.Sk < 0)
    return -(int)cudaErrorInvalidValue;
  const dim3 grid((p.Sq + kBQ - 1) / kBQ, p.Hq, p.B);
  if (grid.y > 65535 || grid.z > 65535) return -(int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  int status = 0, path = 0;
  if constexpr (sizeof(T) == 2) {
    const bool aligned = aligned_to(q, 4, p.q_b, p.q_h, p.q_s) &&
                         aligned_to(k, 16, p.k_b, p.k_h, p.k_s) &&
                         aligned_to(v, 16, p.v_b, p.v_h, p.v_s) &&
                         aligned_to(out, 4, p.o_b, p.o_h, p.o_s);
    const bool tma = tma_ok(q, p.B, p.Hq, p.Sq, p.q_b, p.q_h, p.q_s) &&
                     tma_ok(k, p.B, p.Hkv, p.Sk, p.k_b, p.k_h, p.k_s) &&
                     tma_ok(v, p.B, p.Hkv, p.Sk, p.v_b, p.v_h, p.v_s) &&
                     tma_ok(out, p.B, p.Hq, p.Sq, p.o_b, p.o_h, p.o_s);
    if (tma && (p.D == 64 || p.D == 128)) {
      path = 2;
      status = p.D == 64 ? launch_wgmma<64>(qt, kt, vt, ot, p, st)
                         : launch_wgmma<128>(qt, kt, vt, ot, p, st);
    } else if (aligned && p.D % 16 == 0 && p.D <= 128) {
      path = 1;
      switch (p.D / 16) {
        case 1: status = launch_mma<16>(qt, kt, vt, ot, p, st, grid); break;
        case 2: status = launch_mma<32>(qt, kt, vt, ot, p, st, grid); break;
        case 3: status = launch_mma<48>(qt, kt, vt, ot, p, st, grid); break;
        case 4: status = launch_mma<64>(qt, kt, vt, ot, p, st, grid); break;
        case 5: status = launch_mma<80>(qt, kt, vt, ot, p, st, grid); break;
        case 6: status = launch_mma<96>(qt, kt, vt, ot, p, st, grid); break;
        case 7: status = launch_mma<112>(qt, kt, vt, ot, p, st, grid); break;
        default: status = launch_mma<128>(qt, kt, vt, ot, p, st, grid); break;
      }
    }
  }
  if constexpr (sizeof(T) == 4) {
    const bool rows16 = rows16_ok(k, p.B, p.Hkv, p.Sk, p.k_b, p.k_h, p.k_s) &&
                        rows16_ok(v, p.B, p.Hkv, p.Sk, p.v_b, p.v_h, p.v_s) &&
                        rows16_ok(out, p.B, p.Hq, p.Sq, p.o_b, p.o_h, p.o_s);
    if (rows16 && p.D % 8 == 0 && p.D <= 128) {
      path = 3;
      switch ((p.D + 15) / 16) {
        case 1: status = launch_tf32x3<16>(qt, kt, vt, ot, p, st, grid); break;
        case 2: status = launch_tf32x3<32>(qt, kt, vt, ot, p, st, grid); break;
        case 3: status = launch_tf32x3<48>(qt, kt, vt, ot, p, st, grid); break;
        case 4: status = launch_tf32x3<64>(qt, kt, vt, ot, p, st, grid); break;
        case 5: status = launch_tf32x3<80>(qt, kt, vt, ot, p, st, grid); break;
        case 6: status = launch_tf32x3<96>(qt, kt, vt, ot, p, st, grid); break;
        case 7: status = launch_tf32x3<112>(qt, kt, vt, ot, p, st, grid); break;
        default: status = launch_tf32x3<128>(qt, kt, vt, ot, p, st, grid); break;
      }
    }
  }
  if (!path) status = dispatch_simt<T>(qt, kt, vt, ot, p, st, grid);
  return status ? -status : path;
}

}  // namespace

extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* out,
                                   const long long* dims, const long long* strides,
                                   float scale, int causal, void* stream) {
  return launch<float>(q, k, v, out, dims, strides, scale, causal, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                    const long long* dims, const long long* strides,
                                    float scale, int causal, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, dims, strides, scale, causal, stream);
}

extern "C" const char* cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
