// Decode-shaped attention on Hopper (sm_90a): the query heads of each
// (sequence, KV head) against the sequence's pages, on tensor cores, in one
// launch.  The paged kernel's grouped-query path (paged_attention.cu,
// "group"); that file's header names the TPU kernel it replaces.
//
// The work is bytes-bound: each key's K and V row is read once, and every
// query row of the group uses it.  The design is flash-decoding with the
// combine done inside the launch, through distributed shared memory:
//
//  * Rows and splits.  A row is one (b, KV head) with its R query rows (the
//    group; padded to m-tiles of 16); its keys are cut into splits of T = 64
//    keys.  Each row gets a cluster of C blocks, and block j of it takes
//    splits j, j + C, ... of the row's length (from seq_lens, on the device;
//    a block past the length takes none).  C is 8, 4 or 2, the largest
//    whose B x Hkv clusters the card holds at once
//    (cudaOccupancyMaxActiveClusters), so the whole call is one wave.  The
//    grid comes from shapes alone, so a call can be captured in a CUDA
//    graph.
//  * Loads.  A split's K and V rows (and, once, the row's Q rows) come into
//    shared memory by cp.async, 16 bytes a thread (any page size; rows
//    padded by 16 bytes against bank conflicts): two splits in flight a
//    block where it takes more than one, each stage refilled as soon as its
//    split is done.  A split's table entries are all read before its first
//    copy is issued, and without waiting for the length, so the lengths, the
//    table and the pages cost two round trips to memory, not one a row.  fp8 e4m3 pages are widened to bf16 in shared memory once a
//    split (exactly: every e4m3 value is a bf16 value).
//  * Scores.  S = Q K^T on mma.sync m16n8k16 (bf16 in, f32 out; bf16
//    products are exact in f32): each warp takes T/4 of the split's keys for
//    the 16 rows of an m-tile, the even and odd k-steps on two accumulators
//    (so a warp waits on half as many dependent products).  The split's row
//    max and sum go across the four warps through shared memory; the block
//    keeps a running max, sum and f32 accumulator per query row over its
//    splits (base 2, the scale folded into the exponent).
//  * P V.  Each warp takes D/4 output columns over all T keys, on mma.sync
//    too.  P goes through shared memory as a bf16 pair, hi = bf16(p) and
//    lo = bf16(p - hi), two products on f32 accumulators of their own: P is
//    then kept to about 2^-16 of itself, where a single bf16 P (as the
//    prefill kernels round it) moves an output by up to 2^-9 and misses the
//    kernel's one-bf16-ulp check.
//  * Combine.  After a cluster barrier each block reads every block's
//    (max, sum) of every query row from their shared memory (the cluster's
//    distributed shared memory) and turns them into weights, then takes its
//    share of the row's outputs, the weighted sum of the blocks'
//    accumulators in rank order (so a call is deterministic), and writes it
//    in bf16 (block 0 also the LSE); a second barrier keeps every block's
//    shared memory alive until the others have read it.  One launch a call,
//    no workspace in device memory, no host sync.
//
// (A persistent grid over the live splits whose last block merged the
// row's partials through an f32 workspace and an atomic ticket was built
// first: the partials' round trips through L2 on the merging block's chain
// held it at 19-45 us of device time where the same kernel without the
// merge took 9-21 us: PERF.md §6.)

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace decode_attn {

constexpr int kThreads = 128;  // four warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;  // blocks a row at most: the portable cluster size
constexpr int kKeys = 64;        // keys a split takes
constexpr int kMaxStages = 2;    // splits a block keeps in flight at most
constexpr float kNegInf = -1e30f;  // finite "empty" max: exp2 of a difference never NaNs
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kMaxRows = 64;   // query rows of a row (R) an instance holds

struct Params {
  int B, Hkv, R;     // R: the group, query rows of a (b, KV head) row
  int stages;        // stages of the ring of splits in flight (1 or 2)
  int max_splits;    // splits of a row at the largest length
  float scale_log2;  // scale x log2(e)
  const __nv_bfloat16* q;  // (B, Hkv, R, D), contiguous
  __nv_bfloat16* out;      // likewise
  float* lse;              // (B, Hkv, R)
  // pools (num_blocks, bs, Hkv, D), the block table (B, max_blocks) and the
  // lengths
  const void* k;
  const void* v;
  const int* tbl;
  const int* lens;
  int bs, max_blocks, num_blocks;
};

// -- tensor-core, copy and conversion helpers ---------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 b16 matrices: lanes 8m..8m+7 give the row addresses of matrix m
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 16 bytes global -> shared, asynchronously; zeros when !valid (nothing read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// waits until at most n (0-3) of this thread's copy groups are in flight
__device__ __forceinline__ void cp_async_wait_n(int n) {
  if (n <= 0) cp_async_wait<0>();
  else if (n == 1) cp_async_wait<1>();
  else if (n == 2) cp_async_wait<2>();
  else cp_async_wait<3>();
}

// two e4m3 values -> a bf16 pair, exactly (through the hardware's e4m3x2 -> f16x2)
__device__ __forceinline__ uint32_t e4m3x2_to_bf16x2(uint32_t two) {
  const __half2_raw h2 =
      __nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(two & 0xffffu), __NV_E4M3);
  const float2 f = __half22float2(__half2(h2));
  return pack_bf16(f.x, f.y);
}

__device__ __forceinline__ int clamp_len(int len, int cap) {
  return len < 0 ? 0 : (len > cap ? cap : len);
}

// -- the shape of one instance ------------------------------------------------

// D: head width (64 or 128); T: keys a split takes; P: the K/V type (bf16
// or fp8 e4m3).  Shared memory: one or two stages of K
// and V rows, the bf16 rows of a widened fp8 stage, the row's Q rows, P as
// hi and lo, the split's row statistics, and the running max, sum and f32
// accumulator of every query row.
template <int D, int T, typename P>
struct Shape {
  static_assert(D % 32 == 0 && D <= 128 && T % 64 == 0, "D in {64, 128}, T a multiple of 64");
  static constexpr bool kFp8 = sizeof(P) == 1;
  static constexpr int kEpc = 16 / sizeof(P);  // elements of a 16-byte chunk
  static constexpr int kRaw = D + kEpc;        // a staged K/V row, padded by 16 bytes
  static constexpr int kStr = D + 8;           // a bf16 row that the products read
  static constexpr int kPStr = T + 8;          // a row of P (bf16)
  static constexpr int kStageBytes = 2 * T * kRaw * (int)sizeof(P);
  static constexpr int kWorkBytes = kFp8 ? 2 * T * kStr * 2 : 0;
  static __host__ __device__ int q_rows(int R) { return (R + 15) / 16 * 16; }
  static int smem_bytes(int stages, int R) {
    const int rq = q_rows(R);
    return stages * kStageBytes + kWorkBytes + rq * kStr * 2 + 2 * 16 * kPStr * 2 +
           2 * kWarps * 16 * 4 + 2 * rq * 4 + rq * D * 4;
  }
};

// -- the kernel -----------------------------------------------------------------

template <int D, int T, typename P>
__global__ void __launch_bounds__(kThreads) decode_kernel(const Params p) {
  using S = Shape<D, T, P>;
  namespace cg = cooperative_groups;
  constexpr int TW = T / kWarps;           // keys of a warp's scores
  constexpr int NJ = TW / 8;               // their 8-key score tiles
  constexpr int NKS = D / 16;              // k-steps of Q K^T
  constexpr int NT = D / 4 / 8;            // 8-column output tiles of a warp
  constexpr int CPR = D / S::kEpc;         // 16-byte chunks of a K/V row
  constexpr int NCH = T * CPR / kThreads;  // and of a split's K rows, a thread
  constexpr int QPR = D / 8;               // of a Q row
  static_assert(T * CPR % kThreads == 0, "a split's chunks are whole per thread");
  extern __shared__ __align__(16) unsigned char smem[];
  const int RQ = S::q_rows(p.R);
  unsigned char* tail = smem + p.stages * S::kStageBytes;
  __nv_bfloat16* work = reinterpret_cast<__nv_bfloat16*>(tail);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(tail + S::kWorkBytes);
  __nv_bfloat16* ph = qs + RQ * S::kStr;
  __nv_bfloat16* pl = ph + 16 * S::kPStr;
  float* red_m = reinterpret_cast<float*>(pl + 16 * S::kPStr);
  float* red_l = red_m + kWarps * 16;
  float* run_m = red_l + kWarps * 16;  // each query row's running max (base 2)
  float* run_l = run_m + RQ;           // and sum over this block's splits
  float* acc = run_l + RQ;             // and accumulator, (RQ, D) f32

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group, column pair
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int bh = blockIdx.x / C, b = bh / p.Hkv, h = bh - b * p.Hkv;
  const int cap = p.max_blocks * p.bs;
  const int len = clamp_len(p.lens[b], cap);
  const int n_splits = (len + T - 1) / T;
  const long long row0 = (long long)bh * p.R * D;  // this row's query rows in q and out

  // A split's K and V rows into a stage, zeros past the length.  The
  // table's entries are read first, all at once, and need no length.
  auto load = [&](int st, int split) {
    P* ks = reinterpret_cast<P*>(smem + st * S::kStageBytes);
    P* vs = ks + T * S::kRaw;
    const P* kp = static_cast<const P*>(p.k);
    const P* vp = static_cast<const P*>(p.v);
    long long at[NCH];
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      const int pos = split * T + (tid + k * kThreads) / CPR;
      int blk = pos < cap ? p.tbl[(long long)b * p.max_blocks + pos / p.bs] : 0;
      blk = blk < 0 ? 0 : (blk >= p.num_blocks ? p.num_blocks - 1 : blk);
      at[k] = ((long long)blk * p.bs + pos % p.bs) * p.Hkv * D + (long long)h * D;
    }
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      const int i = tid + k * kThreads, r = i / CPR, c = (i - r * CPR) * S::kEpc;
      const bool ok = split * T + r < len;
      cp_async16(ks + r * S::kRaw + c, kp + (ok ? at[k] : 0) + c, ok);
      cp_async16(vs + r * S::kRaw + c, vp + (ok ? at[k] : 0) + c, ok);
    }
  };

  // the row's Q rows (zeros past R) and the first split, issued before the
  // length is known (a block past it loads zeros)
  for (int i = tid; i < RQ * QPR; i += kThreads) {
    const int r = i / QPR, c = (i - r * QPR) * 8;
    const bool ok = r < p.R;
    cp_async16(qs + r * S::kStr + c, p.q + (ok ? row0 + r * D : 0) + c, ok);
  }
  load(0, rank);
  cp_async_commit();
  // this block's splits: rank, rank + C, ...; up to p.stages of them in
  // flight, each stage refilled once its split is done
  const int mine = rank < n_splits ? (n_splits - 1 - rank) / C + 1 : 0;
  for (int k = 1; k < min(p.stages, mine); ++k) {
    load(k, rank + k * C);
    cp_async_commit();
  }
  for (int r = tid; r < RQ; r += kThreads) run_m[r] = kNegInf, run_l[r] = 0.f;
  for (int i = tid; i < RQ * D; i += kThreads) acc[i] = 0.f;

  for (int k = 0; k < mine; ++k) {
    const int split = rank + k * C, st = k % p.stages;
    cp_async_wait_n(min(p.stages - 1, mine - 1 - k));
    __syncthreads();

    const unsigned char* base = smem + st * S::kStageBytes;
    const __nv_bfloat16* ks;
    if constexpr (S::kFp8) {  // widen the stage's K and V to bf16 rows once
      const P* raw = reinterpret_cast<const P*>(base);
      for (int c = tid; c < 2 * T * (D / 16); c += kThreads) {
        const int r = c / (D / 16), col = (c - r * (D / 16)) * 16;  // r over K's rows, then V's
        const uint4 w = *reinterpret_cast<const uint4*>(raw + r * S::kRaw + col);
        const uint32_t in[4] = {w.x, w.y, w.z, w.w};
        uint32_t o[8];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          o[2 * j] = e4m3x2_to_bf16x2(in[j]);
          o[2 * j + 1] = e4m3x2_to_bf16x2(in[j] >> 16);
        }
        uint4* dst = reinterpret_cast<uint4*>(work + r * S::kStr + col);
        dst[0] = make_uint4(o[0], o[1], o[2], o[3]);
        dst[1] = make_uint4(o[4], o[5], o[6], o[7]);
      }
      __syncthreads();
      ks = work;
    } else {
      ks = reinterpret_cast<const __nv_bfloat16*>(base);
    }
    const __nv_bfloat16* vs = ks + T * S::kStr;
    const int n_tok = min(T, len - split * T);

    for (int m0 = 0; m0 < p.R; m0 += 16) {
      uint32_t qa[NKS][4];  // Q's A fragments (rows past R are zeros)
#pragma unroll
      for (int kk = 0; kk < NKS; ++kk)
        ldmatrix_x4(qa[kk], qs + (m0 + (lane & 15)) * S::kStr + kk * 16 + (lane >> 4) * 8);
      // this warp's scores: rows g, g+8; keys warp*TW + j*8 + t*2 + {0, 1};
      // the even and odd k-steps on two accumulators
      float s[NJ][4], s2[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = s2[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < NKS; ++kk) {
          const __nv_bfloat16* kr = ks + (warp * TW + j * 8 + g) * S::kStr + kk * 16 + t * 2;
          mma_bf16(kk % 2 ? s2[j] : s[j], qa[kk], ld32(kr), ld32(kr + 8));
        }
      }
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = warp * TW + j * 8 + t * 2 + e < n_tok;
          s[j][e] = ok ? (s[j][e] + s2[j][e]) * p.scale_log2 : kNegInf;
          s[j][2 + e] = ok ? (s[j][2 + e] + s2[j][2 + e]) * p.scale_log2 : kNegInf;
          mx0 = fmaxf(mx0, s[j][e]);
          mx1 = fmaxf(mx1, s[j][2 + e]);
        }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
      }
      if (t == 0) {
        red_m[warp * 16 + g] = mx0;
        red_m[warp * 16 + g + 8] = mx1;
      }
      __syncthreads();
      const int r0 = m0 + g, r1 = r0 + 8;
      float mn0 = run_m[r0], mn1 = run_m[r1];  // the new running max of rows r0, r1
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        mn0 = fmaxf(mn0, red_m[w * 16 + g]);
        mn1 = fmaxf(mn1, red_m[w * 16 + g + 8]);
      }
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float pr[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = warp * TW + j * 8 + t * 2 + e < n_tok;
          pr[e] = ok ? exp2f(s[j][e] - mn0) : 0.f;
          pr[2 + e] = ok ? exp2f(s[j][2 + e] - mn1) : 0.f;
          sum0 += pr[e];
          sum1 += pr[2 + e];
        }
        // P as a bf16 pair, hi + lo
        const int col = warp * TW + j * 8 + t * 2;
        const uint32_t h0 = pack_bf16(pr[0], pr[1]), h1 = pack_bf16(pr[2], pr[3]);
        const __nv_bfloat162 hb0 = *reinterpret_cast<const __nv_bfloat162*>(&h0);
        const __nv_bfloat162 hb1 = *reinterpret_cast<const __nv_bfloat162*>(&h1);
        *reinterpret_cast<uint32_t*>(ph + g * S::kPStr + col) = h0;
        *reinterpret_cast<uint32_t*>(ph + (g + 8) * S::kPStr + col) = h1;
        *reinterpret_cast<uint32_t*>(pl + g * S::kPStr + col) =
            pack_bf16(pr[0] - __low2float(hb0), pr[1] - __high2float(hb0));
        *reinterpret_cast<uint32_t*>(pl + (g + 8) * S::kPStr + col) =
            pack_bf16(pr[2] - __low2float(hb1), pr[3] - __high2float(hb1));
      }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        sum0 += __shfl_xor_sync(0xffffffffu, sum0, o);
        sum1 += __shfl_xor_sync(0xffffffffu, sum1, o);
      }
      if (t == 0) {
        red_l[warp * 16 + g] = sum0;
        red_l[warp * 16 + g + 8] = sum1;
      }
      __syncthreads();
      // the running statistics' rescale for this split
      const float al0 = exp2f(run_m[r0] - mn0), al1 = exp2f(run_m[r1] - mn1);

      // P V over all T keys for this warp's D / 4 columns, hi and lo on
      // accumulators of their own, added to the rescaled accumulator (each
      // thread its own elements of it)
      float oh[NT][4], ol[NT][4];
#pragma unroll
      for (int dt = 0; dt < NT; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) oh[dt][e] = ol[dt][e] = 0.f;
      const int c0 = warp * (D / 4);
      const int mrow = (lane & 7) + ((lane >> 3) & 1) * 8;  // ldmatrix row of this lane
      const int mcol = (lane >> 4) * 8;                       // and its 8-column offset
#pragma unroll
      for (int kk = 0; kk < T / 16; ++kk) {
        uint32_t ah[4], al[4];
        ldmatrix_x4(ah, ph + (lane & 15) * S::kPStr + kk * 16 + (lane >> 4) * 8);
        ldmatrix_x4(al, pl + (lane & 15) * S::kPStr + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int dt = 0; dt < NT; dt += 2) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, vs + (kk * 16 + mrow) * S::kStr + c0 + dt * 8 + mcol);
          mma_bf16(oh[dt], ah, vf[0], vf[1]);
          mma_bf16(ol[dt], al, vf[0], vf[1]);
          mma_bf16(oh[dt + 1], ah, vf[2], vf[3]);
          mma_bf16(ol[dt + 1], al, vf[2], vf[3]);
        }
      }
#pragma unroll
      for (int dt = 0; dt < NT; ++dt) {
        float2* a0 = reinterpret_cast<float2*>(acc + r0 * D + c0 + dt * 8 + t * 2);
        float2* a1 = reinterpret_cast<float2*>(acc + r1 * D + c0 + dt * 8 + t * 2);
        *a0 = make_float2(fmaf(a0->x, al0, oh[dt][0] + ol[dt][0]),
                          fmaf(a0->y, al0, oh[dt][1] + ol[dt][1]));
        *a1 = make_float2(fmaf(a1->x, al1, oh[dt][2] + ol[dt][2]),
                          fmaf(a1->y, al1, oh[dt][3] + ol[dt][3]));
      }
      __syncthreads();  // every thread has read run_m of rows r0, r1 and the split's sums
      if (warp == 0 && t == 0) {
        float l0 = 0.f, l1 = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          l0 += red_l[w * 16 + g];
          l1 += red_l[w * 16 + g + 8];
        }
        run_l[r0] = fmaf(run_l[r0], al0, l0);
        run_l[r1] = fmaf(run_l[r1], al1, l1);
        run_m[r0] = mn0;
        run_m[r1] = mn1;
      }
      __syncthreads();  // P, the split's sums and the running max are refilled next
    }
    if (k + p.stages < mine) {  // every thread is done with this stage: refill it
      load(st, rank + (k + p.stages) * C);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();  // a block past the length still has its zero-fill in flight

  // every block's weight for every query row, from their (max, sum)
  cluster.sync();
  float* wts = reinterpret_cast<float*>(ph);  // (R, C), in P's room (free now)
  float* sums = wts + p.R * C;                // (R, C)
  for (int i = tid; i < p.R * C; i += kThreads) {
    const int r = i / C, j = i - r * C;
    wts[i] = cluster.map_shared_rank(run_m, j)[r];
    sums[i] = cluster.map_shared_rank(run_l, j)[r];
  }
  __syncthreads();
  for (int r = tid; r < p.R; r += kThreads) {
    float M = kNegInf, L = 0.f;
    for (int j = 0; j < C; ++j) M = fmaxf(M, wts[r * C + j]);
    for (int j = 0; j < C; ++j) L = fmaf(sums[r * C + j], exp2f(wts[r * C + j] - M), L);
    for (int j = 0; j < C; ++j) wts[r * C + j] = L > 0.f ? exp2f(wts[r * C + j] - M) / L : 0.f;
    // a row of length 0 has no split anywhere: zeros, and -inf for its LSE
    if (rank == 0)
      p.lse[(long long)bh * p.R + r] =
          L > 0.f ? (M + log2f(L)) * kLn2 : __uint_as_float(0xff800000u);
  }
  __syncthreads();
  // this block's share of the outputs, four columns a thread: the blocks'
  // accumulators, weighted (16-byte reads of the cluster's shared memory)
  for (int e = (rank * kThreads + tid) * 4; e < p.R * D; e += C * kThreads * 4) {
    const int r = e / D;
    float4 a[kMaxCluster];
#pragma unroll
    for (int j = 0; j < kMaxCluster; ++j)
      if (j < C) a[j] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(acc, j) + e);
    float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < kMaxCluster; ++j)
      if (j < C) {
        const float w = wts[r * C + j];
        A = make_float4(fmaf(w, a[j].x, A.x), fmaf(w, a[j].y, A.y), fmaf(w, a[j].z, A.z),
                        fmaf(w, a[j].w, A.w));
      }
    uint32_t* o = reinterpret_cast<uint32_t*>(p.out + row0 + e);
    o[0] = pack_bf16(A.x, A.y);
    o[1] = pack_bf16(A.z, A.w);
  }
  cluster.sync();  // the others have read this block's shared memory
}

// The largest cluster of 8, 4 or 2 blocks a (b, KV head) row whose B x Hkv
// clusters the card holds at once (8 where none does), and the launch.  A
// call with more query rows than an instance holds is refused.
template <int D, int T, typename P>
cudaError_t launch(Params p, cudaStream_t stream) {
  using S = Shape<D, T, P>;
  if (p.R > kMaxRows || p.R < 1) return cudaErrorInvalidValue;
  const long long rows = (long long)p.B * p.Hkv;
  if (rows * kMaxCluster > 0x7fffffff) return cudaErrorInvalidValue;
  auto kernel = decode_kernel<D, T, P>;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // the clusters the card holds at once, by (cluster size, shared memory):
  // host queries, kept per instance
  static int seen_c[16], seen_smem[16], seen_n[16], n_seen = 0, smem_allowed = 0;
  // the kernel's dynamic shared memory allowance: raised when a call needs more
  auto allow = [&](int smem) -> cudaError_t {
    if (smem <= smem_allowed) return cudaSuccess;
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess) smem_allowed = smem;
    return e;
  };
  int C = kMaxCluster;
  // the ring: two splits in flight where a block takes more than one (four
  // were slower: fewer clusters fit at once, PERF.md §6)
  auto stages_for = [&](int c) { return p.max_splits > c ? kMaxStages : 1; };
  for (int c = kMaxCluster; c >= 2; c /= 2) {
    const int smem = S::smem_bytes(stages_for(c), p.R);
    int n = -1;
    for (int i = 0; i < n_seen; ++i)
      if (seen_c[i] == c && seen_smem[i] == smem) n = seen_n[i];
    if (n < 0) {
      cudaError_t e = allow(smem);
      attr[0].val.clusterDim.x = c, attr[0].val.clusterDim.y = 1, attr[0].val.clusterDim.z = 1;
      cfg.gridDim = dim3((unsigned)(rows * c));
      cfg.dynamicSmemBytes = smem;
      if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
      if (e != cudaSuccess) return e;
      if (n_seen < 16) seen_c[n_seen] = c, seen_smem[n_seen] = smem, seen_n[n_seen++] = n;
    }
    if (rows <= n) {
      C = c;
      break;
    }
  }
  p.stages = stages_for(C);
  const int smem = S::smem_bytes(p.stages, p.R);
  cudaError_t e = allow(smem);
  if (e != cudaSuccess) return e;
  attr[0].val.clusterDim.x = C, attr[0].val.clusterDim.y = 1, attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3((unsigned)(rows * C));
  cfg.dynamicSmemBytes = smem;
  e = cudaLaunchKernelEx(&cfg, kernel, p);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace decode_attn
