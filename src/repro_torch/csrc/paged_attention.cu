// Paged decode attention over the PUMA KV pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/kernel.py:
// paged_attention (body _paged_kernel).  For every sequence b and KV head h,
// the `group` query heads of that KV head attend to the first seq_lens[b]
// tokens of the sequence's KV stream, which lives as block_size-token pages
// listed in an int32 block table (-1 entries clamp to page 0; positions
// >= seq_lens[b] are masked).  Online softmax with an f32 running max, sum
// and accumulator; a sequence of length 0 gives zeros.  q and output share
// one type, float32 or bfloat16; the pools are that type too, or float8
// e4m3 pages (kv_cache_dtype="float8_e4m3fn"), widened to f32 in registers,
// as the TPU kernel casts its pages to f32.  Besides the output it writes
// the log-sum-exp of each query head's scaled, masked scores, in f32, shape
// (B, Hkv, group): -inf for a length-0 row.
//
// Bound: device-memory bytes (the K and V rows a sequence needs, read once),
// at 3.35 TB/s; the arithmetic (4 x group x D flops per token) is far below
// the card's rate at every group the configs use.  The design is
// flash-decoding, built to keep loads in flight and the serial chain of a
// block short:
//
//  * Split.  The grid is (B x Hkv x head chunks, n_splits): each block takes
//    one split of kSplitTokens tokens (whole pages) of one (b, h) and up to
//    GH query heads, so a group of any size is taken in chunks of GH heads
//    (granite_34b's MQA group of 48 heads of 128: 12 blocks a split in bf16,
//    6 in f32, 24 over fp8 pages); nothing in the kernel holds a whole
//    group at once.  n_splits = ceil(max_blocks / pages_per_split) comes
//    from shapes alone, never from seq_lens, so a call can be captured in a
//    CUDA graph; a split at or past its sequence's length exits at once
//    (the combine reads only the splits below the length, so it writes
//    nothing).  64 tokens a split: at the stablelm_1_6b decode shape
//    (8 x 32 heads, 64 blocks of 16 tokens a sequence) that is 4096 blocks,
//    about 1700 of them live at the serve's lengths, some 13 an SM.  32
//    tokens was slower (more blocks, each with the same fixed chain), 128
//    no faster (scripts/paged_bench.py; PERF.md §6).
//  * Loads.  Where a row fits a warp (16-byte slices <= 32) and a page of
//    one head is a multiple of 128 bytes, one thread of the block reads the
//    split's table entries and asks TMA for each page of K and V of its head
//    (a box of bs rows x D at (blk * bs, h * D) of the pool seen as nb * bs
//    rows of Hkv * D; the maps are encoded once per pool), all on one
//    mbarrier, while the threads load q.  Else lanes load 16-byte slices
//    straight into registers, several rows before their use.  Either way
//    lanes take 16-byte slices of a row, neighbouring lanes neighbouring
//    addresses: at D = 64 bf16, 8 lanes cover a row and a warp 4 rows.  A
//    score is reduced over its row's lanes with shuffles.  q lives in
//    registers, scaled by scale x log2(e) (the softmax runs in base 2);
//    each row a lane holds serves every query head of its chunk.
//  * State.  Each group of lanes that shares a row keeps its own running
//    (m, l, acc) over its rows; the warp merges them with shuffles and the
//    block merges its warps through shared memory, once, at its end.
//  * Combine.  A split writes (m, l, acc[D]) per (b, h, g) to an f32
//    workspace (the wrapper allocates it behind the LSE); a second small
//    kernel merges a row's live splits in one pass and writes the output in
//    q's type and the LSE, m + log l.  It is launched as a programmatic
//    dependent of the split kernel, so its blocks start while the split
//    kernel's last ones run; each waits for the whole split grid before it
//    reads a partial or exits.  A row with one live split (or none) is
//    written directly by the split kernel and skipped by the combine.  So a
//    call makes two CUDA launches.
//
// fp8 pages are widened two at a time through the hardware's e4m3x2 -> f16x2
// conversion.  No tensor cores: the work is bytes-bound.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSplitTokens = 64;   // tokens a block takes (rounded to whole pages)
constexpr int kLaneFloats = 32;    // q (and acc) floats a lane holds for its head chunk
constexpr float kNegInf = -1e30f;  // finite "empty" max: exp2 of a difference never NaNs
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

int pages_per_split(int bs) { return bs >= kSplitTokens ? 1 : kSplitTokens / bs; }

int split_count(int bs, int max_blocks) {
  const int pps = pages_per_split(bs);
  const int n = (max_blocks + pps - 1) / pps;
  return n < 1 ? 1 : n;
}

// 16 bytes of T -> f32 (exact for every type)
__device__ __forceinline__ void widen(const uint4& r, float* d, const float*) {
  d[0] = __uint_as_float(r.x);
  d[1] = __uint_as_float(r.y);
  d[2] = __uint_as_float(r.z);
  d[3] = __uint_as_float(r.w);
}

__device__ __forceinline__ void widen(const uint4& r, float* d, const __nv_bfloat16*) {
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    d[2 * i] = __uint_as_float(w[i] << 16);
    d[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void widen(const uint4& r, float* d, const __nv_fp8_e4m3*) {
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const __half2_raw h2 = __nv_cvt_fp8x2_to_halfraw2(
          static_cast<__nv_fp8x2_storage_t>((w[i] >> (16 * half)) & 0xffffu), __NV_E4M3);
      const float2 f = __half22float2(__half2(h2));
      d[4 * i + 2 * half] = f.x;
      d[4 * i + 2 * half + 1] = f.y;
    }
  }
}

__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// -- the TMA path's mbarrier and bulk tensor copy --

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// one arrival that also expects `bytes` more from asynchronous copies
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// Waits for phase 0 to complete; trap rather than hang if it never does.
__device__ __forceinline__ void mbar_wait0(uint32_t bar) {
  for (int n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar)
        : "memory");
    if (done) return;
    if (n == (1 << 24)) __trap();
  }
}
// the box of a 2-D tensor map at (x, y) (x innermost) into shared memory,
// completing on `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

__device__ __forceinline__ int clamp_len(int len, int max_blocks, int bs) {
  const int cap = max_blocks * bs;
  return len < 0 ? 0 : (len > cap ? cap : len);
}

// One split of one (b, h) and up to GH query heads.  T: q and output; P: the
// pages (T itself, or fp8 e4m3); NC: 16-byte slices a lane takes of a row (1
// while a row fits a warp, else the row's slices over 32); GH: query heads a
// block takes; TMA: the split's pages come into shared memory by TMA (one
// box of bs rows x D per page and pool), else straight into registers.
template <typename T, typename P, int NC, int GH, bool TMA>
__global__ void __launch_bounds__(kThreads) paged_split_kernel(
    const T* __restrict__ q, const P* __restrict__ k_pool, const P* __restrict__ v_pool,
    const __grid_constant__ CUtensorMap k_map, const __grid_constant__ CUtensorMap v_map,
    const int* __restrict__ block_tables, const int* __restrict__ seq_lens,
    T* __restrict__ out, float* __restrict__ lse, float* __restrict__ ws_ml,
    float* __restrict__ ws_acc, int Hkv, int group, int D, int bs, int max_blocks,
    int num_blocks, int split_tokens, int n_splits, float scale_log2) {
  constexpr int kEpc = 16 / sizeof(P);      // page elements per 16-byte slice
  constexpr int kQv = 16 / sizeof(T);       // q elements per 16-byte load
  constexpr int kE = NC * kEpc;             // channels a lane holds
  constexpr int kU = NC >= 4 ? 1 : 4 / NC;  // rows a lane loads before using them
  constexpr int kDmax = NC * 32 * kEpc;     // widest row this instance takes
  __shared__ float m_s[kWarps][GH];
  __shared__ float l_s[kWarps][GH];
  __shared__ float a_s[kWarps][GH * kDmax];
  extern __shared__ __align__(128) unsigned char pages_s[];  // TMA: K rows, V rows, mbarrier

  // let the combine launch as the last blocks start (it waits for the
  // whole grid before it reads a partial)
  asm volatile("griddepcontrol.launch_dependents;");
  const int ngc = (group + GH - 1) / GH;
  const int bh = blockIdx.x / ngc;
  const int g0 = (blockIdx.x - bh * ngc) * GH;
  const int b = bh / Hkv;
  const int h = bh - b * Hkv;
  const int split = blockIdx.y;
  const int len = clamp_len(seq_lens[b], max_blocks, bs);
  const int n_live = (len + split_tokens - 1) / split_tokens;
  const long long row0 = (long long)bh * group + g0;  // first (b, h, g) row of this block
  const int nh = min(GH, group - g0);                 // query heads this block takes

  if (n_live == 0) {  // length 0: zeros and -inf, from split 0
    if (split == 0) {
      for (int i = threadIdx.x; i < nh * D; i += kThreads) {
        store_as(out + row0 * D + i, 0.f);
        if (i % D == 0) lse[row0 + i / D] = __uint_as_float(0xff800000u);  // -inf
      }
    }
    return;
  }
  const int start = split * split_tokens;
  if (start >= len) return;
  const int n_tok = min(split_tokens, len - start);  // valid tokens of this split

  const P* k_s = reinterpret_cast<const P*>(pages_s);
  const P* v_s = k_s + (long long)split_tokens * D;
  const uint32_t bar = smem_u32(v_s + (long long)split_tokens * D);
  if (TMA && threadIdx.x == 0) {
    const int n_pages = (n_tok + bs - 1) / bs;
    const int* pages = block_tables + (long long)b * max_blocks + start / bs;
    mbar_init(bar, 1);
    mbar_expect_tx(bar, 2 * n_pages * bs * D * (int)sizeof(P));
    for (int i = 0; i < n_pages; ++i) {
      int blk = pages[i];
      blk = blk < 0 ? 0 : (blk >= num_blocks ? num_blocks - 1 : blk);
      tma_load_2d(smem_u32(k_s + i * bs * D), &k_map, bar, h * D, blk * bs);
      tma_load_2d(smem_u32(v_s + i * bs * D), &v_map, bar, h * D, blk * bs);
    }
  }

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int chunks = D / kEpc;  // 16-byte slices in a row
  int lpr = 32;                 // lanes per row: a power of two
  if (NC == 1) {
    lpr = 1;
    while (lpr < chunks) lpr <<= 1;
  }
  const int rpw = 32 / lpr;     // rows a warp loads at once
  const int sub = lane % lpr;   // this lane's slice of the row
  const int rg = lane / lpr;    // this lane's row within the warp

  float qr[GH][kE];
#pragma unroll
  for (int g = 0; g < GH; ++g) {
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = j * lpr + sub;
      if (g < nh && c < chunks) {
        const T* src = q + (row0 + g) * D + c * kEpc;
#pragma unroll
        for (int v = 0; v < kEpc / kQv; ++v)
          widen(*reinterpret_cast<const uint4*>(src + v * kQv), &qr[g][j * kEpc + v * kQv], q);
#pragma unroll
        for (int e = 0; e < kEpc; ++e) qr[g][j * kEpc + e] *= scale_log2;
      } else {
#pragma unroll
        for (int e = 0; e < kEpc; ++e) qr[g][j * kEpc + e] = 0.f;
      }
    }
  }

  float m[GH], l[GH], acc[GH][kE];
#pragma unroll
  for (int g = 0; g < GH; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[g][e] = 0.f;
  }

  if (TMA) {
    __syncthreads();  // the mbarrier is initialised
    mbar_wait0(bar);
  }

  const int step = kWarps * rpw;                     // rows the block loads at once
  const int* tbl = block_tables + (long long)b * max_blocks;
  const long long row_stride = (long long)Hkv * D;   // token to token in a page
  for (int t0 = 0; t0 < n_tok; t0 += step * kU) {
    uint4 kr[kU][NC], vr[kU][NC];
    bool ok[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int t = t0 + u * step + warp * rpw + rg;
      ok[u] = t < n_tok;
      long long base = 0;
      if (!TMA && ok[u]) {
        const int pos = start + t;
        int blk = tbl[pos / bs];
        blk = blk < 0 ? 0 : (blk >= num_blocks ? num_blocks - 1 : blk);
        base = ((long long)blk * bs + pos % bs) * row_stride + (long long)h * D;
      }
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int c = j * lpr + sub;
        if (TMA && ok[u] && c < chunks) {
          kr[u][j] = *reinterpret_cast<const uint4*>(k_s + (long long)t * D + c * kEpc);
          vr[u][j] = *reinterpret_cast<const uint4*>(v_s + (long long)t * D + c * kEpc);
        } else if (ok[u] && c < chunks) {
          kr[u][j] = __ldg(reinterpret_cast<const uint4*>(k_pool + base + c * kEpc));
          vr[u][j] = __ldg(reinterpret_cast<const uint4*>(v_pool + base + c * kEpc));
        } else {
          kr[u][j] = make_uint4(0u, 0u, 0u, 0u);
          vr[u][j] = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }

    // scores (base 2), each reduced over its row's lanes
    float s[kU][GH];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
#pragma unroll
      for (int g = 0; g < GH; ++g) s[u][g] = 0.f;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        float kf[kEpc];
        widen(kr[u][j], kf, k_pool);
#pragma unroll
        for (int g = 0; g < GH; ++g)
#pragma unroll
          for (int e = 0; e < kEpc; ++e) s[u][g] = fmaf(qr[g][j * kEpc + e], kf[e], s[u][g]);
      }
#pragma unroll
      for (int g = 0; g < GH; ++g) {
        for (int o = 1; o < lpr; o <<= 1) s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], o);
        if (!ok[u]) s[u][g] = kNegInf;
      }
    }

    // online softmax: one rescale for the kU rows
#pragma unroll
    for (int g = 0; g < GH; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < kU; ++u) mx = fmaxf(mx, s[u][g]);
      const float alpha = exp2f(m[g] - mx);
      m[g] = mx;
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[g][e] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      float p[GH];
#pragma unroll
      for (int g = 0; g < GH; ++g) {
        p[g] = ok[u] ? exp2f(s[u][g] - m[g]) : 0.f;
        l[g] += p[g];
      }
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        float vf[kEpc];
        widen(vr[u][j], vf, v_pool);
#pragma unroll
        for (int g = 0; g < GH; ++g)
#pragma unroll
          for (int e = 0; e < kEpc; ++e)
            acc[g][j * kEpc + e] = fmaf(p[g], vf[e], acc[g][j * kEpc + e]);
      }
    }
  }

  // merge the warp's row groups (lanes lpr apart hold the same channels)
  for (int o = lpr; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GH; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], o);
      const float mn = fmaxf(m[g], mo);
      const float a = exp2f(m[g] - mn), c = exp2f(mo - mn);
      l[g] = l[g] * a + lo * c;
#pragma unroll
      for (int e = 0; e < kE; ++e)
        acc[g][e] = acc[g][e] * a + __shfl_xor_sync(0xffffffffu, acc[g][e], o) * c;
      m[g] = mn;
    }
  }
  if (rg == 0) {
#pragma unroll
    for (int g = 0; g < GH; ++g) {
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int c = j * lpr + sub;
        if (c < chunks) {
#pragma unroll
          for (int e = 0; e < kEpc; ++e) a_s[warp][g * D + c * kEpc + e] = acc[g][j * kEpc + e];
        }
      }
      if (lane == 0) {
        m_s[warp][g] = m[g];
        l_s[warp][g] = l[g];
      }
    }
  }
  __syncthreads();

  // merge the warps; write the partial, or the output when this is the
  // row's only live split
  const bool direct = n_live == 1;
  for (int i = threadIdx.x; i < nh * D; i += kThreads) {
    const int g = i / D, d = i - g * D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w][g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = exp2f(m_s[w][g] - mx);
      L = fmaf(wt, l_s[w][g], L);
      A = fmaf(wt, a_s[w][g * D + d], A);
    }
    const long long row = row0 + g;
    if (direct) {
      store_as(out + row * D + d, A / L);
      if (d == 0) lse[row] = (mx + log2f(L)) * kLn2;
    } else {
      const long long part = row * n_splits + split;
      ws_acc[part * D + d] = A;
      if (d == 0) {
        ws_ml[2 * part] = mx;
        ws_ml[2 * part + 1] = L;
      }
    }
  }
}

// Merges each row's live splits (two or more) into the output and its LSE.
// The grid is (b, h) x slices of kThreads (g, d) elements, so a wide group
// (granite_34b's 48 heads of 128) is spread over many blocks.
template <typename T>
__global__ void __launch_bounds__(kThreads) paged_combine_kernel(
    const float* __restrict__ ws_ml, const float* __restrict__ ws_acc,
    const int* __restrict__ seq_lens, T* __restrict__ out, float* __restrict__ lse,
    int Hkv, int group, int D, int bs, int max_blocks, int split_tokens, int n_splits) {
  const int bh = blockIdx.x;
  const int len = clamp_len(seq_lens[bh / Hkv], max_blocks, bs);
  const int n_live = (len + split_tokens - 1) / split_tokens;
  // Every block waits for the split kernel, also one with nothing to merge:
  // the combine then ends after the split kernel, so the next work on the
  // stream sees its direct writes too.
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (n_live < 2) return;
  for (int i = blockIdx.y * kThreads + threadIdx.x; i < group * D; i += kThreads * gridDim.y) {
    const int g = i / D, d = i - g * D;
    const long long row = (long long)bh * group + g;
    const float* ml = ws_ml + 2 * row * n_splits;
    const float* ac = ws_acc + row * n_splits * D + d;
    // one pass, rescaling as the max grows: the loads of unrolled splits do
    // not wait on each other
    float mx = kNegInf, L = 0.f, A = 0.f;
#pragma unroll 4
    for (int s = 0; s < n_live; ++s) {
      const float ms = ml[2 * s], ls = ml[2 * s + 1], as = ac[(long long)s * D];
      const float mn = fmaxf(mx, ms);
      const float a = exp2f(mx - mn), c = exp2f(ms - mn);
      L = L * a + ls * c;
      A = A * a + as * c;
      mx = mn;
    }
    store_as(out + row * D + d, A / L);
    if (d == 0) lse[row] = (mx + log2f(L)) * kLn2;
  }
}

// Floats of the f32 workspace: (m, l) then acc[D] for every (b, h, g) row
// and split.
long long workspace_floats(int B, int Hkv, int group, int D, int bs, int max_blocks) {
  const long long parts = (long long)B * Hkv * group * split_count(bs, max_blocks);
  return parts * (2 + D);
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

template <typename P> constexpr CUtensorMapDataType map_type() {
  return sizeof(P) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                        : sizeof(P) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                         : CU_TENSOR_MAP_DATA_TYPE_UINT8;
}

// A pool layer as a 2-D tensor of nb * bs rows of Hkv * D elements, read in
// boxes of one page (bs rows) of one head (D elements).  Encoding a map is
// host work that a decode step would pay twice a layer, so the maps are kept:
// an entry is keyed by everything the map encodes, so it is right for any
// pool at that address and shape.
struct PoolMapKey {
  const void* pool;
  int elem, rows, Hkv, D, bs;
  bool operator==(const PoolMapKey& o) const {
    return pool == o.pool && elem == o.elem && rows == o.rows && Hkv == o.Hkv && D == o.D &&
           bs == o.bs;
  }
};
constexpr int kMapCache = 256;  // a serve's layers hold 2 pools each
PoolMapKey map_keys[kMapCache];
CUtensorMap map_vals[kMapCache];
int map_count = 0, map_next = 0;
std::mutex map_lock;

template <typename P>
cudaError_t encode_pool(CUtensorMap* map, const void* pool, int rows, int Hkv, int D, int bs) {
  const PoolMapKey key{pool, (int)sizeof(P), rows, Hkv, D, bs};
  std::lock_guard<std::mutex> hold(map_lock);
  for (int i = 0; i < map_count; ++i)
    if (map_keys[i] == key) {
      *map = map_vals[i];
      return cudaSuccess;
    }
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)Hkv * D, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)Hkv * D * sizeof(P)};
  const cuuint32_t box[2] = {(cuuint32_t)D, (cuuint32_t)bs}, unit[2] = {1, 1};
  const CUresult r = encode(map, map_type<P>(), 2, const_cast<void*>(pool), dims, strides, box,
                            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  map_keys[map_next] = key;  // full: the oldest entry gives way
  map_vals[map_next] = *map;
  map_next = (map_next + 1) % kMapCache;
  if (map_count < kMapCache) ++map_count;
  return cudaSuccess;
}

template <typename T, typename P, int NC, int GH, bool TMA>
cudaError_t launch_split(dim3 grid, cudaStream_t stream, const void* q, const void* k,
                         const void* v, const void* tbl, const void* lens, void* out,
                         void* lse, float* ws_ml, float* ws_acc, int Hkv, int group, int D,
                         int bs, int max_blocks, int num_blocks, int n_splits, float scale) {
  CUtensorMap k_map{}, v_map{};
  int smem = 0;
  if (TMA) {
    // the split's K and V pages and the mbarrier, beside the static m_s,
    // l_s and a_s; past 48 KiB in all the kernel must opt in
    smem = 2 * pages_per_split(bs) * bs * D * (int)sizeof(P) + 8;
    constexpr int kStatic = 4 * kWarps * GH * (2 + NC * 32 * (16 / (int)sizeof(P)));
    cudaError_t e = encode_pool<P>(&k_map, k, num_blocks * bs, Hkv, D, bs);
    if (e == cudaSuccess) e = encode_pool<P>(&v_map, v, num_blocks * bs, Hkv, D, bs);
    if (e == cudaSuccess && smem + kStatic > 48 * 1024)
      e = cudaFuncSetAttribute(paged_split_kernel<T, P, NC, GH, TMA>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  paged_split_kernel<T, P, NC, GH, TMA><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(k), static_cast<const P*>(v), k_map, v_map,
      static_cast<const int*>(tbl), static_cast<const int*>(lens), static_cast<T*>(out),
      static_cast<float*>(lse), ws_ml, ws_acc, Hkv, group, D, bs, max_blocks, num_blocks,
      pages_per_split(bs) * bs, n_splits, scale * kLog2e);
  return cudaGetLastError();
}

// Checks the shapes, picks the instance and launches the split kernel, then
// the combine; a shape the kernel cannot take gives cudaErrorInvalidValue.
template <typename T, typename P>
int launch(const void* q, const void* k, const void* v, const void* tbl, const void* lens,
           void* out, void* lse, int B, int Hkv, int group, int D, int bs, int max_blocks,
           int num_blocks, float scale, void* stream_ptr) {
  constexpr int kEpc = 16 / sizeof(P);
  if (B <= 0 || Hkv <= 0) return 0;
  if (group <= 0 || D <= 0 || bs <= 0 || max_blocks < 0 || D % (16 / (int)sizeof(T)) != 0 ||
      D % kEpc != 0)
    return (int)cudaErrorInvalidValue;
  const int n_splits = split_count(bs, max_blocks);
  if (n_splits > 65535) return (int)cudaErrorInvalidValue;
  const int chunks = D / kEpc;
  int nc = 1;
  while (nc * 32 < chunks) nc <<= 1;
  constexpr int kGh = kLaneFloats / kEpc;  // heads a block takes when group > 1
  const int gh = nc == 1 && group > 1 ? kGh : 1;
  const dim3 grid(B * Hkv * ((group + gh - 1) / gh), n_splits);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  float* ws_ml = static_cast<float*>(lse) + (long long)B * Hkv * group;
  float* ws_acc = ws_ml + 2LL * B * Hkv * group * n_splits;
#define PAGED_SPLIT(NC, GH, TMA)                                                          \
  launch_split<T, P, NC, GH, TMA>(grid, stream, q, k, v, tbl, lens, out, lse, ws_ml, ws_acc,   \
                             Hkv, group, D, bs, max_blocks, num_blocks, n_splits, scale)
  cudaError_t e;
  // TMA boxes (bs rows x D) need a 128-byte-aligned shared destination: the
  // pages sit back to back, so a page must be a multiple of 128 bytes
  const long long page_bytes = (long long)bs * D * sizeof(P);
  const bool tma = nc == 1 && D <= 256 && bs <= 256 && page_bytes % 128 == 0 &&
                   2LL * pages_per_split(bs) * page_bytes + 8 <= 96 * 1024;
  if (nc == 1 && tma)
    e = gh == 1 ? PAGED_SPLIT(1, 1, true) : PAGED_SPLIT(1, kGh, true);
  else if (nc == 1)
    e = gh == 1 ? PAGED_SPLIT(1, 1, false) : PAGED_SPLIT(1, kGh, false);
  else if (nc == 2)
    e = PAGED_SPLIT(2, 1, false);
  else if (nc == 4)
    e = PAGED_SPLIT(4, 1, false);
  else if constexpr (kEpc <= 8) {  // rows of more than 128 slices: f32 and bf16 only
    if (nc == 8)
      e = PAGED_SPLIT(8, 1, false);
    else if constexpr (kEpc == 4)
      e = PAGED_SPLIT(16, 1, false);
    else
      return (int)cudaErrorInvalidValue;
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef PAGED_SPLIT
  if (e != cudaSuccess) return (int)e;
  // programmatic dependent launch: the combine's blocks may start while
  // the split kernel's last blocks run
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  const int slices = (group * D + kThreads - 1) / kThreads;
  cfg.gridDim = dim3(B * Hkv, slices < 65535 ? slices : 65535);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, paged_combine_kernel<T>, (const float*)ws_ml,
                         (const float*)ws_acc, static_cast<const int*>(lens),
                         static_cast<T*>(out), static_cast<float*>(lse), Hkv, group, D, bs,
                         max_blocks, pages_per_split(bs) * bs, n_splits);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

#define PAGED_ENTRY(NAME, T, P)                                                            \
  extern "C" int NAME(const void* q, const void* k, const void* v, const void* tbl,        \
                      const void* lens, void* out, void* lse, int B, int Hkv, int group,   \
                      int D, int bs, int max_blocks, int num_blocks, float scale,          \
                      void* stream) {                                                      \
    return launch<T, P>(q, k, v, tbl, lens, out, lse, B, Hkv, group, D, bs, max_blocks,    \
                        num_blocks, scale, stream);                                        \
  }

PAGED_ENTRY(paged_attention_f32, float, float)
PAGED_ENTRY(paged_attention_bf16, __nv_bfloat16, __nv_bfloat16)
PAGED_ENTRY(paged_attention_f32_fp8, float, __nv_fp8_e4m3)
PAGED_ENTRY(paged_attention_bf16_fp8, __nv_bfloat16, __nv_fp8_e4m3)

// Tokens one block of the split kernel takes at this page size.
extern "C" int paged_attention_split_tokens(int bs) { return pages_per_split(bs) * bs; }

// Floats of f32 workspace a call at these shapes needs; the entry points take
// it right after the LSE's B * Hkv * group floats, in one buffer.
extern "C" long long paged_attention_workspace_floats(int B, int Hkv, int group, int D,
                                                      int bs, int max_blocks) {
  return workspace_floats(B, Hkv, group, D, bs, max_blocks);
}

extern "C" const char* cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
