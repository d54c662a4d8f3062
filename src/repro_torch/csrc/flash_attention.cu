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
// Bound: at the main shape (B 4, H 32, S 2048, D 64, causal, bf16) the
// tensor-core operations, 2 * 2 * B * H * S^2 * D / 2 = 6.9e10, take 0.069 ms
// at 989 TFLOP/s; the bytes (q, k, v read once, out written once: 134 MB) take
// 0.040 ms at 3.35 TB/s.  So it is bound by operations.
//
// Design: one thread block per (q tile of 64 rows, query head, batch), q
// tiles of one head in reverse order so the longest causal rows start first.
// The block loops over K/V tiles of 64 keys staged in shared memory, with the
// online softmax in registers (bf16) or shared memory (f32).  Under the causal
// mask the K tiles wholly above the diagonal of the q tile are skipped: their
// weights are exactly 0, so the result is unchanged.
//   * bf16 with D a multiple of 16 up to 128, K/V rows on 16-byte boundaries
//     and q/out rows on 4-byte ones: four warps of 16 query rows each run
//     mma.sync m16n8k16 (bf16 in, f32 accumulate).  q fragments stay in
//     registers for the whole sweep.  K and V tiles stream into two stages of
//     shared memory with cp.async (rows padded by 16 bytes against bank
//     conflicts), the next tile loading while the current one is used; the
//     V operand is read transposed by ldmatrix.trans.  The score accumulator
//     is reused as the A operand of the P.V product after rounding P to bf16
//     (FlashAttention-2's layout).  The softmax runs in base 2 with the
//     hardware's approximate exp2, and only tiles that cross the diagonal or
//     the end of the keys apply the mask.
//   * f32, and bf16 shapes the tensor-core path does not take: 256 threads
//     on CUDA cores in f32, a 4 x 4 score micro-tile and a 4 x ceil(D/16)
//     output micro-tile per thread.  f32 inputs have to stay f32: the
//     reference holds f32 to 2e-5, which TF32 cannot meet.
// No TMA, no warp specialisation and no wgmma: that is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// The tensor-core path loads q and stores the output as 32-bit bf16 pairs and
// copies K and V rows in 16-byte chunks.
bool aligned_to(const void* ptr, int bytes, long long sb, long long sh, long long ss) {
  const int elems = bytes / 2;
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0 && sb % elems == 0 && sh % elems == 0 &&
         ss % elems == 0;
}

// dims: B, Hq, Hkv, Sq, Sk, D; strides: q, k, v, out each (batch, head, seq).
// Returns 1 when the tensor-core path ran, 0 for the CUDA-core path, or
// minus a cudaError_t.
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
    if (aligned && p.D % 16 == 0 && p.D <= 128) {
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
