// Chunked decay linear attention (RWKV6 "bonus" / Mamba2 SSD), for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decay_attention/kernel.py:
// decay_attention (body _decay_kernel) and, with an initial and a final
// state, the model path's src/repro/models/linear_scan.py:
// chunked_decay_attention.  Per (batch b, head h), with the f32 state S
// (dk, dv) carried over 32-token chunks taken in order:
//   lw  = clip(log_w, -1.8, 0);  cum = inclusive cumsum of lw in the chunk,
//   ecum = cum - lw,  total = cum[last];
//   qs  = q * e^ecum (bonus) or q * e^cum (no bonus);  ks = k * e^-cum;
//   A   = qs ks^T under the strict (bonus) or inclusive (no bonus) causal mask;
//   y   = A v (+ ((q*u).k) v with the bonus) + qs S;
//   S  <- S * e^total + (k * e^(total - cum))^T v.
// The output is in q's type, the final state f32.  Forward only, as the TPU
// kernel.
//
// Ragged S is masked here: a position past S counts as k = v = 0 and
// lw = 0, so the final state equals the zero-padded reference's; the TPU
// wrapper's padding of S and of d is not carried over.  q, k, v and log_w
// are read through their (b, s, h, d) strides, stride 0 included (Mamba2
// passes C and B broadcast over heads and the decay broadcast over the state
// dim).  u (H, dk), h0 and hT (B, H, dk, dv) are contiguous f32.
//
// Five paths, all of them the TPU kernel's counterpart, one chosen by the
// caller before the launch (ops.py: kernel_path), by type and strides alone:
//
// * simt (f32 views the 16-byte copies below cannot read: d not contiguous
//   or not a multiple of 4, a base or a stride off 16 bytes).  Bound: at the
//   rwkv6_7b serve shape (B 8, S 1024, H 64, dk = dv = 64, log_w f32, h0 and
//   hT) the bytes take 0.21 ms at 3.35 TB/s, the products over the visible
//   pairs (10.8 GFLOP) 0.16 ms at the 67 TFLOP/s of f32 on CUDA cores.
//   Design: one block of 256 threads per (b, h) walks the chunks in order --
//   the loop the TPU grid ran sequentially -- with the chunk staged in shared
//   memory as f32 element by element, one warp per column running the
//   cumulative sum as a shuffle scan, and 16 x 16 threads computing the chunk
//   products as small register tiles; the state lives in shared memory.  dk
//   and dv are zero-padded to 16, 32 or 64.  f32 throughout.
// * scalar_tc (bf16, q and k stride 0 over heads, log_w stride 0 over d:
//   Mamba2) and vector_tc (every other bf16 call: RWKV6).  Bound: bytes
//   (0.074 ms at the zamba2_7b prefill shape, 0.125 ms at the rwkv6 serve
//   one), since on tensor cores the products take 0.017 / 0.011 ms at 989
//   TFLOP/s.  What sets their time is the chain of dependent steps in a
//   chunk, walked 32 or 64 times in turn with 3-4 heads an SM: a block
//   alone on an SM takes 2.4-4 us a chunk.  Design: the products run on
//   mma.sync m16n8k16 (bf16 in, f32 sums; wgmma's 64-row tile is twice the
//   32-token chunk), the state held transposed in the mma accumulators of
//   the warp that owns its 16 dv columns, so it never leaves registers; the
//   next chunk's rows are copied in by cp.async while this one is computed;
//   y goes out through shared memory as 16-byte rows.  The f32 operands of
//   a product (the masked scores, the state, the decayed q, k and v) are
//   split into bf16 hi + lo halves: two products against a bf16 operand,
//   three (hi.hi + hi.lo + lo.hi) for two f32 factors.
//   scripts/decay_precision.py measured what this buys against a float64
//   oracle: with plain bf16 factors the final state misses its 2e-3 (2.1e-3
//   to 2.5e-3 of its scale), TF32 keeps it to 2.5e-4, the splits to 4.4e-6,
//   and the products' own share of the output's error stays under 6.3e-6 of
//   its scale.  Mamba2's path needs no factoring at all: one decay per head
//   makes e^(cum_i - cum_j) one f32 factor per pair, applied to C.B^T, which
//   is exact from bf16 inputs.  Both take d contiguous, a multiple of 8 up
//   to 64 (zero-padded to 64), and 16-byte aligned rows.
// * scalar_tc_f32 and vector_tc_f32 (f32 views whose rows the 16-byte
//   copies read: d contiguous, a multiple of 4 up to 64, base and strides on
//   16 bytes).  Bound: bytes, 4 of them an item: 0.145 ms at the zamba2_7b
//   prefill shape (C and B of a 7296-wide f32 row), 0.205 ms at the rwkv6
//   serve one; their products as three TF32 products a pair at 495 TFLOP/s
//   take 0.103 / 0.065 ms.  Design: the bf16 paths' blocks, warps, state in
//   the accumulators and cp.async copies, on mma.sync m16n8k8 tf32, every
//   product of two f32 factors three TF32 products (C.B^T and v now too),
//   the hi.hi products summed apart from the small ones; chunks staged as
//   f32 in swizzled rows and split into TF32 hi + lo as fragments are
//   loaded; y stored as f32 from the accumulators.  Precision sets the
//   split: three bf16 products keep each factor to 2^-17 and land 1.0e-5 to
//   1.7e-5 of the output's scale from a float64 oracle, ten times the plain
//   f32 form's 0.6e-6 to 3.4e-6, and the sequential oracle's f32 spread;
//   three TF32 products keep 2^-22.  And the cumulative log-decay is summed
//   in float64 and each factor taken as 2^n 2^f, since a float32 sum of 32
//   log-decays near the clip already costs the factors 2^-18 (most of the
//   plain f32 form's error): 1.7e-7 to 3.7e-7 in all
//   (scripts/decay_precision.py --dtype float32).  What sets their time, as
//   in bf16, is a chunk's chain, now of 3xTF32 products: 0.43 ms (47 % of
//   the bound) at the rwkv6 shape, 0.72 ms (20 %) at the zamba2 one (PERF.md,
//   NVIDIA H100 80GB HBM3 at 700 W).

// The mask is applied by a select, never by a multiply: a masked score of
// the factored form can be as large as e^57.6 |q||k| (or inf), and inf * 0
// is NaN.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kQ = 32;          // chunk length: one warp of lanes
constexpr int kThreads = 256;   // 16 x 16 threads for the chunk products
constexpr int kMaxD = 64;
constexpr float kMinLogDecay = -1.8f;

struct Params {
  int B, S, H, dk, dv, use_bonus;
  long long q[4], k[4], v[4], w[4], o[4];  // element strides (b, s, h, d)
  const float* u;                           // (H, dk) or null
  const float* h0;                          // (B, H, dk, dv) or null (zeros)
  float* hT;                                // (B, H, dk, dv) or null
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// q, k, v, w [kQ][D+1]; a [kQ][kQ+1]; s [D][D]; decay [D]; diag [kQ]
template <int D>
constexpr int smem_floats() {
  return 4 * kQ * (D + 1) + kQ * (kQ + 1) + D * D + D + kQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) decay_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ lw, T* __restrict__ out, Params p) {
  constexpr int P = D + 1, PA = kQ + 1, N = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;               // q, then qs = q e^(ecum or cum)
  float* k_s = q_s + kQ * P;       // k, then ks = k e^-cum
  float* v_s = k_s + kQ * P;
  float* w_s = v_s + kQ * P;       // log_w, then k e^(total - cum)
  float* a_s = w_s + kQ * P;       // masked scores
  float* s_s = a_s + kQ * PA;      // the state
  float* decay_s = s_s + D * D;    // e^total per state row
  float* diag_s = decay_s + D;     // (q*u).k per chunk row

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4, warp = tid >> 5, lane = tid & 31;
  const T* qb = q + b * p.q[0] + h * p.q[2];
  const T* kb = k + b * p.k[0] + h * p.k[2];
  const T* vb = v + b * p.v[0] + h * p.v[2];
  const float* wb = lw + b * p.w[0] + h * p.w[2];
  T* ob = out + b * p.o[0] + h * p.o[2];
  const long long state_off = ((long long)b * p.H + h) * p.dk * p.dv;

  for (int i = tid; i < D * D; i += kThreads) {
    const int c = i / D, e = i - c * D;
    s_s[i] = p.h0 && c < p.dk && e < p.dv ? p.h0[state_off + c * p.dv + e] : 0.f;
  }

  const int n_chunks = (p.S + kQ - 1) / kQ;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int s0 = ch * kQ, rows = min(kQ, p.S - s0);

    // 1. stage the chunk in f32; rows past S and columns past dk / dv are 0
    for (int i = tid; i < kQ * D; i += kThreads) {
      const int r = i / D, c = i - r * D;
      const long long s = s0 + r;
      const bool kin = r < rows && c < p.dk, vin = r < rows && c < p.dv;
      q_s[r * P + c] = kin ? to_f32(qb[s * p.q[1] + c * p.q[3]]) : 0.f;
      k_s[r * P + c] = kin ? to_f32(kb[s * p.k[1] + c * p.k[3]]) : 0.f;
      w_s[r * P + c] = kin ? wb[s * p.w[1] + c * p.w[3]] : 0.f;
      v_s[r * P + c] = vin ? to_f32(vb[s * p.v[1] + c * p.v[3]]) : 0.f;
    }
    if (tid < kQ) diag_s[tid] = 0.f;
    __syncthreads();

    // 2. one warp per column, lane = row: cumulative log-decay by a shuffle
    //    scan, then qs, ks and k e^(total - cum) in place, and the bonus term
    float diag = 0.f;
    for (int c = warp; c < D; c += kThreads / 32) {
      const float l = fminf(fmaxf(w_s[lane * P + c], kMinLogDecay), 0.f);
      float cum = l;
#pragma unroll
      for (int off = 1; off < kQ; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, cum, off);
        if (lane >= off) cum += up;
      }
      const float total = __shfl_sync(0xffffffffu, cum, kQ - 1);
      const float qv = q_s[lane * P + c], kv = k_s[lane * P + c];
      if (p.use_bonus && c < p.dk) diag += qv * p.u[h * p.dk + c] * kv;
      q_s[lane * P + c] = qv * expf(p.use_bonus ? cum - l : cum);
      k_s[lane * P + c] = kv * expf(-cum);
      w_s[lane * P + c] = kv * expf(total - cum);
      if (lane == 0) decay_s[c] = expf(total);
    }
    if (p.use_bonus) atomicAdd(&diag_s[lane], diag);
    __syncthreads();

    // 3. scores a[i][j] = qs[i] . ks[j] where visible, else 0 (a select)
    {
      float acc[2][2] = {};
      for (int c = 0; c < D; ++c) {
        const float q0 = q_s[ty * P + c], q1 = q_s[(ty + 16) * P + c];
        const float k0 = k_s[tx * P + c], k1 = k_s[(tx + 16) * P + c];
        acc[0][0] += q0 * k0;
        acc[0][1] += q0 * k1;
        acc[1][0] += q1 * k0;
        acc[1][1] += q1 * k1;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int i = ty + 16 * r, j = tx + 16 * n;
          const bool visible = p.use_bonus ? j < i : j <= i;
          a_s[i * PA + j] = visible ? acc[r][n] : 0.f;
        }
    }
    __syncthreads();

    // 4. y[i][e] = a[i] . v[:, e] (+ diag[i] v[i][e]) + qs[i] . S[:, e] for
    //    rows ty, ty + 16 and columns tx + 16 n
    {
      float acc[2][N];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const int i = ty + 16 * r;
          acc[r][n] = p.use_bonus ? diag_s[i] * v_s[i * P + tx + 16 * n] : 0.f;
        }
      for (int j = 0; j < kQ; ++j) {
        const float a0 = a_s[ty * PA + j], a1 = a_s[(ty + 16) * PA + j];
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const float vv = v_s[j * P + tx + 16 * n];
          acc[0][n] += a0 * vv;
          acc[1][n] += a1 * vv;
        }
      }
      for (int c = 0; c < D; ++c) {
        const float q0 = q_s[ty * P + c], q1 = q_s[(ty + 16) * P + c];
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const float sv = s_s[c * D + tx + 16 * n];
          acc[0][n] += q0 * sv;
          acc[1][n] += q1 * sv;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = ty + 16 * r;
        if (i >= rows) continue;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const int e = tx + 16 * n;
          if (e < p.dv) store_as(ob + (long long)(s0 + i) * p.o[1] + e * p.o[3], acc[r][n]);
        }
      }
    }
    __syncthreads();

    // 5. S[c][e] = S[c][e] e^total[c] + sum_i kend[i][c] v[i][e] for rows
    //    ty + 16 m and columns tx + 16 n (each thread owns its cells)
    {
      float acc[N][N];
#pragma unroll
      for (int m = 0; m < N; ++m)
#pragma unroll
        for (int n = 0; n < N; ++n)
          acc[m][n] = s_s[(ty + 16 * m) * D + tx + 16 * n] * decay_s[ty + 16 * m];
      for (int i = 0; i < kQ; ++i) {
        float kend[N], vv[N];
#pragma unroll
        for (int m = 0; m < N; ++m) kend[m] = w_s[i * P + ty + 16 * m];
#pragma unroll
        for (int n = 0; n < N; ++n) vv[n] = v_s[i * P + tx + 16 * n];
#pragma unroll
        for (int m = 0; m < N; ++m)
#pragma unroll
          for (int n = 0; n < N; ++n) acc[m][n] += kend[m] * vv[n];
      }
#pragma unroll
      for (int m = 0; m < N; ++m)
#pragma unroll
        for (int n = 0; n < N; ++n) s_s[(ty + 16 * m) * D + tx + 16 * n] = acc[m][n];
    }
    __syncthreads();
  }

  if (p.hT) {
    for (int i = tid; i < D * D; i += kThreads) {
      const int c = i / D, e = i - c * D;
      if (c < p.dk && e < p.dv) p.hT[state_off + c * p.dv + e] = s_s[i];
    }
  }
}

template <typename T, int D>
int launch_d(const T* q, const T* k, const T* v, const float* lw, T* out, const Params& p,
             cudaStream_t st) {
  constexpr int smem = smem_floats<D>() * (int)sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decay_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  decay_kernel<T, D><<<dim3(p.H, p.B), kThreads, smem, st>>>(q, k, v, lw, out, p);
  return (int)cudaGetLastError();
}

// dims: B, S, H, dk, dv; strides: q, k, v, log_w, out, each (b, s, h, d).
// Returns 0 or a cudaError_t.
template <typename T>
int launch(const void* q, const void* k, const void* v, const void* lw, const void* u,
           const void* h0, void* out, void* hT, const long long* dims,
           const long long* strides, int use_bonus, void* stream) {
  Params p;
  p.B = (int)dims[0], p.S = (int)dims[1], p.H = (int)dims[2];
  p.dk = (int)dims[3], p.dv = (int)dims[4];
  p.use_bonus = use_bonus;
  long long* s[5] = {p.q, p.k, p.v, p.w, p.o};
  for (int t = 0; t < 5; ++t)
    for (int i = 0; i < 4; ++i) s[t][i] = strides[4 * t + i];
  p.u = static_cast<const float*>(u);
  p.h0 = static_cast<const float*>(h0);
  p.hT = static_cast<float*>(hT);
  if (p.B <= 0 || p.H <= 0) return 0;
  if (p.S < 0 || p.dk < 1 || p.dv < 1 || p.dk > kMaxD || p.dv > kMaxD || p.B > 65535 ||
      (use_bonus && !u))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const float* wt = static_cast<const float*>(lw);
  T* ot = static_cast<T*>(out);
  const int d = p.dk > p.dv ? p.dk : p.dv;
  if (d <= 16) return launch_d<T, 16>(qt, kt, vt, wt, ot, p, st);
  if (d <= 32) return launch_d<T, 32>(qt, kt, vt, wt, ot, p, st);
  return launch_d<T, 64>(qt, kt, vt, wt, ot, p, st);
}


// -- bfloat16 on tensor cores (mma.sync m16n8k16, f32 accumulators) ------------

constexpr int kTcD = 64;            // dk and dv, zero-padded to 64
constexpr int kRow = kTcD + 8;      // a shared row: 64 bf16 + 16 bytes, so ldmatrix is conflict-free
constexpr int kTile = kQ * kRow;    // one chunk of q, k or v (bf16 elements)
constexpr int kARow = kQ + 8;       // a shared row of 32 bf16 scores (+16 bytes)

template <typename T>   // q, k, v and out: bfloat16 or float32
struct TcParamsT {
  int B, S, H, dk, dv, use_bonus;
  long long q[4], k[4], v[4], w[4], o[4];  // element strides (b, s, h, d)
  const T *qp, *kp, *vp;
  const float* wp;                          // log_w
  const float* u;                           // (H, dk) or null
  const float* h0;                          // (B, H, dk, dv) or null (zeros)
  T* op;
  float* hT;                                // (B, H, dk, dv) or null
};
using TcParams = TcParamsT<__nv_bfloat16>;
using F32Params = TcParamsT<float>;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared, asynchronously; zeros when !valid (nothing read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// four 8x8 b16 matrices; lanes 8m..8m+7 give the row addresses of matrix m
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
}

// a pair of f32 values as bf16 hi + lo halves (x = hi + lo to about 2^-16 of x)
struct Split2 {
  uint32_t hi, lo;
};
__device__ __forceinline__ Split2 split2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  return {as_u32(h), as_u32(__floats2bfloat162_rn(a - hf.x, b - hf.y))};
}

// -- fragments shared by the two tensor-core paths: the state S^T of a warp is
// 16 dv rows (16 cs + r4, + 8) x 64 dk columns (8 n + 2 c4, + 1), 8 mma tiles

template <typename P>
__device__ __forceinline__ void load_state(float (&s)[8][4], const P& p, long long off, int cs,
                                           int lane, bool valid) {
  const int r4 = lane >> 2, c4 = lane & 3;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int e = 16 * cs + r4 + (x >> 1) * 8, c = 8 * n + 2 * c4 + (x & 1);
      s[n][x] = valid && p.h0 && c < p.dk && e < p.dv ? p.h0[off + c * p.dv + e] : 0.f;
    }
}

template <typename P>
__device__ __forceinline__ void store_state(const float (&s)[8][4], const P& p, long long off,
                                            int cs, int lane, bool valid) {
  const int r4 = lane >> 2, c4 = lane & 3;
  if (!valid || !p.hT) return;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int e = 16 * cs + r4 + (x >> 1) * 8, c = 8 * n + 2 * c4 + (x & 1);
      if (c < p.dk && e < p.dv) p.hT[off + c * p.dv + e] = s[n][x];
    }
}

// S^T's tiles 2 ks and 2 ks + 1 as the A fragment of dk step ks, bf16 hi + lo
__device__ __forceinline__ void state_frag(const float (&s)[8][4], int ks, uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  const Split2 x0 = split2(s[2 * ks][0], s[2 * ks][1]), x1 = split2(s[2 * ks][2], s[2 * ks][3]);
  const Split2 x2 = split2(s[2 * ks + 1][0], s[2 * ks + 1][1]);
  const Split2 x3 = split2(s[2 * ks + 1][2], s[2 * ks + 1][3]);
  hi[0] = x0.hi, hi[1] = x1.hi, hi[2] = x2.hi, hi[3] = x3.hi;
  lo[0] = x0.lo, lo[1] = x1.lo, lo[2] = x2.lo, lo[3] = x3.lo;
}

// v^T (dv 16 cs.., tokens 16 k2..) as the A fragments of token steps k2 = 0, 1
__device__ __forceinline__ void load_vt(uint32_t (&va)[2][4], const __nv_bfloat16* v_s, int cs,
                                        int lane) {
#pragma unroll
  for (int k2 = 0; k2 < 2; ++k2)
    ldmatrix_x4_trans(va[k2], v_s + (16 * k2 + ((lane >> 4) << 3) + (lane & 7)) * kRow +
                                  16 * cs + ((lane >> 3) & 1) * 8);
}

// y^T (16 dv x 32 tokens of the chunk at s0) out as bf16, staged through
// the warp's own 16 columns of this chunk's v in shared memory (vcols; no
// other warp reads them, and this warp holds them in registers already):
// partner lanes (lane ^ 4) hold the neighbouring dv column of the same
// tokens, so each trades one value to write a pair; then each lane stores
// 16 bytes of a token row
__device__ __forceinline__ void store_yT(const float (&y)[4][4], const TcParams& p,
                                         __nv_bfloat16* ob, int s0, int cs, int lane,
                                         __nv_bfloat16* vcols) {
  const int r4 = lane >> 2, c4 = lane & 3;
  const bool odd = r4 & 1;
  __syncwarp();
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float x0 = y[n][2 * hf], x1 = y[n][2 * hf + 1];
      const float got = __shfl_xor_sync(0xffffffffu, odd ? x0 : x1, 4);
      const int t = 8 * n + 2 * c4 + (odd ? 1 : 0), e = (r4 & ~1) + 8 * hf;
      *reinterpret_cast<__nv_bfloat162*>(vcols + t * kRow + e) =
          odd ? __floats2bfloat162_rn(got, x1) : __floats2bfloat162_rn(x0, got);
    }
  __syncwarp();
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    const int t = 16 * it + (lane >> 1), e = 8 * (lane & 1);
    if (s0 + t < p.S && 16 * cs + e < p.dv)
      *reinterpret_cast<uint4*>(ob + (s0 + t) * p.o[1] + 16 * cs + e) =
          *reinterpret_cast<const uint4*>(vcols + t * kRow + e);
  }
}

// a score under the mask, by a select (never a multiply: a masked score of
// the factored form can be as large as e^57.6 |q||k|): visible j < i with the
// bonus, whose term takes the diagonal, j <= i without
__device__ __forceinline__ float masked(float a, int i, int j, int bonus, float diag) {
  if (bonus) return j < i ? a : (j == i ? diag : 0.f);
  return j <= i ? a : 0.f;
}

// the four warps of head group member hh (named barrier 1 + hh)
__device__ __forceinline__ void head_barrier(int hh) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + hh) : "memory");
}

// Mamba2's scalar decay.  One block per (batch row, group of G heads) shares
// the chunk's C and B rows; four warps per head, warp cs owning dv columns
// 16cs..16cs+15, with the state held transposed in its mma accumulators
// (S^T: 16 dv rows x 64 dk, 32 registers a thread).  Per 32-token chunk
// (double-buffered through cp.async, the next chunk in flight while this
// one is computed):
//   y^T  = (S^T C^T) e^(qcum_i)  +  v^T A^T,  A_ij = (C.B^T)_ij e^(qcum_i - cum_j)
//   S^T <- S^T e^total  +  (w o v)^T B,        w_j = e^(total - cum_j) <= 1
// A is built once per head: each of its warps makes 8 columns of A^T =
// B.C^T on tensor cores (exact: bf16 inputs, f32 sums), scales, masks and
// splits them into shared memory, and the four meet at a named barrier.
// A, S and w o v, the f32 operands, go in as bf16 hi + lo halves (two
// products); C, B and v are bf16 already.  No factor exceeds 1 in magnitude
// beyond e^(-cum_j) <= e^57.6, which is applied in f32 before the split.
// With the bonus, the mask is strict and A_ii = (C_i o u) . B_i.
constexpr int kScalarHeads = 2;   // heads per block (1, 2 and 4 measured: 2 and 4 level, 1 slower)

__global__ void __launch_bounds__(128 * kScalarHeads) decay_scalar_tc(TcParams p) {
  constexpr int G = kScalarHeads, kThreadsG = 128 * G;
  constexpr int kStage = (2 + G) * kTile * 2 + G * kQ * 4;   // bytes of one chunk
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // per head: A^T hi, A^T lo [kQ][kARow]
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + 2 * kStage);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r4 = lane >> 2, c4 = lane & 3;
  const int hh = warp >> 2, cs = warp & 3;
  const int hbase = blockIdx.x * G, b = blockIdx.y, h = hbase + hh;
  const bool hvalid = h < p.H;
  const __nv_bfloat16* cb = p.qp + b * p.q[0];   // C (q), shared by the heads
  const __nv_bfloat16* bb = p.kp + b * p.k[0];   // B (k)
  const __nv_bfloat16* vb = p.vp + b * p.v[0];
  const float* wb = p.wp + b * p.w[0];
  const int n_chunks = (p.S + kQ - 1) / kQ;

  auto stage_c = [&](int st) {
    return reinterpret_cast<__nv_bfloat16*>(smem_raw + st * kStage);
  };
  auto stage_l = [&](int st) {
    return reinterpret_cast<float*>(smem_raw + st * kStage + (2 + G) * kTile * 2);
  };

  auto load_chunk = [&](int ch, int st) {
    const int s0 = ch * kQ;
    __nv_bfloat16* c_s = stage_c(st);
    for (int i = tid; i < (2 + G) * kQ * 8; i += kThreadsG) {
      const int t = i / (kQ * 8), r = (i >> 3) % kQ, c8 = (i & 7) * 8, s = s0 + r;
      const __nv_bfloat16* src;
      bool ok = s < p.S;
      if (t == 0) {
        ok = ok && c8 < p.dk;
        src = cb + (ok ? s * p.q[1] + c8 : 0);
      } else if (t == 1) {
        ok = ok && c8 < p.dk;
        src = bb + (ok ? s * p.k[1] + c8 : 0);
      } else {
        const int hg = hbase + t - 2;
        ok = ok && c8 < p.dv && hg < p.H;
        src = vb + (ok ? s * p.v[1] + hg * p.v[2] + c8 : 0);
      }
      cp_async16(c_s + t * kTile + r * kRow + c8, src, ok);
    }
    float* l_s = stage_l(st);
    for (int i = tid; i < G * kQ; i += kThreadsG) {
      const int g = i / kQ, r = i % kQ, s = s0 + r, hg = hbase + g;
      const bool ok = s < p.S && hg < p.H;
      cp_async4(l_s + i, wb + (ok ? s * p.w[1] + hg * p.w[2] : 0), ok);
    }
    cp_async_commit();
  };

  float sacc[8][4];
  const long long state_off = ((long long)b * p.H + h) * p.dk * p.dv;
  load_state(sacc, p, state_off, cs, lane, hvalid);

  if (n_chunks > 0) load_chunk(0, 0);
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int st = ch & 1, s0 = ch * kQ;
    cp_async_wait_all();
    __syncthreads();   // chunk ch is in; every warp is done with chunk ch - 1
    if (ch + 1 < n_chunks) load_chunk(ch + 1, st ^ 1);
    const __nv_bfloat16* c_s = stage_c(st);
    const __nv_bfloat16* b_s = c_s + kTile;
    __nv_bfloat16* v_s = stage_c(st) + (2 + hh) * kTile;

    if (!hvalid) continue;

    // The products that need no decay go first, so that their latency runs
    // under the scan and the exponentials: A^T = B.C^T for this warp's
    // columns i = 8 cs..8 cs + 7 (exact: bf16 inputs, f32 sums; 2 tiles of
    // 16 x 8), and S^T C^T (16 dv x 32 tokens; S^T split into bf16 hi + lo)
    float gt[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t cf[4];
      ldmatrix_x4(cf, c_s + (8 * cs + (lane & 7)) * kRow + 32 * kk + (lane >> 3) * 8);
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          uint32_t bfr[4];
          ldmatrix_x4(bfr, b_s + (16 * m + (lane & 15)) * kRow + 32 * kk + 16 * h2 +
                               (lane >> 4) * 8);
          mma_bf16(gt[m], bfr, cf[2 * h2], cf[2 * h2 + 1]);
        }
    }
    float yz[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n) yz[n][0] = yz[n][1] = yz[n][2] = yz[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t ahi[4], alo[4];
      state_frag(sacc, ks, ahi, alo);
#pragma unroll
      for (int n2 = 0; n2 < 2; ++n2) {
        uint32_t cf[4];
        ldmatrix_x4(cf, c_s + (16 * n2 + ((lane >> 4) << 3) + (lane & 7)) * kRow + 16 * ks +
                            ((lane >> 3) & 1) * 8);
        mma_bf16(yz[2 * n2], ahi, cf[0], cf[1]);
        mma_bf16(yz[2 * n2], alo, cf[0], cf[1]);
        mma_bf16(yz[2 * n2 + 1], ahi, cf[2], cf[3]);
        mma_bf16(yz[2 * n2 + 1], alo, cf[2], cf[3]);
      }
    }

    // per lane = token: the cumulative log-decay, by a shuffle scan
    const float l = fminf(fmaxf(stage_l(st)[hh * kQ + lane], kMinLogDecay), 0.f);
    float cum = l;
#pragma unroll
    for (int off = 1; off < kQ; off <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, cum, off);
      if (lane >= off) cum += up;
    }
    const float total = __shfl_sync(0xffffffffu, cum, kQ - 1);
    const float eq = expf(p.use_bonus ? cum - l : cum);   // <= 1
    const float ek = expf(-cum);                            // <= e^57.6
    const float etot = expf(total);
    float diag = 0.f;
    if (p.use_bonus) {
      const float* uh = p.u + (long long)h * p.dk;
      for (int c = 0; c < p.dk; ++c)
        diag += __bfloat162float(c_s[lane * kRow + c]) * uh[c] * __bfloat162float(b_s[lane * kRow + c]);
    }
    // this thread's tokens as columns of y^T: J = 2c4 + e + 8m (index 2m + e)
    float eqJ[8], ekJ[8];
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        eqJ[2 * m + e] = __shfl_sync(0xffffffffu, eq, 2 * c4 + e + 8 * m);
        ekJ[2 * m + e] = __shfl_sync(0xffffffffu, ek, 2 * c4 + e + 8 * m);
      }

    // A = (C.B^T) e^(qcum_i - cum_j) under the mask (a select, never a
    // multiply), built once for the head by its four warps and stored
    // transposed as bf16 hi + lo; gt[m][x] is A^T's j = 16 m + r4 + 8 (x >> 1),
    // i = 8 cs + 2 c4 + (x & 1)
    __nv_bfloat16* at_hi = a_s + hh * 2 * kQ * kARow;
    __nv_bfloat16* at_lo = at_hi + kQ * kARow;
    {
      const int i0 = 8 * cs + 2 * c4;
      const float eq0 = __shfl_sync(0xffffffffu, eq, i0), eq1 = __shfl_sync(0xffffffffu, eq, i0 + 1);
      const float dg0 = __shfl_sync(0xffffffffu, diag, i0);
      const float dg1 = __shfl_sync(0xffffffffu, diag, i0 + 1);
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int j = 16 * m + r4 + 8 * hf;
          const float ekj = __shfl_sync(0xffffffffu, ek, j);
          const Split2 x = split2(masked(gt[m][2 * hf] * eq0 * ekj, i0, j, p.use_bonus, dg0),
                                  masked(gt[m][2 * hf + 1] * eq1 * ekj, i0 + 1, j, p.use_bonus, dg1));
          *reinterpret_cast<uint32_t*>(at_hi + j * kARow + i0) = x.hi;
          *reinterpret_cast<uint32_t*>(at_lo + j * kARow + i0) = x.lo;
        }
    }

    uint32_t va[2][4];
    load_vt(va, v_s, cs, lane);
    head_barrier(hh);   // the head's A is in
    // y^T = (S^T C^T) e^(qcum_i) + v^T A^T
    float yacc[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      yacc[n][0] = yz[n][0] * eqJ[2 * n];
      yacc[n][1] = yz[n][1] * eqJ[2 * n + 1];
      yacc[n][2] = yz[n][2] * eqJ[2 * n];
      yacc[n][3] = yz[n][3] * eqJ[2 * n + 1];
    }
#pragma unroll
    for (int k2 = 0; k2 < 2; ++k2)
#pragma unroll
      for (int n2 = 0; n2 < 2; ++n2) {
        uint32_t ah[4], al[4];
        const int ao = (16 * k2 + ((lane >> 3) & 1) * 8 + (lane & 7)) * kARow + 16 * n2 +
                       (lane >> 4) * 8;
        ldmatrix_x4_trans(ah, at_hi + ao);
        ldmatrix_x4_trans(al, at_lo + ao);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          mma_bf16(yacc[2 * n2 + e], va[k2], ah[2 * e], ah[2 * e + 1]);
          mma_bf16(yacc[2 * n2 + e], va[k2], al[2 * e], al[2 * e + 1]);
        }
      }

    store_yT(yacc, p, p.op + b * p.o[0] + h * p.o[2], s0, cs, lane, v_s + 16 * cs);

    // S^T <- S^T e^total + (w o v)^T B, (w o v)^T split (w scales the
    // tokens, the k index of the v^T fragments: j0, j0 + 1, j0 + 8, j0 + 9)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x) sacc[n][x] *= etot;
#pragma unroll
    for (int k2 = 0; k2 < 2; ++k2) {
      const float w0 = etot * ekJ[4 * k2], w1 = etot * ekJ[4 * k2 + 1];
      const float w2 = etot * ekJ[4 * k2 + 2], w3 = etot * ekJ[4 * k2 + 3];
      const float2 v0 = unpack(va[k2][0]), v1 = unpack(va[k2][1]);
      const float2 v2 = unpack(va[k2][2]), v3 = unpack(va[k2][3]);
      const Split2 x0 = split2(v0.x * w0, v0.y * w1), x1 = split2(v1.x * w0, v1.y * w1);
      const Split2 x2 = split2(v2.x * w2, v2.y * w3), x3 = split2(v3.x * w2, v3.y * w3);
      const uint32_t whi[4] = {x0.hi, x1.hi, x2.hi, x3.hi};
      const uint32_t wlo[4] = {x0.lo, x1.lo, x2.lo, x3.lo};
#pragma unroll
      for (int n2 = 0; n2 < 4; ++n2) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, b_s + (16 * k2 + ((lane >> 3) & 1) * 8 + (lane & 7)) * kRow +
                                  16 * n2 + (lane >> 4) * 8);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          mma_bf16(sacc[2 * n2 + hf], whi, bf[2 * hf], bf[2 * hf + 1]);
          mma_bf16(sacc[2 * n2 + hf], wlo, bf[2 * hf], bf[2 * hf + 1]);
        }
      }
    }
  }

  store_state(sacc, p, state_off, cs, lane, hvalid);
}

// RWKV6's vector decay (one decay per state row) with the bonus.  One block of
// four warps per (b, h), warp w owning dv columns 16w..16w+15 of the state,
// held transposed in its mma accumulators as in the scalar path.  Per chunk:
//   prep   (thread = column pair x 8 tokens): the cumulative log-decay per
//          column (a scan of 8 in registers, then the other warps' partial
//          sums), qs = q e^(qcum), ks = k e^(-cum) (up to e^57.6) and
//          kend = k e^(total - cum) (<= 1), each stored as bf16 hi + lo;
//          (q o u) . k per token;
//   A      = qs ks^T, 32 x 32, one 16 x 8 tile pair a warp, three products
//          (hi.hi + hi.lo + lo.hi: both factors are f32), masked (a select)
//          with the bonus on its diagonal, stored as bf16 hi + lo;
//   y^T    = S^T qs^T (three products) + v^T A^T (two);
//   S^T   <- S^T o e^total + v^T kend (two).
// q, k and log_w are single-buffered (the next chunk's copies start once
// prep has read them), v double-buffered; all of them land while this
// chunk's products run.
constexpr int kVecThreads = 128;
constexpr int kWRow = kTcD + 4;   // a shared row of 64 f32 log-decays (+16 bytes)

// shared layout of the vector path (bytes)
constexpr int kVecV = 0;                            // v, two stages
constexpr int kVecQ = kVecV + 2 * kTile * 2;        // q, then k
constexpr int kVecW = kVecQ + 2 * kTile * 2;        // log_w [kQ][kWRow]
constexpr int kVecSplit = kVecW + kQ * kWRow * 4;   // qs hi, qs lo, ks hi, ks lo, kend hi, kend lo
constexpr int kVecPart = kVecSplit + 6 * kTile * 2; // per-warp partial sums [4][kTcD]
constexpr int kVecTot = kVecPart + 4 * kTcD * 4;    // e^total per column [kTcD]
constexpr int kVecDiag = kVecTot + kTcD * 4;        // (q o u) . k per token [kQ]
constexpr int kVecSmem = kVecDiag + kQ * 4;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__global__ void __launch_bounds__(kVecThreads, 4) decay_vector_tc(TcParams p) {
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + kVecQ);
  __nv_bfloat16* k_s = q_s + kTile;
  float* w_s = reinterpret_cast<float*>(smem_raw + kVecW);
  __nv_bfloat16* qs_hi = reinterpret_cast<__nv_bfloat16*>(smem_raw + kVecSplit);
  __nv_bfloat16* qs_lo = qs_hi + kTile;
  __nv_bfloat16* ks_hi = qs_hi + 2 * kTile;   // A hi and lo [kQ][kARow] alias ks once it is read
  __nv_bfloat16* ks_lo = qs_hi + 3 * kTile;
  __nv_bfloat16* ke_hi = qs_hi + 4 * kTile;
  __nv_bfloat16* ke_lo = qs_hi + 5 * kTile;
  __nv_bfloat16* a_hi = ks_hi;
  __nv_bfloat16* a_lo = ks_hi + kQ * kARow;
  float* part_s = reinterpret_cast<float*>(smem_raw + kVecPart);
  float* etot_s = reinterpret_cast<float*>(smem_raw + kVecTot);
  float* diag_s = reinterpret_cast<float*>(smem_raw + kVecDiag);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r4 = lane >> 2, c4 = lane & 3, cs = warp;
  const int h = blockIdx.x, b = blockIdx.y;
  const __nv_bfloat16* qb = p.qp + b * p.q[0] + h * p.q[2];
  const __nv_bfloat16* kb = p.kp + b * p.k[0] + h * p.k[2];
  const __nv_bfloat16* vb = p.vp + b * p.v[0] + h * p.v[2];
  const float* wb = p.wp + b * p.w[0] + h * p.w[2];
  const int n_chunks = (p.S + kQ - 1) / kQ;

  auto v_stage = [&](int st) {
    return reinterpret_cast<__nv_bfloat16*>(smem_raw + kVecV) + st * kTile;
  };
  // q, k, log_w (single buffers) and v (stage st) of chunk ch, zeros past S and d
  auto load_chunk = [&](int ch, int st) {
    const int s0 = ch * kQ;
    __nv_bfloat16* v_s = v_stage(st);
    for (int i = tid; i < 3 * kQ * 8; i += kVecThreads) {
      const int t = i / (kQ * 8), r = (i >> 3) % kQ, c8 = (i & 7) * 8, s = s0 + r;
      const bool ok = s < p.S && c8 < (t == 2 ? p.dv : p.dk);
      const __nv_bfloat16* src = t == 0 ? qb + (ok ? s * p.q[1] + c8 : 0)
                                 : t == 1 ? kb + (ok ? s * p.k[1] + c8 : 0)
                                          : vb + (ok ? s * p.v[1] + c8 : 0);
      cp_async16((t == 2 ? v_s : q_s + t * kTile) + r * kRow + c8, src, ok);
    }
    for (int i = tid; i < kQ * 16; i += kVecThreads) {
      const int r = i >> 4, c4w = (i & 15) * 4, s = s0 + r;
      const bool ok = s < p.S && c4w < p.dk;
      cp_async16(w_s + r * kWRow + c4w, wb + (ok ? s * p.w[1] + c4w : 0), ok);
    }
    cp_async_commit();
  };

  float sacc[8][4];
  const long long state_off = ((long long)b * p.H + h) * p.dk * p.dv;
  load_state(sacc, p, state_off, cs, lane, true);

  if (n_chunks > 0) load_chunk(0, 0);
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int st = ch & 1, s0 = ch * kQ;
    cp_async_wait_all();
    __syncthreads();   // chunk ch is in; every warp is done with chunk ch - 1

    // prep, 1: per column pair (2 lane, 2 lane + 1), tokens 8 warp..8 warp + 7:
    // the scan of the clipped log2-decays over this warp's 8 tokens
    const int c2 = 2 * lane, t0 = 8 * warp;
    float2 lw2[8], cum[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const float2 w = *reinterpret_cast<const float2*>(w_s + (t0 + t) * kWRow + c2);
      lw2[t] = make_float2(fminf(fmaxf(w.x, kMinLogDecay), 0.f) * kLog2e,
                           fminf(fmaxf(w.y, kMinLogDecay), 0.f) * kLog2e);
      cum[t] = t ? make_float2(cum[t - 1].x + lw2[t].x, cum[t - 1].y + lw2[t].y) : lw2[0];
    }
    *reinterpret_cast<float2*>(part_s + warp * kTcD + c2) = cum[7];
    // (q o u) . k of token t0 + r4 over columns 16 c4..16 c4 + 15
    if (p.use_bonus) {
      const int t = t0 + r4;
      float d = 0.f;
#pragma unroll
      for (int c = 16 * c4; c < 16 * c4 + 16; c += 2) {
        if (c >= p.dk) break;
        const float2 qv = unpack(*reinterpret_cast<const uint32_t*>(q_s + t * kRow + c));
        const float2 kv = unpack(*reinterpret_cast<const uint32_t*>(k_s + t * kRow + c));
        const float* uh = p.u + (long long)h * p.dk + c;
        d += qv.x * uh[0] * kv.x + qv.y * uh[1] * kv.y;
      }
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      if (c4 == 0) diag_s[t] = d;
    }
    __syncthreads();

    // prep, 2: the other warps' partial sums; qs, ks and kend as bf16 hi + lo
    {
      float2 off = make_float2(0.f, 0.f), tot = make_float2(0.f, 0.f);
#pragma unroll
      for (int w2 = 0; w2 < 4; ++w2) {
        const float2 pw = *reinterpret_cast<const float2*>(part_s + w2 * kTcD + c2);
        if (w2 < warp) off = make_float2(off.x + pw.x, off.y + pw.y);
        tot = make_float2(tot.x + pw.x, tot.y + pw.y);
      }
      const float etx = ex2(tot.x), ety = ex2(tot.y);
      if (warp == 0) *reinterpret_cast<float2*>(etot_s + c2) = make_float2(etx, ety);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int r = t0 + t;
        const float cx = cum[t].x + off.x, cy = cum[t].y + off.y;
        const float qx = p.use_bonus ? cx - lw2[t].x : cx, qy = p.use_bonus ? cy - lw2[t].y : cy;
        const float ekx = ex2(-cx), eky = ex2(-cy);   // <= e^57.6
        const float2 qv = unpack(*reinterpret_cast<const uint32_t*>(q_s + r * kRow + c2));
        const float2 kv = unpack(*reinterpret_cast<const uint32_t*>(k_s + r * kRow + c2));
        const Split2 qs = split2(qv.x * ex2(qx), qv.y * ex2(qy));
        const Split2 ks = split2(kv.x * ekx, kv.y * eky);
        const Split2 ke = split2(kv.x * (etx * ekx), kv.y * (ety * eky));
        const int o = r * kRow + c2;
        *reinterpret_cast<uint32_t*>(qs_hi + o) = qs.hi;
        *reinterpret_cast<uint32_t*>(qs_lo + o) = qs.lo;
        *reinterpret_cast<uint32_t*>(ks_hi + o) = ks.hi;
        *reinterpret_cast<uint32_t*>(ks_lo + o) = ks.lo;
        *reinterpret_cast<uint32_t*>(ke_hi + o) = ke.hi;
        *reinterpret_cast<uint32_t*>(ke_lo + o) = ke.lo;
      }
    }
    __syncthreads();   // the splits are in; q, k and log_w are free
    if (ch + 1 < n_chunks) load_chunk(ch + 1, st ^ 1);

    // A = qs ks^T: this warp's tiles (m, n = warp), m = 0, 1; three products
    float aacc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t kh[4], kl[4];
      const int ko = (8 * warp + (lane & 7)) * kRow + 32 * kk + (lane >> 3) * 8;
      ldmatrix_x4(kh, ks_hi + ko);
      ldmatrix_x4(kl, ks_lo + ko);
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          uint32_t qh[4], ql[4];
          const int qo = (16 * m + (lane & 15)) * kRow + 32 * kk + 16 * h2 + (lane >> 4) * 8;
          ldmatrix_x4(qh, qs_hi + qo);
          ldmatrix_x4(ql, qs_lo + qo);
          mma_bf16(aacc[m], qh, kh[2 * h2], kh[2 * h2 + 1]);
          mma_bf16(aacc[m], qh, kl[2 * h2], kl[2 * h2 + 1]);
          mma_bf16(aacc[m], ql, kh[2 * h2], kh[2 * h2 + 1]);
        }
    }
    __syncthreads();   // ks is read: A takes its place
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = 16 * m + r4 + 8 * hf, j = 8 * warp + 2 * c4;
        const float dg = p.use_bonus ? diag_s[i] : 0.f;
        const float a0 = masked(aacc[m][2 * hf], i, j, p.use_bonus, dg);
        const float a1 = masked(aacc[m][2 * hf + 1], i, j + 1, p.use_bonus, dg);
        const Split2 x = split2(a0, a1);
        *reinterpret_cast<uint32_t*>(a_hi + i * kARow + j) = x.hi;
        *reinterpret_cast<uint32_t*>(a_lo + i * kARow + j) = x.lo;
      }
    __syncthreads();   // A is in

    // y^T (16 dv x 32 tokens) = S^T qs^T, three products
    float yacc[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n) yacc[n][0] = yacc[n][1] = yacc[n][2] = yacc[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t ahi[4], alo[4];
      state_frag(sacc, ks, ahi, alo);
#pragma unroll
      for (int n2 = 0; n2 < 2; ++n2) {
        uint32_t qh[4], ql[4];
        const int qo = (16 * n2 + ((lane >> 4) << 3) + (lane & 7)) * kRow + 16 * ks +
                       ((lane >> 3) & 1) * 8;
        ldmatrix_x4(qh, qs_hi + qo);
        ldmatrix_x4(ql, qs_lo + qo);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          mma_bf16(yacc[2 * n2 + e], ahi, qh[2 * e], qh[2 * e + 1]);
          mma_bf16(yacc[2 * n2 + e], ahi, ql[2 * e], ql[2 * e + 1]);
          mma_bf16(yacc[2 * n2 + e], alo, qh[2 * e], qh[2 * e + 1]);
        }
      }
    }
    // y^T += v^T A^T, A split
    uint32_t va[2][4];
    load_vt(va, v_stage(st), cs, lane);
#pragma unroll
    for (int k2 = 0; k2 < 2; ++k2)
#pragma unroll
      for (int n2 = 0; n2 < 2; ++n2) {
        uint32_t ah[4], al[4];
        const int ao = (16 * n2 + ((lane >> 4) << 3) + (lane & 7)) * kARow + 16 * k2 +
                       ((lane >> 3) & 1) * 8;
        ldmatrix_x4(ah, a_hi + ao);
        ldmatrix_x4(al, a_lo + ao);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          mma_bf16(yacc[2 * n2 + e], va[k2], ah[2 * e], ah[2 * e + 1]);
          mma_bf16(yacc[2 * n2 + e], va[k2], al[2 * e], al[2 * e + 1]);
        }
      }
    store_yT(yacc, p, p.op + b * p.o[0] + h * p.o[2], s0, cs, lane, v_stage(st) + 16 * cs);

    // S^T <- S^T o e^total (per dk column) + v^T kend, kend split
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 et = *reinterpret_cast<const float2*>(etot_s + 8 * n + 2 * c4);
      sacc[n][0] *= et.x;
      sacc[n][1] *= et.y;
      sacc[n][2] *= et.x;
      sacc[n][3] *= et.y;
    }
#pragma unroll
    for (int k2 = 0; k2 < 2; ++k2)
#pragma unroll
      for (int n2 = 0; n2 < 4; ++n2) {
        uint32_t kh[4], kl[4];
        const int ko = (16 * k2 + ((lane >> 3) & 1) * 8 + (lane & 7)) * kRow + 16 * n2 +
                       (lane >> 4) * 8;
        ldmatrix_x4_trans(kh, ke_hi + ko);
        ldmatrix_x4_trans(kl, ke_lo + ko);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          mma_bf16(sacc[2 * n2 + hf], va[k2], kh[2 * hf], kh[2 * hf + 1]);
          mma_bf16(sacc[2 * n2 + hf], va[k2], kl[2 * hf], kl[2 * hf + 1]);
        }
      }
  }
  store_state(sacc, p, state_off, cs, lane, true);
}

// -- float32 on tensor cores (mma.sync m16n8k8 tf32, three products each) ----
//
// The f32 siblings of the two paths above: the same blocks, warps and state
// layout, every product of two f32 factors taken as three TF32 products
// (hi.hi + hi.lo + lo.hi; lo.lo, under 2^-22 of the product, is dropped),
// hi.hi summed apart from the two small ones and each product's sum begun
// from zero, so that the tensor core's truncating adder cuts each sum at its
// own scale (the state's update joins the state in one f32 FMA).  A
// fragment's k index runs over its 8 columns in the order 0, 2, 4, 6, 1, 3,
// 5, 7 (logical k c4 is column 2 c4, k c4 + 4 column 2 c4 + 1), the order of
// an mma accumulator's columns: the state in its accumulators is an A
// operand as it stands, and a row-major operand's pair is one 8-byte load.
// Chunks of 32 rows x 64 floats sit in shared memory with the 16-byte pieces
// of each row permuted (swz), so that the row-wise fragment loads, the
// column-wise loads of v and kend, the copies and the staged output each hit
// 32 distinct banks.  The cumulative log-decay is summed in float64 and each
// decay factor taken as 2^n 2^f (pow2): a float32 sum of 32 log-decays near
// the clip carries 2^-18 of error per step into every factor, which is what
// the plain chunked form in float32 loses (scripts/decay_precision.py).

constexpr int kF32Tile = kQ * kTcD;   // floats of one chunk of q, k, v, log_w or kend

// float index of (row, word) in a tile whose rows are `width` floats (64 or
// 32): the 16-byte pieces of a row permuted by f(row), which differs across
// rows 0..3, across rows 4..7, across the even rows and across the odd rows
// of each 8-row block (the rows a fragment's row-wise and column-wise loads
// take at once)
__device__ __forceinline__ int swz(int row, int word, int width = kTcD) {
  return row * width + (word ^ (((row & 3) ^ ((row >> 2) & 1)) << 3));
}

// x = hi + lo as the tensor core reads them: hi rounded to TF32 (to nearest,
// ties away, in two integer operations), lo = x - hi exact in f32 and read
// as its top 19 bits (flash_attention.cu's split)
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

// an A fragment, split: x0 (row r4, k c4), x1 (row r4 + 8, k c4), x2 (row
// r4, k c4 + 4), x3 (row r4 + 8, k c4 + 4)
struct FragA {
  uint32_t hi[4], lo[4];
};
__device__ __forceinline__ FragA frag_a(float x0, float x1, float x2, float x3) {
  FragA f;
  split_tf32(x0, f.hi[0], f.lo[0]);
  split_tf32(x1, f.hi[1], f.lo[1]);
  split_tf32(x2, f.hi[2], f.lo[2]);
  split_tf32(x3, f.hi[3], f.lo[3]);
  return f;
}

// a B fragment, split: x0 (k c4, column r4), x1 (k c4 + 4, column r4)
struct FragB {
  uint32_t hi[2], lo[2];
};
__device__ __forceinline__ FragB frag_b(float x0, float x1) {
  FragB f;
  split_tf32(x0, f.hi[0], f.lo[0]);
  split_tf32(x1, f.hi[1], f.lo[1]);
  return f;
}

// big += a.hi b.hi;  small += a.lo b.hi + a.hi b.lo
__device__ __forceinline__ void mma3(float (&big)[4], float (&small)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(small, a.lo, b.hi[0], b.hi[1]);
  mma_tf32(small, a.hi, b.lo[0], b.lo[1]);
  mma_tf32(big, a.hi, b.hi[0], b.hi[1]);
}

// 2^x for |x| < 126 as 2^n (n = x rounded to an integer, exact) times
// ex2.approx of the fraction (|f| <= 1/2): within about 2^-22 of 2^x
// however large |x| is
__device__ __forceinline__ float pow2(double x) {
  constexpr double kRound = 6755399441055744.0;   // 1.5 * 2^52: x + kRound is x rounded
  const double t = x + kRound;
  const int n = __double2loint(t);
  return ex2(static_cast<float>(x - (t - kRound))) * __int_as_float((n + 127) << 23);
}

// v^T (dv rows 16 cs + r4 (+ 8), tokens 8 kk + 2 c4 (+ 1), the fragment's
// k order), each token's column scaled by w0 / w1, as a split A fragment
__device__ __forceinline__ FragA vt_frag(const float* v_s, int kk, int cs, int lane,
                                         float w0 = 1.f, float w1 = 1.f) {
  const int j = 8 * kk + 2 * (lane & 3), e = 16 * cs + (lane >> 2);
  return frag_a(v_s[swz(j, e)] * w0, v_s[swz(j, e + 8)] * w0, v_s[swz(j + 1, e)] * w1,
                v_s[swz(j + 1, e + 8)] * w1);
}

// the products of y^T (16 dv x 32 tokens) that the state gives, S^T x^T
// (x = qs, or C), from zero, with the state's accumulators as the A
// fragments (k in accumulator order)
__device__ __forceinline__ void state_times(float (&y)[4][4], const float (&s)[8][4],
                                            const float* x_s, int lane) {
  const int r4 = lane >> 2, c4 = lane & 3;
  float big[4][4] = {}, small[4][4] = {};
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    const FragA sa = frag_a(s[ks][0], s[ks][2], s[ks][1], s[ks][3]);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const float2 x = *reinterpret_cast<const float2*>(x_s + swz(8 * n + r4, 8 * ks + 2 * c4));
      mma3(big[n], small[n], sa, frag_b(x.x, x.y));
    }
  }
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) y[n][x] = big[n][x] + small[n][x];
}

// the raw scores x y^T (x = qs or C, y = ks or B) of column tile j = 8 cw..
// and row tiles m = 0, 1, from zero; m = 0 lies wholly above the diagonal
// for cw >= 2 and is skipped (left 0)
__device__ __forceinline__ void scores(float (&a)[2][4], const float* x_s, const float* y_s,
                                       int cw, int lane) {
  const int r4 = lane >> 2, c4 = lane & 3;
  float big[2][4] = {}, small[2][4] = {};
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    const float2 yf = *reinterpret_cast<const float2*>(y_s + swz(8 * cw + r4, 8 * ks + 2 * c4));
    const FragB b = frag_b(yf.x, yf.y);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      if (m == 0 && cw >= 2) continue;
      const float2 x0 = *reinterpret_cast<const float2*>(x_s + swz(16 * m + r4, 8 * ks + 2 * c4));
      const float2 x1 =
          *reinterpret_cast<const float2*>(x_s + swz(16 * m + r4 + 8, 8 * ks + 2 * c4));
      mma3(big[m], small[m], frag_a(x0.x, x1.x, x0.y, x1.y), b);
    }
  }
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int x = 0; x < 4; ++x) a[m][x] = big[m][x] + small[m][x];
}

// y^T += v^T A^T over the visible tokens j <= i (token tiles kk <= n), A
// [kQ][kQ] (rows i) from shared memory
__device__ __forceinline__ void add_v_scores(float (&y)[4][4], const float* v_s,
                                             const float* a_s, int cs, int lane) {
  const int r4 = lane >> 2, c4 = lane & 3;
  float big[4][4] = {}, small[4][4] = {};
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const FragA va = vt_frag(v_s, kk, cs, lane);
#pragma unroll
    for (int n = kk; n < 4; ++n) {
      const float2 a =
          *reinterpret_cast<const float2*>(a_s + swz(8 * n + r4, 8 * kk + 2 * c4, kQ));
      mma3(big[n], small[n], va, frag_b(a.x, a.y));
    }
  }
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) y[n][x] += big[n][x] + small[n][x];
}

// S^T <- S^T o decay + (w o v)^T x (x = kend, or B; w = 1, or per token
// wJ[2 kk + (0, 1)] for tokens 8 kk + 2 c4 (+ 1)): the update summed from
// zero, 32 dk columns at a time, and joined to the decayed state in one FMA;
// decay(n) gives the pair of decays of dk columns 8 n + 2 c4 (+ 1)
template <typename Decay>
__device__ __forceinline__ void update_state(float (&s)[8][4], const float* v_s, const float* x_s,
                                             const float (&wJ)[8], Decay decay, int cs, int lane) {
  const int r4 = lane >> 2, c4 = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float big[4][4] = {}, small[4][4] = {};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const FragA va = vt_frag(v_s, kk, cs, lane, wJ[2 * kk], wJ[2 * kk + 1]);
      const int j = 8 * kk + 2 * c4;
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        const int c = 8 * (4 * half + nn) + r4;
        mma3(big[nn], small[nn], va, frag_b(x_s[swz(j, c)], x_s[swz(j + 1, c)]));
      }
    }
#pragma unroll
    for (int nn = 0; nn < 4; ++nn) {
      const int n = 4 * half + nn;
      const float2 d = decay(n);
      s[n][0] = fmaf(s[n][0], d.x, big[nn][0] + small[nn][0]);
      s[n][1] = fmaf(s[n][1], d.y, big[nn][1] + small[nn][1]);
      s[n][2] = fmaf(s[n][2], d.x, big[nn][2] + small[nn][2]);
      s[n][3] = fmaf(s[n][3], d.y, big[nn][3] + small[nn][3]);
    }
  }
}

// y^T (16 dv x 32 tokens of the chunk at s0) out as f32, straight from the
// accumulators: each store of a warp writes four tokens' 32-byte runs of 8
// dv columns, whole sectors
__device__ __forceinline__ void store_yT_f32(const float (&y)[4][4], const F32Params& p,
                                             float* ob, int s0, int cs, int lane) {
  const int r4 = lane >> 2, c4 = lane & 3;
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int t = 8 * n + 2 * c4 + (x & 1), e = 16 * cs + r4 + 8 * (x >> 1);
      if (s0 + t < p.S && e < p.dv) ob[(s0 + t) * p.o[1] + e] = y[n][x];
    }
}

// A = raw scores under the mask (a select) with the bonus on the diagonal,
// this warp's tiles (rows 16 m + r4 (+ 8), columns 8 cw + 2 c4 (+ 1)), into
// A [kQ][kQ]; scale(i, j) gives a score's decay weight
template <typename Scale>
__device__ __forceinline__ void store_scores(float* a_s, const float (&a)[2][4], int cw, int lane,
                                             int bonus, const float (&dg)[4], Scale scale) {
  const int r4 = lane >> 2, c4 = lane & 3;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int i = 16 * m + r4 + 8 * hf, j = 8 * cw + 2 * c4;
      const float2 w = scale(i, j);
      *reinterpret_cast<float2*>(a_s + swz(i, j, kQ)) =
          make_float2(masked(a[m][2 * hf] * w.x, i, j, bonus, dg[2 * m + hf]),
                      masked(a[m][2 * hf + 1] * w.y, i, j + 1, bonus, dg[2 * m + hf]));
    }
}

// RWKV6's vector decay in f32: decay_vector_tc's blocks and steps, with
// q, k, log_w (single stages) and v (two stages) copied in as f32, qs, ks
// and kend made in place of q and k and beside them, every product on
// 3xTF32, and the state's update last, once y is out.  The copies of the next chunk start as each tile is freed: v at
// the chunk's start, log_w once its sums are taken, q and k once A and
// S^T qs^T have read them.
constexpr int kFvV = 0;                             // v, two stages
constexpr int kFvQ = kFvV + 2 * kF32Tile * 4;       // q, then qs
constexpr int kFvK = kFvQ + kF32Tile * 4;           // k, then ks
constexpr int kFvW = kFvK + kF32Tile * 4;           // log_w
constexpr int kFvE = kFvW + kF32Tile * 4;           // kend
constexpr int kFvA = kFvE + kF32Tile * 4;           // A [kQ][kQ]
constexpr int kFvPart = kFvA + kQ * kQ * 4;         // per-warp log-decay sums, f64 [4][kTcD]
constexpr int kFvTot = kFvPart + 4 * kTcD * 8;      // e^total per column [kTcD]
constexpr int kFvDiag = kFvTot + kTcD * 4;          // (q o u) . k per token [kQ]
constexpr int kF32VecSmem = kFvDiag + kQ * 4;       // 55,680 bytes: 4 blocks an SM

__global__ void __launch_bounds__(kVecThreads, 4) decay_vector_tf32(F32Params p) {
  constexpr double kLog2e = 1.4426950408889634;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw + kFvQ);
  float* k_s = reinterpret_cast<float*>(smem_raw + kFvK);
  float* w_s = reinterpret_cast<float*>(smem_raw + kFvW);
  float* e_s = reinterpret_cast<float*>(smem_raw + kFvE);
  float* a_s = reinterpret_cast<float*>(smem_raw + kFvA);
  double* part_s = reinterpret_cast<double*>(smem_raw + kFvPart);
  float* etot_s = reinterpret_cast<float*>(smem_raw + kFvTot);
  float* diag_s = reinterpret_cast<float*>(smem_raw + kFvDiag);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r4 = lane >> 2, c4 = lane & 3, cs = warp;
  const int h = blockIdx.x, b = blockIdx.y;
  const float* qb = p.qp + b * p.q[0] + h * p.q[2];
  const float* kb = p.kp + b * p.k[0] + h * p.k[2];
  const float* vb = p.vp + b * p.v[0] + h * p.v[2];
  const float* wb = p.wp + b * p.w[0] + h * p.w[2];
  float* ob = p.op + b * p.o[0] + h * p.o[2];
  const int n_chunks = (p.S + kQ - 1) / kQ;

  auto v_stage = [&](int st) { return reinterpret_cast<float*>(smem_raw + kFvV) + st * kF32Tile; };
  // rows s0.. of a view (row stride `stride`) into a tile, 16 bytes a copy,
  // zeros past S and past d
  auto copy_rows = [&](float* dst, const float* src, long long stride, int s0, int d) {
    for (int i = tid; i < kQ * 16; i += kVecThreads) {
      const int r = i >> 4, c = (i & 15) * 4, s = s0 + r;
      const bool ok = s < p.S && c < d;
      cp_async16(dst + swz(r, c), src + (ok ? s * stride + c : 0), ok);
    }
  };

  float sacc[8][4];
  const long long state_off = ((long long)b * p.H + h) * p.dk * p.dv;
  load_state(sacc, p, state_off, cs, lane, true);
  const float ones[8] = {1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f};

  if (n_chunks > 0) {
    copy_rows(q_s, qb, p.q[1], 0, p.dk);
    copy_rows(k_s, kb, p.k[1], 0, p.dk);
    copy_rows(w_s, wb, p.w[1], 0, p.dk);
    copy_rows(v_stage(0), vb, p.v[1], 0, p.dv);
    cp_async_commit();
  }
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int st = ch & 1, s0 = ch * kQ;
    const bool more = ch + 1 < n_chunks;
    float* v_s = v_stage(st);
    cp_async_wait_all();
    __syncthreads();   // chunk ch is in; every warp is done with chunk ch - 1
    if (more) {
      copy_rows(v_stage(st ^ 1), vb, p.v[1], s0 + kQ, p.dv);
      cp_async_commit();
    }

    // prep, 1: per column pair (2 lane, 2 lane + 1), tokens 8 warp..8 warp + 7:
    // the clipped log-decays and their sum over this warp's tokens (f64)
    const int c2 = 2 * lane, t0 = 8 * warp;
    float2 lw[8];
    double sx = 0.0, sy = 0.0;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const float2 w = *reinterpret_cast<const float2*>(w_s + swz(t0 + t, c2));
      lw[t] = make_float2(fminf(fmaxf(w.x, kMinLogDecay), 0.f), fminf(fmaxf(w.y, kMinLogDecay), 0.f));
      sx += lw[t].x;
      sy += lw[t].y;
    }
    *reinterpret_cast<double2*>(part_s + warp * kTcD + c2) = make_double2(sx, sy);
    // (q o u) . k of token t0 + r4 over columns 16 c4..16 c4 + 15
    if (p.use_bonus) {
      const int t = t0 + r4;
      float d = 0.f;
      for (int c = 16 * c4; c < 16 * c4 + 16 && c < p.dk; c += 2) {
        const float2 qv = *reinterpret_cast<const float2*>(q_s + swz(t, c));
        const float2 kv = *reinterpret_cast<const float2*>(k_s + swz(t, c));
        const float* uh = p.u + (long long)h * p.dk + c;
        d += qv.x * uh[0] * kv.x + qv.y * uh[1] * kv.y;
      }
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      if (c4 == 0) diag_s[t] = d;
    }
    __syncthreads();   // the sums are in; log_w is free
    if (more) {
      copy_rows(w_s, wb, p.w[1], s0 + kQ, p.dk);
      cp_async_commit();
    }

    // prep, 2: the cumulative log-decays (f64, from the earlier warps' sums);
    // qs = q e^(qcum) and ks = k e^(-cum) (up to e^57.6) in place of q and k,
    // kend = k e^(total - cum) (<= 1)
    {
      double ox = 0.0, oy = 0.0, tx = 0.0, ty = 0.0;
#pragma unroll
      for (int w2 = 0; w2 < 4; ++w2) {
        const double2 pw = *reinterpret_cast<const double2*>(part_s + w2 * kTcD + c2);
        if (w2 < warp) {
          ox += pw.x;
          oy += pw.y;
        }
        tx += pw.x;
        ty += pw.y;
      }
      if (warp == 0)
        *reinterpret_cast<float2*>(etot_s + c2) = make_float2(pow2(tx * kLog2e), pow2(ty * kLog2e));
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int o = swz(t0 + t, c2);
        const double px = ox, py = oy;   // the sums before token t
        ox += lw[t].x;
        oy += lw[t].y;
        const double qx = p.use_bonus ? px : ox, qy = p.use_bonus ? py : oy;
        const float2 qv = *reinterpret_cast<const float2*>(q_s + o);
        const float2 kv = *reinterpret_cast<const float2*>(k_s + o);
        *reinterpret_cast<float2*>(q_s + o) =
            make_float2(qv.x * pow2(qx * kLog2e), qv.y * pow2(qy * kLog2e));
        *reinterpret_cast<float2*>(k_s + o) =
            make_float2(kv.x * pow2(-ox * kLog2e), kv.y * pow2(-oy * kLog2e));
        *reinterpret_cast<float2*>(e_s + o) =
            make_float2(kv.x * pow2((tx - ox) * kLog2e), kv.y * pow2((ty - oy) * kLog2e));
      }
    }
    __syncthreads();   // qs, ks, kend and e^total are in

    // A = qs ks^T (this warp's column tile) masked into shared memory, and
    // y^T = S^T qs^T
    float araw[2][4], yacc[4][4];
    state_times(yacc, sacc, q_s, lane);
    scores(araw, q_s, k_s, warp, lane);
    float dg[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) dg[x] = p.use_bonus ? diag_s[8 * x + r4] : 0.f;
    store_scores(a_s, araw, warp, lane, p.use_bonus, dg,
                 [](int, int) { return make_float2(1.f, 1.f); });
    __syncthreads();   // A is in; qs and ks are free
    if (more) {
      copy_rows(q_s, qb, p.q[1], s0 + kQ, p.dk);
      copy_rows(k_s, kb, p.k[1], s0 + kQ, p.dk);
      cp_async_commit();
    }
    // y^T += v^T A^T, out; then the state's update
    add_v_scores(yacc, v_s, a_s, cs, lane);
    store_yT_f32(yacc, p, ob, s0, cs, lane);
    update_state(sacc, v_s, e_s, ones,
                 [&](int n) { return *reinterpret_cast<const float2*>(etot_s + 8 * n + 2 * c4); },
                 cs, lane);
  }
  store_state(sacc, p, state_off, cs, lane, true);
}

// Mamba2's scalar decay in f32: decay_scalar_tc's blocks (a batch row and
// kScalarHeads heads sharing the chunk's C and B) and steps, with C, B and v
// f32 (so C B^T and the products with v take three products too), the
// next chunk's stage copied in while this one is computed.
//   y^T  = (S^T C^T) e^(qcum_i)  +  v^T A^T,  A_ij = (C.B^T)_ij e^(qcum_i) e^(-cum_j)
//   S^T <- S^T e^total  +  (w o v)^T B,        w_j = e^(total - cum_j) <= 1
constexpr int kScalarF32Heads = 2;   // heads per block
constexpr int kScalarF32Stage =
    (2 + kScalarF32Heads) * kF32Tile * 4 + kScalarF32Heads * kQ * 4;
constexpr int kScalarF32Smem = 2 * kScalarF32Stage + kScalarF32Heads * kQ * kQ * 4;

__global__ void __launch_bounds__(128 * kScalarF32Heads, 4 / kScalarF32Heads)
    decay_scalar_tf32(F32Params p) {
  constexpr int G = kScalarF32Heads, kThreadsG = 128 * G;
  constexpr double kLog2e = 1.4426950408889634;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* a_all = reinterpret_cast<float*>(smem_raw + 2 * kScalarF32Stage);   // per head: A

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r4 = lane >> 2, c4 = lane & 3;
  const int hh = warp >> 2, cs = warp & 3;
  const int hbase = blockIdx.x * G, b = blockIdx.y, h = hbase + hh;
  const bool hvalid = h < p.H;
  const float* cb = p.qp + b * p.q[0];   // C (q), shared by the heads
  const float* bb = p.kp + b * p.k[0];   // B (k)
  const float* vb = p.vp + b * p.v[0];
  const float* wb = p.wp + b * p.w[0];
  const int n_chunks = (p.S + kQ - 1) / kQ;

  // a stage: C, B, v of each head (tiles), then log_w [G][kQ]
  auto stage = [&](int st) { return reinterpret_cast<float*>(smem_raw + st * kScalarF32Stage); };
  auto load_chunk = [&](int ch, int st) {
    const int s0 = ch * kQ;
    float* c_s = stage(st);
    for (int i = tid; i < (2 + G) * kQ * 16; i += kThreadsG) {
      const int t = i / (kQ * 16), r = (i >> 4) % kQ, c = (i & 15) * 4, s = s0 + r;
      const float* src;
      bool ok = s < p.S;
      if (t == 0) {
        ok = ok && c < p.dk;
        src = cb + (ok ? s * p.q[1] + c : 0);
      } else if (t == 1) {
        ok = ok && c < p.dk;
        src = bb + (ok ? s * p.k[1] + c : 0);
      } else {
        const int hg = hbase + t - 2;
        ok = ok && c < p.dv && hg < p.H;
        src = vb + (ok ? s * p.v[1] + hg * p.v[2] + c : 0);
      }
      cp_async16(c_s + t * kF32Tile + swz(r, c), src, ok);
    }
    float* l_s = c_s + (2 + G) * kF32Tile;
    for (int i = tid; i < G * kQ; i += kThreadsG) {
      const int g = i / kQ, r = i % kQ, s = s0 + r, hg = hbase + g;
      const bool ok = s < p.S && hg < p.H;
      cp_async4(l_s + i, wb + (ok ? s * p.w[1] + hg * p.w[2] : 0), ok);
    }
    cp_async_commit();
  };

  float sacc[8][4];
  const long long state_off = ((long long)b * p.H + h) * p.dk * p.dv;
  load_state(sacc, p, state_off, cs, lane, hvalid);

  if (n_chunks > 0) load_chunk(0, 0);
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int st = ch & 1, s0 = ch * kQ;
    cp_async_wait_all();
    __syncthreads();   // chunk ch is in; every warp is done with chunk ch - 1
    if (ch + 1 < n_chunks) load_chunk(ch + 1, st ^ 1);
    const float* c_s = stage(st);
    const float* b_s = c_s + kF32Tile;
    float* v_s = stage(st) + (2 + hh) * kF32Tile;
    const float* l_s = stage(st) + (2 + G) * kF32Tile;
    float* a_s = a_all + hh * kQ * kQ;

    if (!hvalid) continue;

    // S^T C^T, which needs no decay, first
    float yacc[4][4];
    state_times(yacc, sacc, c_s, lane);

    // per lane = token: the cumulative log-decay by a shuffle scan in f64,
    // and the decay factors
    const double l = fminf(fmaxf(l_s[hh * kQ + lane], kMinLogDecay), 0.f);
    double cum = l;
#pragma unroll
    for (int off = 1; off < kQ; off <<= 1) {
      const double up = __shfl_up_sync(0xffffffffu, cum, off);
      if (lane >= off) cum += up;
    }
    double prev = __shfl_up_sync(0xffffffffu, cum, 1);
    if (lane == 0) prev = 0.0;
    const double total = __shfl_sync(0xffffffffu, cum, kQ - 1);
    const float eq = pow2((p.use_bonus ? prev : cum) * kLog2e);   // <= 1
    const float ek = pow2(-cum * kLog2e);                           // <= e^57.6
    const float wj = pow2((total - cum) * kLog2e);                  // <= 1
    const float etot = pow2(total * kLog2e);
    float diag = 0.f;
    if (p.use_bonus) {
      const float* uh = p.u + (long long)h * p.dk;
      for (int c = 0; c < p.dk; ++c) diag += c_s[swz(lane, c)] * uh[c] * b_s[swz(lane, c)];
    }

    // A = C B^T (this warp's column tile) under the decays and the mask,
    // into the head's tile, built by its four warps
    float araw[2][4];
    scores(araw, c_s, b_s, cs, lane);
    float dg[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) dg[x] = __shfl_sync(0xffffffffu, diag, 8 * x + r4);
    float eqi[4], ekj[2];
#pragma unroll
    for (int x = 0; x < 4; ++x) eqi[x] = __shfl_sync(0xffffffffu, eq, 8 * x + r4);
    ekj[0] = __shfl_sync(0xffffffffu, ek, 8 * cs + 2 * c4);
    ekj[1] = __shfl_sync(0xffffffffu, ek, 8 * cs + 2 * c4 + 1);
    store_scores(a_s, araw, cs, lane, p.use_bonus, dg, [&](int i, int) {
      const float e = eqi[i >> 3];
      return make_float2(e * ekj[0], e * ekj[1]);
    });

    // y^T = (S^T C^T) e^(qcum_i) + v^T A^T, once the head's A is in; out
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float w = __shfl_sync(0xffffffffu, eq, 8 * n + 2 * c4 + e);
        yacc[n][e] *= w;
        yacc[n][2 + e] *= w;
      }
    head_barrier(hh);
    add_v_scores(yacc, v_s, a_s, cs, lane);
    store_yT_f32(yacc, p, p.op + b * p.o[0] + h * p.o[2], s0, cs, lane);

    // S^T <- S^T e^total + (w o v)^T B
    float wJ[8];
#pragma unroll
    for (int x = 0; x < 8; ++x)
      wJ[x] = __shfl_sync(0xffffffffu, wj, 8 * (x >> 1) + 2 * c4 + (x & 1));
    update_state(sacc, v_s, b_s, wJ, [&](int) { return make_float2(etot, etot); }, cs, lane);
  }

  store_state(sacc, p, state_off, cs, lane, hvalid);
}

constexpr int kScalarSmem =
    2 * ((2 + kScalarHeads) * kTile * 2 + kScalarHeads * kQ * 4) + kScalarHeads * 2 * kQ * kARow * 2;

// a view whose rows the 16-byte copies can read: d contiguous, the base and
// the (b, s, h) strides on 16 bytes (a dimension of size 1 is exempt)
template <typename P>
bool rows16(const P& p, const void* base, const long long* s, int item) {
  if (reinterpret_cast<uintptr_t>(base) % 16 || s[3] != 1) return false;
  const int size[3] = {p.B, p.S, p.H};
  for (int i = 0; i < 3; ++i)
    if (size[i] > 1 && (s[i] * item) % 16) return false;
  return true;
}

int launch_tc(const TcParams& p, int path, cudaStream_t st) {
  if (p.dk % 8 || p.dv % 8 || p.dk > kTcD || p.dv > kTcD || !rows16(p, p.qp, p.q, 2) ||
      !rows16(p, p.kp, p.k, 2) || !rows16(p, p.vp, p.v, 2) || p.o[3] != 1 || p.o[1] % 2 ||
      p.o[2] % 2)
    return (int)cudaErrorInvalidValue;
  if (path == 1) {
    if (p.q[2] != 0 || p.k[2] != 0 || p.w[3] != 0) return (int)cudaErrorInvalidValue;
    const cudaError_t e = cudaFuncSetAttribute(
        decay_scalar_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, kScalarSmem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((p.H + kScalarHeads - 1) / kScalarHeads, p.B);
    decay_scalar_tc<<<grid, 128 * kScalarHeads, kScalarSmem, st>>>(p);
    return (int)cudaGetLastError();
  }
  if (!rows16(p, p.wp, p.w, 4)) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      decay_vector_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, kVecSmem);
  if (e != cudaSuccess) return (int)e;
  decay_vector_tc<<<dim3(p.H, p.B), kVecThreads, kVecSmem, st>>>(p);
  return (int)cudaGetLastError();
}

int launch_tc_f32(const F32Params& p, int path, cudaStream_t st) {
  if (p.dk % 4 || p.dv % 4 || p.dk > kTcD || p.dv > kTcD || !rows16(p, p.qp, p.q, 4) ||
      !rows16(p, p.kp, p.k, 4) || !rows16(p, p.vp, p.v, 4) || p.o[3] != 1 || p.o[1] % 4 ||
      p.o[2] % 4 || reinterpret_cast<uintptr_t>(p.op) % 16)
    return (int)cudaErrorInvalidValue;
  if (path == 3) {
    if (p.q[2] != 0 || p.k[2] != 0 || p.w[3] != 0) return (int)cudaErrorInvalidValue;
    const cudaError_t e = cudaFuncSetAttribute(
        decay_scalar_tf32, cudaFuncAttributeMaxDynamicSharedMemorySize, kScalarF32Smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((p.H + kScalarF32Heads - 1) / kScalarF32Heads, p.B);
    decay_scalar_tf32<<<grid, 128 * kScalarF32Heads, kScalarF32Smem, st>>>(p);
    return (int)cudaGetLastError();
  }
  if (!rows16(p, p.wp, p.w, 4)) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      decay_vector_tf32, cudaFuncAttributeMaxDynamicSharedMemorySize, kF32VecSmem);
  if (e != cudaSuccess) return (int)e;
  decay_vector_tf32<<<dim3(p.H, p.B), kVecThreads, kF32VecSmem, st>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
TcParamsT<T> tc_params(const void* q, const void* k, const void* v, const void* lw,
                       const void* u, const void* h0, void* out, void* hT,
                       const long long* dims, const long long* strides, int use_bonus) {
  TcParamsT<T> p;
  p.B = (int)dims[0], p.S = (int)dims[1], p.H = (int)dims[2];
  p.dk = (int)dims[3], p.dv = (int)dims[4];
  p.use_bonus = use_bonus;
  long long* s[5] = {p.q, p.k, p.v, p.w, p.o};
  for (int t = 0; t < 5; ++t)
    for (int i = 0; i < 4; ++i) s[t][i] = strides[4 * t + i];
  p.qp = static_cast<const T*>(q);
  p.kp = static_cast<const T*>(k);
  p.vp = static_cast<const T*>(v);
  p.wp = static_cast<const float*>(lw);
  p.u = static_cast<const float*>(u);
  p.h0 = static_cast<const float*>(h0);
  p.op = static_cast<T*>(out);
  p.hT = static_cast<float*>(hT);
  return p;
}

// what every tensor-core path takes: 0 (nothing to do), 1 (refused) or 2 (go)
template <typename P>
int tc_ready(const P& p, int use_bonus, const void* u) {
  if (p.B <= 0 || p.H <= 0) return 0;
  if (p.S < 0 || p.dk < 1 || p.dv < 1 || p.B > 65535 || (use_bonus && !u)) return 1;
  return 2;
}

}  // namespace

// path, as ops.py's kernel_path chose it (the index in its PATHS): 0 the
// CUDA-core kernel (f32, any view), 1 the scalar-decay tensor-core kernel
// (bf16, q and k stride 0 over heads, log_w stride 0 over d), 2 the
// vector-decay tensor-core kernel (bf16), 3 and 4 their f32 siblings on
// 3xTF32.  Each returns 0 or a cudaError_t.
extern "C" int decay_attention_f32(const void* q, const void* k, const void* v, const void* lw,
                                   const void* u, const void* h0, void* out, void* hT,
                                   const long long* dims, const long long* strides,
                                   int use_bonus, int path, void* stream) {
  if (path == 0)
    return launch<float>(q, k, v, lw, u, h0, out, hT, dims, strides, use_bonus, stream);
  if (path != 3 && path != 4) return (int)cudaErrorInvalidValue;
  const F32Params p = tc_params<float>(q, k, v, lw, u, h0, out, hT, dims, strides, use_bonus);
  const int ready = tc_ready(p, use_bonus, u);
  if (ready != 2) return ready ? (int)cudaErrorInvalidValue : 0;
  return launch_tc_f32(p, path, static_cast<cudaStream_t>(stream));
}

extern "C" int decay_attention_bf16(const void* q, const void* k, const void* v, const void* lw,
                                    const void* u, const void* h0, void* out, void* hT,
                                    const long long* dims, const long long* strides,
                                    int use_bonus, int path, void* stream) {
  if (path != 1 && path != 2) return (int)cudaErrorInvalidValue;
  const TcParams p =
      tc_params<__nv_bfloat16>(q, k, v, lw, u, h0, out, hT, dims, strides, use_bonus);
  const int ready = tc_ready(p, use_bonus, u);
  if (ready != 2) return ready ? (int)cudaErrorInvalidValue : 0;
  return launch_tc(p, path, static_cast<cudaStream_t>(stream));
}

extern "C" const char* cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
