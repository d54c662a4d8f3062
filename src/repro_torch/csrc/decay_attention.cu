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
// Three paths, one chosen by the caller before the launch (ops.py:
// kernel_path), by type and strides alone:
//
// * simt (f32 q/k/v).  Bound: at the rwkv6_7b serve shape (B 8, S 1024,
//   H 64, dk = dv = 64, log_w f32, h0 and hT) the bytes take 0.13 ms at 3.35
//   TB/s, the products over the visible pairs (10.8 GFLOP) 0.16 ms at the
//   67 TFLOP/s of f32 on CUDA cores: bound by operations.  Design: one block
//   of 256 threads per (b, h) walks the chunks in order -- the loop the TPU
//   grid ran sequentially -- with the chunk staged in shared memory as f32,
//   one warp per column running the cumulative sum as a shuffle scan, and
//   16 x 16 threads computing the chunk products as small register tiles;
//   the state lives in shared memory.  dk and dv are zero-padded to 16, 32
//   or 64.  f32 throughout.
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
//
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

struct TcParams {
  int B, S, H, dk, dv, use_bonus;
  long long q[4], k[4], v[4], w[4], o[4];  // element strides (b, s, h, d)
  const __nv_bfloat16 *qp, *kp, *vp;
  const float* wp;                          // log_w
  const float* u;                           // (H, dk) or null
  const float* h0;                          // (B, H, dk, dv) or null (zeros)
  __nv_bfloat16* op;
  float* hT;                                // (B, H, dk, dv) or null
};

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

__device__ __forceinline__ void load_state(float (&s)[8][4], const TcParams& p, long long off,
                                           int cs, int lane, bool valid) {
  const int r4 = lane >> 2, c4 = lane & 3;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int e = 16 * cs + r4 + (x >> 1) * 8, c = 8 * n + 2 * c4 + (x & 1);
      s[n][x] = valid && p.h0 && c < p.dk && e < p.dv ? p.h0[off + c * p.dv + e] : 0.f;
    }
}

__device__ __forceinline__ void store_state(const float (&s)[8][4], const TcParams& p,
                                            long long off, int cs, int lane, bool valid) {
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

constexpr int kScalarSmem =
    2 * ((2 + kScalarHeads) * kTile * 2 + kScalarHeads * kQ * 4) + kScalarHeads * 2 * kQ * kARow * 2;

// a view whose rows the 16-byte copies can read: d contiguous, the base and
// the (b, s, h) strides on 16 bytes (a dimension of size 1 is exempt)
bool rows16(const TcParams& p, const void* base, const long long* s, int item) {
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

}  // namespace

// path, as ops.py's kernel_path chose it: 0 the CUDA-core kernel (f32), 1
// the scalar-decay tensor-core kernel (bf16, q and k stride 0 over heads,
// log_w stride 0 over d), 2 the vector-decay tensor-core kernel (bf16).
// Each returns 0 or a cudaError_t.
extern "C" int decay_attention_f32(const void* q, const void* k, const void* v, const void* lw,
                                   const void* u, const void* h0, void* out, void* hT,
                                   const long long* dims, const long long* strides,
                                   int use_bonus, int path, void* stream) {
  if (path != 0) return (int)cudaErrorInvalidValue;
  return launch<float>(q, k, v, lw, u, h0, out, hT, dims, strides, use_bonus, stream);
}

extern "C" int decay_attention_bf16(const void* q, const void* k, const void* v, const void* lw,
                                    const void* u, const void* h0, void* out, void* hT,
                                    const long long* dims, const long long* strides,
                                    int use_bonus, int path, void* stream) {
  if (path != 1 && path != 2) return (int)cudaErrorInvalidValue;
  TcParams p;
  p.B = (int)dims[0], p.S = (int)dims[1], p.H = (int)dims[2];
  p.dk = (int)dims[3], p.dv = (int)dims[4];
  p.use_bonus = use_bonus;
  long long* s[5] = {p.q, p.k, p.v, p.w, p.o};
  for (int t = 0; t < 5; ++t)
    for (int i = 0; i < 4; ++i) s[t][i] = strides[4 * t + i];
  p.qp = static_cast<const __nv_bfloat16*>(q);
  p.kp = static_cast<const __nv_bfloat16*>(k);
  p.vp = static_cast<const __nv_bfloat16*>(v);
  p.wp = static_cast<const float*>(lw);
  p.u = static_cast<const float*>(u);
  p.h0 = static_cast<const float*>(h0);
  p.op = static_cast<__nv_bfloat16*>(out);
  p.hT = static_cast<float*>(hT);
  if (p.B <= 0 || p.H <= 0) return 0;
  if (p.S < 0 || p.dk < 1 || p.dv < 1 || p.B > 65535 || (use_bonus && !u))
    return (int)cudaErrorInvalidValue;
  return launch_tc(p, path, static_cast<cudaStream_t>(stream));
}

extern "C" const char* cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
