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
// Bound: at the rwkv6_7b serve shape (B 8, S 1024, H 64, dk = dv = 64,
// q/k/v bf16, log_w f32, with h0 and hT) the bytes, 0.42 GB, take 0.13 ms at
// 3.35 TB/s; the four chunk products, 2 * (32 dk + 32 dv + 2 dk dv) per
// token and head = 12.9 GFLOP, take 0.19 ms at the 67 TFLOP/s of f32 on CUDA
// cores.  So it is bound by operations.
//
// Design (simple and right first; no tensor cores): one thread block of 256
// threads per (b, h) walks the chunks in order -- the loop the TPU grid ran
// sequentially.  The block stages a chunk of q, k, v and log_w in shared
// memory as f32 (rows padded by one float against bank conflicts), one warp
// per column runs the cumulative sum as a shuffle scan over its 32 lanes (a
// chunk is one warp wide) and rescales q and k in place, and the 16 x 16
// threads then compute the three chunk products from shared memory, each a
// small register tile.  The state lives in shared memory between chunks.
// dk and dv are padded with zeros to D = 16, 32 or 64, which leaves every
// result unchanged.  All of it is f32 on CUDA cores: the factored weights
// reach e^(+-57.6), which TF32 or bf16 would not carry to the reference's
// 2e-3.  The mask is applied by a select, never by a multiply: a masked score
// can be as large as e^57.6 |q||k| (or inf), and inf * 0 is NaN.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

}  // namespace

extern "C" int decay_attention_f32(const void* q, const void* k, const void* v, const void* lw,
                                   const void* u, const void* h0, void* out, void* hT,
                                   const long long* dims, const long long* strides,
                                   int use_bonus, void* stream) {
  return launch<float>(q, k, v, lw, u, h0, out, hT, dims, strides, use_bonus, stream);
}

extern "C" int decay_attention_bf16(const void* q, const void* k, const void* v, const void* lw,
                                    const void* u, const void* h0, void* out, void* hT,
                                    const long long* dims, const long long* strides,
                                    int use_bonus, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, lw, u, h0, out, hT, dims, strides, use_bonus, stream);
}

extern "C" const char* cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
