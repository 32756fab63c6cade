// RWKV6 (Finch) WKV recurrence, per head over a [K, V] float32 state S
// that starts at zero:
//
//   o_t = (S_{t-1} + diag(u) k_t v_t^T)^T r_t
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T
//
// Replaces: src/repro/kernels/rwkv6_scan.py:60 rwkv6_scan (Pallas body
// _wkv_kernel, :30).
//
// Bound: operations.  The function needs 5 float32 operations on every
// state element a step (o_t = S^T r_t + (r_t . (u * k_t)) v_t is one
// multiply-add, the bonus term only O(K + V); S_t = w * S + k v^T a
// multiply and a multiply-add) and reads only 3K + V inputs, so at
// K = V = 64 the float32 rate outside the tensor cores, not the bytes,
// sets the least time.  This kernel issues 7 (below: it rounds as the
// plain version does, so it cannot fuse), which the bound does not count.
//
// Design: one CTA per (batch row, head), one thread per value channel v.
// The TPU kernel carries S in VMEM across a sequential grid axis over
// chunks of T; here nothing carries between CTAs, so each CTA walks the
// whole sequence itself and each thread keeps its column S[:, v] (K
// floats) in registers for all of it.  The step's r_t, k_t, w_t (and u)
// are the same for every thread of the CTA: a run of kChunk steps of them
// is staged in shared memory as one float4 per (step, k), read back as
// broadcasts, with one barrier per run and none per step.  Any T: the
// last run is shorter.  Inputs are read through their batch, head and
// time strides, so the model's [B, T, H, K] projections arrive uncopied.
// Every product and sum is rounded as the plain PyTorch version rounds
// it (__fmul_rn, __fadd_rn, never contracted to an FMA): k v, u k v, the
// add, r times it, w S and the add; and o's K-sum runs as the same
// pairwise tree (element j plus element j + n/2, halving n), which also
// keeps its dependent chain log2(K) adds long.  So o and the final state
// agree with the plain version bit for bit, in float32 and bfloat16, and
// a model served through the kernel gives the plain replay's tokens.
// At B = 1 this is H CTAs of V threads, 64 CTAs on 132 SMs at rwkv6-7b's
// width: the step's dependent work per thread, not the card, limits it.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 32;   // steps staged per barrier
constexpr int kMaxV = 64;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

__host__ __device__ constexpr int log2_of(int n) {
  return n > 1 ? 1 + log2_of(n / 2) : 0;
}

// element strides of one [B, H, T, *] input over batch, head and time;
// the last dim is contiguous
struct Strides {
  long long b, h, t;
};

template <typename T, int K>
__global__ void __launch_bounds__(kMaxV)
wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
           const T* __restrict__ v, const float* __restrict__ w,
           const float* __restrict__ u, T* __restrict__ o,
           float* __restrict__ s_final, int n_heads, int t_len, int v_dim,
           Strides sr, Strides sk, Strides sv, Strides sw) {
  __shared__ float4 rkwu[kChunk][K];     // (r, k, w, u) per step and k
  __shared__ float vs[kChunk][kMaxV];
  const int bh = blockIdx.x;
  const int b = bh / n_heads, h = bh - b * n_heads;
  const int c = threadIdx.x;             // this thread's value channel
  const T* rb = r + b * sr.b + h * sr.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const float* wb = w + b * sw.b + h * sw.h;
  const float* ub = u + static_cast<size_t>(h) * K;
  T* ob = o + static_cast<size_t>(bh) * t_len * v_dim;

  float S[K];
#pragma unroll
  for (int i = 0; i < K; ++i) S[i] = 0.f;

  for (int t0 = 0; t0 < t_len; t0 += kChunk) {
    const int n = min(kChunk, t_len - t0);
    __syncthreads();   // the previous run's reads are done
    for (int i = c; i < n * K; i += v_dim) {
      const int s = i / K, j = i - s * K;
      const long long t = t0 + s;
      rkwu[s][j] = make_float4(to_f32(rb[t * sr.t + j]),
                               to_f32(kb[t * sk.t + j]), wb[t * sw.t + j],
                               ub[j]);
    }
    for (int i = c; i < n * v_dim; i += v_dim) {
      const int s = i / v_dim, j = i - s * v_dim;
      vs[s][j] = to_f32(vb[(t0 + s) * sv.t + j]);
    }
    __syncthreads();
    for (int s = 0; s < n; ++s) {
      const float vt = vs[s][c];
      float ro[K];   // r_j (S_j + u_j k_j v), summed below
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const float4 p = rkwu[s][j];   // broadcast: one address per warp
        const float kv = __fmul_rn(p.y, vt);
        ro[j] = __fmul_rn(p.x, __fadd_rn(S[j], __fmul_rn(p.w, kv)));
        S[j] = __fadd_rn(__fmul_rn(p.z, S[j]), kv);
      }
      // constant trip counts, so both loops unroll, every index is known
      // at compile time and ro stays in registers
      constexpr int kLevels = log2_of(K);
#pragma unroll
      for (int level = 0; level < kLevels; ++level) {
#pragma unroll
        for (int j = 0; j < K / 2; ++j) {
          const int half = K >> (level + 1);
          if (j < half) ro[j] = __fadd_rn(ro[j], ro[j + half]);
        }
      }
      ob[static_cast<size_t>(t0 + s) * v_dim + c] = from_f32<T>(ro[0]);
    }
  }
  float* sf = s_final + static_cast<size_t>(bh) * K * v_dim + c;
#pragma unroll
  for (int i = 0; i < K; ++i) sf[static_cast<size_t>(i) * v_dim] = S[i];
}

template <typename T, int K>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, void* o, float* s_final, int b, int h, int t_len,
           int v_dim, Strides sr, Strides sk, Strides sv, Strides sw,
           void* stream) {
  wkv_kernel<T, K><<<b * h, v_dim, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, static_cast<T*>(o), s_final, h, t_len,
      v_dim, sr, sk, sv, sw);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int k_dim, const void* r, const void* k, const void* v,
             const float* w, const float* u, void* o, float* s_final, int b,
             int h, int t_len, int v_dim, Strides sr, Strides sk, Strides sv,
             Strides sw, void* stream) {
  switch (k_dim) {
    case 16:
      return launch<T, 16>(r, k, v, w, u, o, s_final, b, h, t_len, v_dim, sr,
                           sk, sv, sw, stream);
    case 32:
      return launch<T, 32>(r, k, v, w, u, o, s_final, b, h, t_len, v_dim, sr,
                           sk, sv, sw, stream);
    case 64:
      return launch<T, 64>(r, k, v, w, u, o, s_final, b, h, t_len, v_dim, sr,
                           sk, sv, sw, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (r, k, v and o); w, u and the state
// are float32.  r, k, w [B, H, T, K] and v [B, H, T, V] by the element
// strides given (batch, head, time; the last dim contiguous); u [H, K],
// o [B, H, T, V] and s_final [B, H, K, V] contiguous.  K in {16, 32, 64},
// V in {16, 32, 64}.
extern "C" int rwkv6_scan(int dtype, const void* r, const void* k,
                          const void* v, const float* w, const float* u,
                          void* o, float* s_final, int b, int h, int t_len,
                          int k_dim, int v_dim, long long r_sb, long long r_sh,
                          long long r_st, long long k_sb, long long k_sh,
                          long long k_st, long long v_sb, long long v_sh,
                          long long v_st, long long w_sb, long long w_sh,
                          long long w_st, void* stream) {
  if (b <= 0 || h <= 0 || t_len <= 0 ||
      static_cast<long long>(b) * h > 0x7fffffffLL ||
      (v_dim != 16 && v_dim != 32 && v_dim != 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides sr{r_sb, r_sh, r_st}, sk{k_sb, k_sh, k_st},
      sv{v_sb, v_sh, v_st}, sw{w_sb, w_sh, w_st};
  if (dtype == 0)
    return dispatch<float>(k_dim, r, k, v, w, u, o, s_final, b, h, t_len,
                           v_dim, sr, sk, sv, sw, stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(k_dim, r, k, v, w, u, o, s_final, b, h,
                                   t_len, v_dim, sr, sk, sv, sw, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
