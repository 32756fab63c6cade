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
// sets the least time.  This kernel issues 7 (it rounds as the plain
// version does, so it cannot fuse: 6 for the update and the bonus, 1 for
// o's sum), which the bound does not count.
//
// The old design (one CTA of V threads per (row, head), each thread all K
// rows of its column S[:, v]) had three faults: each 32-step run of r, k
// and w was staged by strided loads with a division per element while no
// arithmetic ran; B * H CTAs of two warps left half the SMs idle at
// rwkv6-7b's B 1, H 64 and gave a busy SM two warps for four schedulers;
// and each thread's step was a 64-deep run of broadcast loads and rounded
// operations.
//
// Design.  Every value channel v has its own column S[:, v], and every
// column reads the same r_t, k_t, w_t and u, so the work splits over V and
// over K without any exchange of state:
// - V over CTAs: a CTA owns (row, head, block of 32 value channels, or 16
//   where V is 16), so B 1, H 64, V 64 is 128 CTAs, one an SM.
// - K over kGroups = 8 warps by residue: warp q holds rows j = q, q + 8,
//   ... of its lane's column, K / 8 floats in registers, for the whole
//   sequence; two warps a scheduler, so one warp's loads and dependent
//   adds overlap the other's arithmetic (four warps of K / 4 rows measured
//   slower).  o's K-sum is the plain version's pairwise tree (row j plus
//   row j + n/2, halving n).  While n/2 >= 8 a level pairs rows of one
//   residue mod 8, and in warp q those levels are the local pairwise tree
//   over its K / 8 rows; after them element q is warp q's partial p_q, and
//   the last three levels are the same tree over the eight partials,
//   ((p0 + p4) + (p2 + p6)) + ((p1 + p5) + (p3 + p7)).  So each warp writes
//   p_q of every step of a chunk into shared memory, and after the chunk's
//   barrier the CTA forms o and stores it, whole rows of the block at
//   once.  One barrier a chunk, none a step.
// - Inputs ahead of compute: each 32-step chunk of r, k, w (rows of K
//   elements, contiguous and 16-byte aligned; the wrapper checks) and this
//   CTA's slice of v is copied into shared memory by 16-byte cp.async into
//   a ring of two stages, a chunk ahead of the one being walked.  At the
//   chunk's start the CTA unpacks the landed tile into one float4 (r, k, w,
//   u) per (step, k) and a float v per (step, channel); a warp's step then
//   reads K / 8 float4 broadcasts, each into the registers its last use
//   has freed.  Any T: the last chunk is short.
// Every product and sum is rounded as the plain PyTorch version rounds it
// (__fmul_rn, __fadd_rn, never contracted to an FMA): k v, u k v, the add,
// r times it, w S and the add, and the tree.  So o and the final state
// agree with the plain version bit for bit, in float32 and bfloat16.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace {

using sm90::cp_async16;
using sm90::cp_async_commit;
using sm90::cp_async_wait;
using sm90::smem_addr;

constexpr int kChunk = 32;    // steps a chunk: one staged tile of each input
constexpr int kGroups = 8;    // warps of a CTA, one per residue of k mod 8
constexpr int kLanes = 32;
constexpr int kThreads = kGroups * kLanes;

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

// element strides of one [B, H, T, *] input over batch, head and time;
// the last dim is contiguous
struct Strides {
  long long b, h, t;
};

__host__ __device__ constexpr int log2_of(int n) {
  return n > 1 ? 1 + log2_of(n / 2) : 0;
}

// x[0] + ... + x[n - 1] as the pairwise tree: x[i] plus x[i + n/2],
// halving n.  Both loops have constant trip counts, so they unroll, every
// index is known at compile time and x stays in registers.
template <int N>
__device__ __forceinline__ float tree_sum(float (&x)[N]) {
  constexpr int kLevels = log2_of(N);
#pragma unroll
  for (int level = 0; level < kLevels; ++level) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const int half = N >> (level + 1);
      if (i < half) x[i] = __fadd_rn(x[i], x[i + half]);
    }
  }
  return x[0];
}

// one step of one column over this warp's rows j = q + G i (G = kGroups):
// updates S from x[i] = (r_j, k_j, w_j, u_j), refills x[i] with the next
// step's row from ``next`` once it is used, and returns the warp's partial
// sum of o, r_j (S_j + u_j k_j v) summed over its rows as the local
// pairwise tree
template <int kRows>
__device__ __forceinline__ float wkv_step(float (&S)[kRows],
                                          float4 (&x)[kRows], float vt,
                                          const float4* next) {
  float ro[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const float kv = __fmul_rn(x[i].y, vt);
    ro[i] = __fmul_rn(x[i].x, __fadd_rn(S[i], __fmul_rn(x[i].w, kv)));
    S[i] = __fadd_rn(__fmul_rn(x[i].z, S[i]), kv);
    x[i] = next[kGroups * i];
  }
  return tree_sum(ro);
}

// Byte offsets into the dynamic shared memory of a CTA: two stages of the
// raw tiles as they lie in memory, the unpacked tile being walked, and the
// per-residue partial sums of o.
template <typename T, int K, int VB>
struct Smem {
  static constexpr int kR = 0;                               // T [kChunk][K]
  static constexpr int kK = kR + kChunk * K * sizeof(T);     // T [kChunk][K]
  static constexpr int kW = kK + kChunk * K * sizeof(T);     // f32 [kChunk][K]
  static constexpr int kV = kW + kChunk * K * 4;             // T [kChunk][VB]
  static constexpr int kStage = kV + kChunk * VB * sizeof(T);
  static constexpr int kRkwu = 2 * kStage;                   // float4 [kChunk][K]
  static constexpr int kVs = kRkwu + kChunk * K * 16;        // f32 [kChunk][VB]
  static constexpr int kPart = kVs + kChunk * VB * 4;  // f32 [kGroups][kChunk][VB]
  static constexpr int kBytes = kPart + kGroups * kChunk * VB * 4;
};

template <typename T, int K, int VB>
__global__ void __launch_bounds__(kThreads)
wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
           const T* __restrict__ v, const float* __restrict__ w,
           const float* __restrict__ u, T* __restrict__ o,
           float* __restrict__ s_final, int n_heads, int t_len, int v_dim,
           Strides sr, Strides sk, Strides sv, Strides sw) {
  using L = Smem<T, K, VB>;
  constexpr int kRows = K / kGroups;   // state rows a thread holds
  static_assert((kRows & (kRows - 1)) == 0 && kRows >= 2,
                "K is a power of two of at least 2 * kGroups rows");
  static_assert(kThreads % K == 0, "a thread unpacks one k index");
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_vblocks = v_dim / VB;
  const int bh = blockIdx.x / n_vblocks;
  const int v0 = (blockIdx.x - bh * n_vblocks) * VB;
  const int b = bh / n_heads, h = bh - b * n_heads;
  const int tid = threadIdx.x;
  const int q = tid / kLanes, lane = tid % kLanes;
  const int c = lane % VB;   // this thread's channel in the block
  const char* rb = reinterpret_cast<const char*>(r + b * sr.b + h * sr.h);
  const char* kb = reinterpret_cast<const char*>(k + b * sk.b + h * sk.h);
  const char* vbase =
      reinterpret_cast<const char*>(v + b * sv.b + h * sv.h + v0);
  const char* wb = reinterpret_cast<const char*>(w + b * sw.b + h * sw.h);
  const float uj = u[static_cast<size_t>(h) * K + tid % K];
  const int n_chunks = (t_len + kChunk - 1) / kChunk;

  // every thread copies its share of a chunk's rows, 16 bytes a piece
  auto stage = [&](int chunk) {
    unsigned char* st = smem + (chunk & 1) * L::kStage;
    const int t0 = chunk * kChunk;
    const int n = min(kChunk, t_len - t0);
    constexpr int kRk = K * sizeof(T) / 16, kWp = K * 4 / 16,
                  kVp = VB * sizeof(T) / 16;
    for (int i = tid; i < n * kRk; i += kThreads) {
      const int s = i / kRk, p = i % kRk;
      const long long t = t0 + s;
      cp_async16(smem_addr(st + L::kR + 16 * i),
                 rb + (t * sr.t) * sizeof(T) + 16 * p, true);
      cp_async16(smem_addr(st + L::kK + 16 * i),
                 kb + (t * sk.t) * sizeof(T) + 16 * p, true);
    }
    for (int i = tid; i < n * kWp; i += kThreads) {
      const int s = i / kWp, p = i % kWp;
      cp_async16(smem_addr(st + L::kW + 16 * i),
                 wb + ((t0 + s) * sw.t) * sizeof(float) + 16 * p, true);
    }
    for (int i = tid; i < n * kVp; i += kThreads) {
      const int s = i / kVp, p = i % kVp;
      cp_async16(smem_addr(st + L::kV + 16 * i),
                 vbase + ((t0 + s) * sv.t) * sizeof(T) + 16 * p, true);
    }
  };

  // o of a walked chunk, a block row at a time: the tree's last levels
  // over the residues' partials, p_g plus p_{g + n/2}, halving n
  const float* part = reinterpret_cast<const float*>(smem + L::kPart);
  T* ob = o + static_cast<size_t>(bh) * t_len * v_dim + v0;
  auto store_o = [&](int chunk) {
    const int t0 = chunk * kChunk;
    const int n = min(kChunk, t_len - t0);
    for (int i = tid; i < n * VB; i += kThreads) {
      float p[kGroups];
#pragma unroll
      for (int g = 0; g < kGroups; ++g) p[g] = part[g * kChunk * VB + i];
      const int s = i / VB, l = i % VB;
      ob[static_cast<size_t>(t0 + s) * v_dim + l] = from_f32<T>(tree_sum(p));
    }
  };

  float S[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) S[i] = 0.f;

  stage(0);
  cp_async_commit();
  if (n_chunks > 1) stage(1);
  cp_async_commit();
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    cp_async_wait<1>();   // this thread's copies of this chunk have landed
    __syncthreads();      // everyone's; and the last walk is done
    if (chunk > 0) store_o(chunk - 1);
    const unsigned char* st = smem + (chunk & 1) * L::kStage;
    const int n = min(kChunk, t_len - chunk * kChunk);
    {
      const T* rs = reinterpret_cast<const T*>(st + L::kR);
      const T* ks = reinterpret_cast<const T*>(st + L::kK);
      const float* ws = reinterpret_cast<const float*>(st + L::kW);
      float4* rkwu = reinterpret_cast<float4*>(smem + L::kRkwu);
      for (int i = tid; i < n * K; i += kThreads)
        rkwu[i] = make_float4(to_f32(rs[i]), to_f32(ks[i]), ws[i], uj);
      const T* vraw = reinterpret_cast<const T*>(st + L::kV);
      float* vs = reinterpret_cast<float*>(smem + L::kVs);
      for (int i = tid; i < n * VB; i += kThreads) vs[i] = to_f32(vraw[i]);
    }
    __syncthreads();      // unpacked; this stage and the partials are free
    if (chunk + 2 < n_chunks) stage(chunk + 2);
    cp_async_commit();    // possibly empty: one group a chunk, always
    const float4* rkwu = reinterpret_cast<const float4*>(smem + L::kRkwu) + q;
    const float* vs = reinterpret_cast<const float*>(smem + L::kVs) + c;
    float* pq = reinterpret_cast<float*>(smem + L::kPart) +
                q * kChunk * VB + lane;
    float4 x[kRows];   // step s's operands, refilled by wkv_step
#pragma unroll
    for (int i = 0; i < kRows; ++i) x[i] = rkwu[kGroups * i];
    float vt = vs[0];
#pragma unroll 1
    for (int s = 0; s < n; ++s) {
      const int next = min(s + 1, n - 1);
      const float v_next = vs[next * VB];
      const float p = wkv_step(S, x, vt, rkwu + next * K);
      if (lane < VB) pq[s * VB] = p;
      vt = v_next;
    }
  }
  __syncthreads();
  store_o(n_chunks - 1);
  if (lane < VB) {
    float* sf = s_final + static_cast<size_t>(bh) * K * v_dim + v0 + c;
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      sf[static_cast<size_t>(q + kGroups * i) * v_dim] = S[i];
  }
}

template <typename T, int K, int VB>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, void* o, float* s_final, int b, int h, int t_len,
           int v_dim, Strides sr, Strides sk, Strides sv, Strides sw,
           void* stream) {
  constexpr int smem = Smem<T, K, VB>::kBytes;
  auto kernel = wkv_kernel<T, K, VB>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long grid = static_cast<long long>(b) * h * (v_dim / VB);
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(grid), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, static_cast<T*>(o), s_final, h, t_len,
      v_dim, sr, sk, sv, sw);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int K>
int dispatch_v(const void* r, const void* k, const void* v, const float* w,
               const float* u, void* o, float* s_final, int b, int h,
               int t_len, int v_dim, Strides sr, Strides sk, Strides sv,
               Strides sw, void* stream) {
  if (v_dim == 16)
    return launch<T, K, 16>(r, k, v, w, u, o, s_final, b, h, t_len, v_dim,
                            sr, sk, sv, sw, stream);
  return launch<T, K, 32>(r, k, v, w, u, o, s_final, b, h, t_len, v_dim, sr,
                          sk, sv, sw, stream);
}

template <typename T>
int dispatch(int k_dim, const void* r, const void* k, const void* v,
             const float* w, const float* u, void* o, float* s_final, int b,
             int h, int t_len, int v_dim, Strides sr, Strides sk, Strides sv,
             Strides sw, void* stream) {
  switch (k_dim) {
    case 16:
      return dispatch_v<T, 16>(r, k, v, w, u, o, s_final, b, h, t_len, v_dim,
                               sr, sk, sv, sw, stream);
    case 32:
      return dispatch_v<T, 32>(r, k, v, w, u, o, s_final, b, h, t_len, v_dim,
                               sr, sk, sv, sw, stream);
    case 64:
      return dispatch_v<T, 64>(r, k, v, w, u, o, s_final, b, h, t_len, v_dim,
                               sr, sk, sv, sw, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool aligned16(const void* p, long long elem_bytes, const Strides& s) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         (s.b * elem_bytes) % 16 == 0 && (s.h * elem_bytes) % 16 == 0 &&
         (s.t * elem_bytes) % 16 == 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (r, k, v and o); w, u and the state
// are float32.  r, k, w [B, H, T, K] and v [B, H, T, V] by the element
// strides given (batch, head, time; the last dim contiguous), every row
// 16-byte aligned; u [H, K], o [B, H, T, V] and s_final [B, H, K, V]
// contiguous.  K in {16, 32, 64}, V in {16, 32, 64}.
extern "C" int rwkv6_scan(int dtype, const void* r, const void* k,
                          const void* v, const float* w, const float* u,
                          void* o, float* s_final, int b, int h, int t_len,
                          int k_dim, int v_dim, long long r_sb, long long r_sh,
                          long long r_st, long long k_sb, long long k_sh,
                          long long k_st, long long v_sb, long long v_sh,
                          long long v_st, long long w_sb, long long w_sh,
                          long long w_st, void* stream) {
  const Strides sr{r_sb, r_sh, r_st}, sk{k_sb, k_sh, k_st},
      sv{v_sb, v_sh, v_st}, sw{w_sb, w_sh, w_st};
  const long long item = dtype == 1 ? 2 : 4;
  if (b <= 0 || h <= 0 || t_len <= 0 || (dtype != 0 && dtype != 1) ||
      (v_dim != 16 && v_dim != 32 && v_dim != 64) ||
      !aligned16(r, item, sr) || !aligned16(k, item, sk) ||
      !aligned16(v, item, sv) || !aligned16(w, 4, sw)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0)
    return dispatch<float>(k_dim, r, k, v, w, u, o, s_final, b, h, t_len,
                           v_dim, sr, sk, sv, sw, stream);
  return dispatch<__nv_bfloat16>(k_dim, r, k, v, w, u, o, s_final, b, h,
                                 t_len, v_dim, sr, sk, sv, sw, stream);
}
