// Blockwise (flash) attention over a dense K/V: GQA, causal, optional
// sliding window, query offset.  Serves dense prefill and full-sequence
// attention (scoring) of the dense and hybrid models.
//
// Replaces: src/repro/kernels/flash_attention.py:95 flash_attention
// (Pallas body _attn_kernel, :29).
//
// Bound: at the main path's prefill shapes (qwen2-1.5b: g = 6 grouped
// heads, D 128; recurrentgemma-9b: g = 16, D 256; T in the hundreds to
// thousands) each key feeds g x T query rows, so the QK and PV products
// (4 * D flops per unmasked (query, key) pair) are far above the ~295
// operations per byte where the tensor cores become the limit: the
// kernel is bound by operations.  This first version runs them on CUDA
// cores in fp32; wgmma tiles fed by TMA are later work.
//
// Design: one CTA of 128 threads per (tile of kRows folded query rows,
// KV head, batch row).  Query rows are folded time-major, row r -> token
// r / g, head h*g + r % g, so the g heads that share a KV head share every
// K/V tile the CTA loads, and all rows of a tile have (nearly) the same
// causal and window limits.  The CTA walks only the KV tiles that can
// contribute to its rows (the TPU kernel's pl.when skip, here as loop
// bounds) and masks the ragged edge itself, so any Tq and S work.  Each
// K/V tile of kKeys keys is staged in shared memory in fp32 (rows padded
// to D + 4 floats: the float4 reads of 8 neighbouring keys fall in
// distinct banks).  Eight threads own one query row: each scores 4 keys
// of the tile, the row's max and sum are taken with warp shuffles (no
// barrier), and each thread keeps D / 8 output columns of the row in
// registers, reading the probabilities of the other keys by shuffle.
// Queries are scaled before the dot, as in the TPU kernel; the softmax is
// online and in fp32; a masked key contributes exactly zero, and a row
// with no valid key emits zeros (as ref.attention does).
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 16;          // folded query rows per CTA
constexpr int kKeys = 32;          // keys per K/V tile
constexpr int kLanesPerRow = kThreads / kRows;   // 8
constexpr int kKeysPerLane = kKeys / kLanesPerRow;  // 4

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

// Unpack one 16-byte vector of T into fp32 and store it (scaled) at dst.
template <typename T>
__device__ __forceinline__ void store_vec(float* dst, uint4 raw, float mul) {
  constexpr int kElems = 16 / sizeof(T);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < kElems; i += 4) {
    *reinterpret_cast<float4*>(dst + i) =
        make_float4(to_f32(e[i]) * mul, to_f32(e[i + 1]) * mul,
                    to_f32(e[i + 2]) * mul, to_f32(e[i + 3]) * mul);
  }
}

// Copy `rows` rows of D elements (row i at src_row(i)) into smem rows of
// ld floats; rows past `valid` are zero-filled.
template <typename T, int D, typename RowPtr>
__device__ __forceinline__ void stage_rows(float* dst, int rows, int valid,
                                           RowPtr src_row, float mul) {
  constexpr int kElems = 16 / sizeof(T);
  constexpr int kVecPerRow = D / kElems;
  constexpr int kLd = D + 4;
  for (int i = threadIdx.x; i < rows * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow, c0 = (i - r * kVecPerRow) * kElems;
    float* d = dst + r * kLd + c0;
    if (r < valid) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src_row(r) + c0));
      store_vec<T>(d, raw, mul);
    } else {
#pragma unroll
      for (int e = 0; e < kElems; e += 4)
        *reinterpret_cast<float4*>(d + e) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int hq,
                       int hkv, int tq, int s_len, int causal, int window,
                       int q_offset, float scale) {
  constexpr int kLd = D + 4;
  constexpr int kCols4 = D / 4 / kLanesPerRow;   // float4 columns per thread
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = hq / hkv;
  const int n_rows = g * tq;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, n_rows - row0);

  extern __shared__ float smem[];
  float* qs = smem;                  // [kRows, kLd] scaled queries
  float* ks = qs + kRows * kLd;      // [kKeys, kLd] one K tile
  float* vs = ks + kKeys * kLd;      // [kKeys, kLd] one V tile

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int my_row = tid / kLanesPerRow;
  const int sub = tid % kLanesPerRow;
  const bool row_ok = my_row < rows;
  const int my_r = row0 + my_row;
  const int my_t = my_r / g;
  const int my_qpos = my_t + q_offset;

  // stage this tile's queries, scaled before the dot as the TPU kernel does
  stage_rows<T, D>(qs, kRows, rows, [&](int i) {
    const int r = row0 + i;
    const int head = h * g + r % g;
    return q + ((static_cast<size_t>(b) * hq + head) * tq + r / g) * D;
  }, scale);

  // KV range any row of the tile can reach
  const int qpos_lo = row0 / g + q_offset;
  const int qpos_hi = (row0 + rows - 1) / g + q_offset;
  int k_begin = 0, k_end = s_len;
  if (window >= 0) k_begin = max(0, qpos_lo - window + 1);
  if (causal) k_end = min(s_len, qpos_hi + 1);
  const int kt_begin = k_begin / kKeys;
  const int kt_end = k_end > k_begin ? (k_end + kKeys - 1) / kKeys : kt_begin;

  float m_run = -INFINITY, l_run = 0.f;
  float4 acc[kCols4];
#pragma unroll
  for (int c = 0; c < kCols4; ++c) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);

  const size_t kv_base = (static_cast<size_t>(b) * hkv + h) * s_len;
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kKeys;
    const int n_keys = min(kKeys, s_len - k0);
    __syncthreads();   // every reader of the previous tile is done
    stage_rows<T, D>(ks, kKeys, n_keys, [&](int i) {
      return k + (kv_base + k0 + i) * D;
    }, 1.f);
    stage_rows<T, D>(vs, kKeys, n_keys, [&](int i) {
      return v + (kv_base + k0 + i) * D;
    }, 1.f);
    __syncthreads();

    // scores of this thread's 4 keys: key sub + 8 * u of the tile
    float sc[kKeysPerLane];
#pragma unroll
    for (int u = 0; u < kKeysPerLane; ++u) sc[u] = 0.f;
    const float4* qr = reinterpret_cast<const float4*>(qs + my_row * kLd);
#pragma unroll 4
    for (int c = 0; c < D / 4; ++c) {
      const float4 qv = qr[c];
#pragma unroll
      for (int u = 0; u < kKeysPerLane; ++u) {
        const float4 kv = reinterpret_cast<const float4*>(
            ks + (sub + kLanesPerRow * u) * kLd)[c];
        sc[u] = fmaf(qv.x, kv.x, sc[u]);
        sc[u] = fmaf(qv.y, kv.y, sc[u]);
        sc[u] = fmaf(qv.z, kv.z, sc[u]);
        sc[u] = fmaf(qv.w, kv.w, sc[u]);
      }
    }
    float mx = -INFINITY;
#pragma unroll
    for (int u = 0; u < kKeysPerLane; ++u) {
      const int kpos = k0 + sub + kLanesPerRow * u;
      const bool ok = row_ok && kpos < s_len && (!causal || kpos <= my_qpos) &&
                      (window < 0 || my_qpos - kpos < window);
      sc[u] = ok ? sc[u] : -INFINITY;
      mx = fmaxf(mx, sc[u]);
    }
#pragma unroll
    for (int off = 1; off < kLanesPerRow; off <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m_run, mx);
    float p[kKeysPerLane];
    float psum = 0.f;
#pragma unroll
    for (int u = 0; u < kKeysPerLane; ++u) {
      p[u] = (sc[u] == -INFINITY) ? 0.f : expf(sc[u] - m_new);
      psum += p[u];
    }
#pragma unroll
    for (int off = 1; off < kLanesPerRow; off <<= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, off);
    // m_run == -inf: nothing accumulated yet, acc and l are zero
    const float corr = (m_new == -INFINITY) ? 1.f : expf(m_run - m_new);
    l_run = l_run * corr + psum;
    m_run = m_new;
#pragma unroll
    for (int c = 0; c < kCols4; ++c) {
      acc[c].x *= corr;
      acc[c].y *= corr;
      acc[c].z *= corr;
      acc[c].w *= corr;
    }
    // acc += P V: the probability of key 8u + j lives in lane j of the
    // row's 8-lane group
#pragma unroll
    for (int u = 0; u < kKeysPerLane; ++u) {
#pragma unroll
      for (int j = 0; j < kLanesPerRow; ++j) {
        const float pj =
            __shfl_sync(0xffffffffu, p[u], (lane & ~(kLanesPerRow - 1)) | j);
        const float4* vr = reinterpret_cast<const float4*>(
            vs + (kLanesPerRow * u + j) * kLd);
#pragma unroll
        for (int c = 0; c < kCols4; ++c) {
          const float4 vv = vr[sub + kLanesPerRow * c];
          acc[c].x = fmaf(pj, vv.x, acc[c].x);
          acc[c].y = fmaf(pj, vv.y, acc[c].y);
          acc[c].z = fmaf(pj, vv.z, acc[c].z);
          acc[c].w = fmaf(pj, vv.w, acc[c].w);
        }
      }
    }
  }

  if (!row_ok) return;
  const float inv = (l_run == 0.f) ? 0.f : 1.f / l_run;  // no valid key: 0
  const int head = h * g + my_r % g;
  T* o = out + ((static_cast<size_t>(b) * hq + head) * tq + my_t) * D;
#pragma unroll
  for (int c = 0; c < kCols4; ++c) {
    const int col = 4 * (sub + kLanesPerRow * c);
    o[col] = from_f32<T>(acc[c].x * inv);
    o[col + 1] = from_f32<T>(acc[c].y * inv);
    o[col + 2] = from_f32<T>(acc[c].z * inv);
    o[col + 3] = from_f32<T>(acc[c].w * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int hq, int hkv, int tq, int s_len, int causal, int window,
           int q_offset, float scale, void* stream) {
  const size_t smem = sizeof(float) * (kRows + 2 * kKeys) * (D + 4);
  auto kernel = flash_attention_kernel<T, D>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int row_tiles = ((hq / hkv) * tq + kRows - 1) / kRows;
  const dim3 grid(row_tiles, hkv, b);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), hq, hkv, tq, s_len,
      causal, window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int b,
             int hq, int hkv, int tq, int s_len, int d, int causal,
             int window, int q_offset, float scale, void* stream) {
  if (d == 128)
    return launch<T, 128>(q, k, v, out, b, hq, hkv, tq, s_len, causal,
                          window, q_offset, scale, stream);
  if (d == 256)
    return launch<T, 256>(q, k, v, out, b, hq, hkv, tq, s_len, causal,
                          window, q_offset, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q/out [B, Hq, Tq, D], k/v
// [B, Hkv, S, D], contiguous and 16-byte aligned; D 128 or 256.  Query t
// sits at absolute position t + q_offset; key s reaches it iff
// (!causal || s <= pos) && (window < 0 || pos - s < window).
extern "C" int flash_attention(int dtype, const void* q, const void* k,
                               const void* v, void* out, int b, int hq,
                               int hkv, int tq, int s_len, int d, int causal,
                               int window, int q_offset, float scale,
                               void* stream) {
  if (b <= 0 || hkv <= 0 || hq % hkv != 0 || tq <= 0 || s_len <= 0 ||
      q_offset < 0 || b > 65535 || hkv > 65535 ||
      reinterpret_cast<uintptr_t>(q) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(k) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, b, hq, hkv, tq, s_len, d, causal,
                           window, q_offset, scale, stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, b, hq, hkv, tq, s_len, d,
                                   causal, window, q_offset, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
