// Blockwise (flash) attention over a dense K/V: GQA, causal, optional
// sliding window, query offset.  Serves dense prefill and full-sequence
// attention (scoring) of the dense and hybrid models.
//
// Replaces: src/repro/kernels/flash_attention.py:95 flash_attention
// (Pallas body _attn_kernel, :29).
//
// Bound: a call moves q, k, v and out once and does 4 * D flops per
// unmasked (query, key) pair.  At recurrentgemma-9b's 2,000-token prompt
// (g = 16 query heads per KV head, D 256, window 2048) that is 32.7 GFLOP
// against 35 MB: bound by operations on the bf16 tensor cores.  At
// qwen2-1.5b's 400-token prefill (g = 6, D 128) it is 0.49 GFLOP against
// 2.9 MB: bound by bytes, by a small margin.  At seamless-m4t-medium's
// heads (MHA, g = 1, D 64) its 400-token causal decoder prefill is 0.33
// GFLOP against 3.3 MB, and its cross-attention over 50 frames (Tq 400,
// S 50) 0.08 GFLOP against 1.8 MB: both bound by bytes.
//
// bf16 design (tensor cores, mma.sync): one CTA of 4 warps per (tile of
// kRows = 64 folded query rows, KV head, batch row), 16 rows a warp.
// Query rows are folded time-major, row r -> token r / g, head
// h*g + r % g, so the g heads that share a KV head share every K/V tile
// the CTA stages, and all rows of a tile have (nearly) the same causal
// and window limits.  The CTA walks only the KV tiles that can reach its
// rows (the TPU kernel's pl.when skip, here as loop bounds); a warp masks
// in registers only the tiles that cross its rows' limits or the ragged
// end of S, so any Tq, S and q_offset work.  Under MHA (g = 1) a tile's
// 64 rows are 64 tokens of one head.  Tiles of K and V (64 keys at D 64
// and 128, 32 at D 256) are staged in bf16 in shared memory by 16-byte
// cp.async copies, double-buffered (tile i + 1 is in flight while tile i
// is computed); rows are padded by 16 bytes so the eight row addresses
// of every ldmatrix fall in distinct banks.  Q is staged once per CTA, unscaled:
// at D 64 and 128 each warp holds its 16 rows as mma A-fragments in
// registers;
// at D 256 those would take 64 more registers a thread and spill, so the
// fragments are read from shared memory by ldmatrix on every tile.
// S = Q K^T runs as mma.sync m16n8k16 bf16 x bf16 with f32 accumulators
// (K fragments by ldmatrix from key rows; bf16 products are exact in f32,
// so this is the TPU's f32 dot up to summation order), and scale is
// applied to the f32 scores.  The TPU kernel scales q before the dot:
// that is the same number at D 64 and 256 (scale 1/8 and 1/16, exact) and
// one rounding apart at D 128.  The online softmax runs in f32 on the accumulator
// fragments (exp2 of the log2(e)-scaled scores); a row's max and sum are
// reduced over the 4 lanes that hold it by shuffles.  P reuses the S
// accumulator layout as the A-fragment of the PV product, split in f32
// into hi = bf16(P) and lo = bf16(P - hi): hi V + lo V, two mma.sync into
// the f32 output accumulator, keeps the TPU kernel's f32 P V to ~2^-16 of
// |P| (one bf16 P would round it at 2^-9 and move the bf16 outputs).
// V fragments come from V rows by ldmatrix.trans.  A masked key
// contributes exactly zero, and a row with no valid key emits zeros (as
// ref.attention does); its max stays -inf, so exp2 is taken against 0.
// That step over a tile and the epilogue are mma_bf16.cuh's attend_tile
// and store_rows, which paged_attention.cu's bf16 body shares; this file
// keeps the staging and the causal / window walk.
// The output accumulator is D / 2 f32 registers a thread: at D 256, 64-key
// tiles (32 more score registers) spill at ptxas's 255-register limit,
// hence 32-key tiles there.  This file is built with
// `-Xptxas -warn-spills,-Werror` (kernels/build.py), so a spill fails the
// build.
//
// What it still lacks: wgmma (the only way to the card's full
// tensor-core rate; mma.sync issues one warp's 16x8x16 product at a
// time), TMA copies, and warp specialisation (one producer warp keeping
// the K/V ring full while consumer warpgroups compute).
//
// float32 inputs keep the first version's body (CUDA cores, fp32): no
// full-width path launches it; the card checks hold it.  One CTA of 128
// threads per 16 folded query rows; each K/V tile of 32 keys is staged in
// shared memory in fp32 (rows padded to D + 4 floats); eight threads own
// one query row, each scoring 4 keys of the tile, with the row's max and
// sum taken by warp shuffles, and keep D / 8 output columns of the row in
// registers.  Queries are scaled before the dot, as in the TPU kernel;
// the softmax is online and in fp32, and masks as the bf16 body does.
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 16;          // folded query rows per CTA
constexpr int kKeys = 32;          // keys per K/V tile
constexpr int kLanesPerRow = kThreads / kRows;   // 8
constexpr int kKeysPerLane = kKeys / kLanesPerRow;  // 4

__device__ __forceinline__ float to_f32(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
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


// -- bf16: tensor cores (mma.sync), K/V double-buffered by cp.async ---------

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 128;      // 4 warps
constexpr int kRows = 64;          // folded query rows per CTA, 16 a warp
constexpr float kLog2e = 1.4426950408889634f;
using namespace sm90;   // mma_bf16.cuh: cp.async, ldmatrix, mma.sync, split

template <int D, int kKeys>
__global__ void __launch_bounds__(kThreads)
flash_attention_bf16_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v, bf16* __restrict__ out,
                            int hq, int hkv, int tq, int s_len, int causal,
                            int window, int q_offset, float scale_log2) {
  constexpr int kLd = D + 8;            // padded smem row, in elements
  constexpr int kChunks = D / 8;        // 16-byte chunks a row
  constexpr bool kQInRegs = D <= 128;
  static_assert(kRows * kChunks % kThreads == 0, "Q staging");
  static_assert(kKeys * kChunks % kThreads == 0, "K/V staging");

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = hq / hkv;
  const int n_rows = g * tq;
  // the last row tiles reach the most keys under a causal mask: start them
  // first so the short ones fill the tail of the grid
  const int row0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int rows = min(kRows, n_rows - row0);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // [kRows, kLd]
  bf16* ks = qs + kRows * kLd;                    // [2, kKeys, kLd]
  bf16* vs = ks + 2 * kKeys * kLd;                // [2, kKeys, kLd]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2;

  // KV range any row of the CTA can reach
  const int qpos_lo = row0 / g + q_offset;
  const int qpos_hi = (row0 + rows - 1) / g + q_offset;
  int k_begin = 0, k_end = s_len;
  if (window >= 0) k_begin = max(0, qpos_lo - window + 1);
  if (causal) k_end = min(s_len, qpos_hi + 1);
  const int kt_begin = k_begin / kKeys;
  const int kt_end = k_end > k_begin ? (k_end + kKeys - 1) / kKeys : kt_begin;

  // valid keys of this thread's two rows: kmin[i] <= key <= kmax[i]
  int kmin[2], kmax[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = (row0 + 16 * warp + gid + 8 * i) / g + q_offset;
    kmin[i] = window >= 0 ? qpos - window + 1 : 0;
    kmax[i] = causal ? min(qpos, s_len - 1) : s_len - 1;
  }
  // keys every row of the warp reaches: a tile inside [free_lo, free_hi]
  // needs no mask
  const int wq_lo = (row0 + 16 * warp) / g + q_offset;
  const int wq_hi = (row0 + 16 * warp + 15) / g + q_offset;
  const int free_lo = window >= 0 ? wq_hi - window + 1 : 0;
  const int free_hi = causal ? min(wq_lo, s_len - 1) : s_len - 1;

  const size_t kv_base = (static_cast<size_t>(b) * hkv + h) * s_len;
  auto load_kv = [&](int kt, int stage) {
    const int k0 = kt * kKeys;
    bf16* kd = ks + stage * kKeys * kLd;
    bf16* vd = vs + stage * kKeys * kLd;
#pragma unroll
    for (int it = 0; it < kKeys * kChunks / kThreads; ++it) {
      const int i = tid + it * kThreads;
      const int r = i / kChunks, c = (i % kChunks) * 8;
      const bool ok = k0 + r < s_len;
      const size_t src = (kv_base + (ok ? k0 + r : 0)) * D + c;
      cp_async16(smem_addr(kd + r * kLd + c), k + src, ok);
      cp_async16(smem_addr(vd + r * kLd + c), v + src, ok);
    }
  };

  float o[D / 8][4];   // the warp's [16, D] output accumulator
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  // ldmatrix lane addresses (bytes): Q rows of this warp for A fragments,
  // key rows for K's B fragments, key rows (transposed) for V's
  const int mat = lane >> 3, mrow = lane & 7;
  const uint32_t q_lane = smem_addr(
      qs + (16 * warp + (mat & 1) * 8 + mrow) * kLd + (mat >> 1) * 8);
  const uint32_t k_lane =
      smem_addr(ks + ((mat >> 1) * 8 + mrow) * kLd + (mat & 1) * 8);
  const uint32_t v_lane =
      smem_addr(vs + ((mat & 1) * 8 + mrow) * kLd + (mat >> 1) * 8);
  constexpr uint32_t kStageBytes = kKeys * kLd * sizeof(bf16);
  uint32_t qf[kQInRegs ? D / 16 : 1][4];

  if (kt_begin < kt_end) {
    // Q once per CTA, then the first K/V tile, in one copy group
#pragma unroll
    for (int it = 0; it < kRows * kChunks / kThreads; ++it) {
      const int i = tid + it * kThreads;
      const int r = i / kChunks, c = (i % kChunks) * 8;
      const int row = row0 + r;
      const bool ok = r < rows;
      const size_t src =
          ok ? ((static_cast<size_t>(b) * hq + h * g + row % g) * tq +
                row / g) * D + c
             : 0;
      cp_async16(smem_addr(qs + r * kLd + c), q + src, ok);
    }
    load_kv(kt_begin, 0);
    cp_async_commit();
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int stage = (kt - kt_begin) & 1;
    if (kt + 1 < kt_end) {
      load_kv(kt + 1, stage ^ 1);   // stage ^ 1 was freed by the last barrier
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (kQInRegs) {
      if (kt == kt_begin) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) ldsm_x4(qf[kk], q_lane + kk * 32);
      }
    }
    auto q_frag = [&](int kk, uint32_t (&a)[4]) {
      if constexpr (kQInRegs) {
        a[0] = qf[kk][0]; a[1] = qf[kk][1]; a[2] = qf[kk][2]; a[3] = qf[kk][3];
      } else {
        ldsm_x4(a, q_lane + kk * 32);
      }
    };
    // mask where the tile crosses a limit of the warp's rows or the end of S
    const int k0 = kt * kKeys;
    attend_tile<D, kKeys>(o, m_run, l_run, q_frag,
                          k_lane + stage * kStageBytes,
                          v_lane + stage * kStageBytes, scale_log2, k0,
                          k0 < free_lo || k0 + kKeys - 1 > free_hi, kmin,
                          kmax);
    __syncthreads();   // every reader of this stage is done
  }

  // out = acc / l, zeros where no key was valid
  store_rows<D>(o, l_run, row0 + 16 * warp + gid, n_rows, D, [&](int r) {
    return out + ((static_cast<size_t>(b) * hq + h * g + r % g) * tq +
                  r / g) * D;
  });
}

template <int D, int kKeys>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int hq, int hkv, int tq, int s_len, int causal, int window,
           int q_offset, float scale, void* stream) {
  constexpr size_t smem = sizeof(bf16) * (kRows + 4 * kKeys) * (D + 8);
  auto kernel = flash_attention_bf16_kernel<D, kKeys>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int row_tiles = ((hq / hkv) * tq + kRows - 1) / kRows;
  const dim3 grid(row_tiles, hkv, b);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), hq, hkv, tq,
      s_len, causal, window, q_offset, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

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

// keys a K/V tile of the bf16 kernel holds, by head_dim: at D 64 the
// output accumulator is half D 128's, so 64-key tiles fit with room to
// spare (ptxas's report is in the build log; a spill fails the build)
constexpr int kKeysD64 = 64;
constexpr int kKeysD128 = 64;
constexpr int kKeysD256 = 32;

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int b,
             int hq, int hkv, int tq, int s_len, int d, int causal,
             int window, int q_offset, float scale, void* stream) {
  if (d == 64)
    return launch<T, 64>(q, k, v, out, b, hq, hkv, tq, s_len, causal,
                         window, q_offset, scale, stream);
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
// [B, Hkv, S, D], contiguous and 16-byte aligned; D 64, 128 or 256.  Query t
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
  if (dtype == 1 && d == 64)
    return tc::launch<64, kKeysD64>(q, k, v, out, b, hq, hkv, tq, s_len,
                                    causal, window, q_offset, scale, stream);
  if (dtype == 1 && d == 128)
    return tc::launch<128, kKeysD128>(q, k, v, out, b, hq, hkv, tq, s_len,
                                      causal, window, q_offset, scale, stream);
  if (dtype == 1 && d == 256)
    return tc::launch<256, kKeysD256>(q, k, v, out, b, hq, hkv, tq, s_len,
                                      causal, window, q_offset, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
