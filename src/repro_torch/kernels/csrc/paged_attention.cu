// Paged attention through a block table: decode (one query per row) and
// multi-token prefill / mixed / speculative-verify tiles.
//
// Replaces: src/repro/kernels/paged_attention.py:109 paged_attention
// (Pallas body _paged_kernel, :63) and :215 paged_prefill_attention
// (_paged_prefill_kernel, :164).
//
// Bound: bytes.  A row's K/V history is read once and each key feeds only
// g (grouped q heads) x T query rows of 4*D flops, a few flops per byte
// at the main path's shapes (g = 6, T <= 32, bf16), below the ~295
// operations per byte where the tensor cores would become the limit.  At
// these sizes (a few MB a call) what a design must beat is latency: a
// walk over a row's history in small serial steps.
//
// Both bodies fold the g grouped q heads into the query rows (row r ->
// head h*g + r / T, token r % T), so the g heads of a KV head share every
// K/V tile the CTA stages; the g*T rows of (b, h) are one contiguous slab
// of q and of out.  Key s reaches folded row r iff s <= qpos[r] (and s <
// M*bs, the keys the table holds); a masked key contributes exactly zero,
// and a row with no valid key (decode ctx == 0) emits zeros, as the TPU
// kernel does.  The walk over keys stops at the CTA's max(qpos) + 1.
// There is no scalar prefetch on this card: a CTA reads its row's table
// entries itself, and an out-of-range entry is clamped, as an XLA gather
// clamps it.  Decode and prefill are one body, instantiated twice: decode
// reads ctx[b] and uses qpos = ctx - 1.
//
// bf16 design (tensor cores, mma.sync; the flash kernel's mechanism): one
// CTA of 4 warps per (row b, KV head h, tile of kRows = 64 folded query
// rows), 16 rows a warp, so at T 32 with g = 6 the 192 rows of a (b, h)
// take 3 CTAs.  The CTA walks the history in tiles of kKeys keys (64 at
// head_dim 64 and 128, 32 at 256): each tile is gathered from kKeys / bs
// pool blocks (or part of one) through the table, row by row, by 16-byte
// cp.async copies into bf16 shared memory, double-buffered (tile i + 1 is
// in flight while tile i is computed); rows are padded by 16 bytes so the
// eight row addresses of every ldmatrix fall in distinct banks.  Keys at
// or past the CTA's end (max(qpos) + 1, at most M*bs) are zero-filled, so
// table entries at or past M are never read and no stale bits reach a
// product.  Q is staged once, unscaled, and read by ldmatrix each tile.
// The step over a tile is flash_attention.cu's, shared through
// mma_bf16.cuh (attend_tile, store_rows): S = Q K^T and O += P V as
// mma.sync m16n8k16 bf16 x bf16 with f32 accumulators, scale applied to
// the f32 scores (the TPU kernel scales q before the dot: one f32 rounding
// apart), the online softmax in f32 in registers with no block-wide
// barrier, and P split into bf16 hi + lo, which keeps the f32 P V of the
// TPU kernel to ~2^-16 of |P|.  A warp masks only the tiles that cross
// its rows' limits, and skips the tiles none of its rows reaches (a warp
// past the last row skips them all).  This file is built with `-Xptxas
// -warn-spills,-Werror` (kernels/build.py), so a spill fails the build.
// What it still lacks: split-K over long contexts (decode launches only
// B x Hkv CTAs, one walking each row's whole history), and wgmma / TMA
// with a producer warp keeping the K/V ring full.
//
// float32 inputs (card checks only: the served models are bf16) run on the
// CUDA cores in the shape of flash_attention.cu's float32 body: one CTA of
// 128 threads per (b, h, 16 folded rows) walks the history in 32-key
// tiles, gathered through the table by 16-byte loads into fp32 shared
// memory (rows padded to D + 4 floats); eight threads own a row, each
// scoring 4 keys of a tile, with the row's max and sum taken by warp
// shuffles, and keep D / 8 output columns of the row in registers.
// Queries are scaled before the dot, as in the TPU kernel.
//
// Head dims: the bf16 body is built for head_dim 64, 128 and 256 exactly.
// Its D 256 build sits at ptxas's 255 registers, and a runtime head_dim
// (zero-padded columns, as below) spilled there.  The float32 body is
// built for widths D of 64, 128, 256 and 512 and takes any head_dim d <= D
// that is a multiple of 4 (rows of whole 16-byte pieces): columns d..D-1
// are zero-filled in shared memory, add nothing to a score and are not
// written.
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace {

// The last key folded row r of (b, h) reaches: qpos clamped to the table.
template <bool kDecode>
__device__ __forceinline__ int row_limit(const int* pos, int b, int tq,
                                         int r, int keys) {
  const int qpos = kDecode ? pos[b] - 1 : pos[b * tq + r % tq];
  return min(qpos, keys - 1);
}

// -- float32: CUDA cores -----------------------------------------------------

constexpr int kThreads = 128;
constexpr int kRows = 16;                          // folded query rows a CTA
constexpr int kKeys = 32;                          // keys a K/V tile
constexpr int kLanesPerRow = kThreads / kRows;     // 8
constexpr int kKeysPerLane = kKeys / kLanesPerRow; // 4

// D: head_dim rounded up to the body's width; columns d..D-1 are zeros
// in shared memory and are not written.
template <int D, bool kDecode>
__global__ void __launch_bounds__(kThreads)
paged_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k_pool,
                           const float* __restrict__ v_pool,
                           const int* __restrict__ tables,
                           const int* __restrict__ pos, float* __restrict__ out,
                           int hq, int hkv, int tq, int d, int bs, int m,
                           int n_blocks, float scale) {
  constexpr int kLd = D + 4;                     // padded smem row, floats
  constexpr int kVecs = D / 4;                   // float4 a row
  constexpr int kCols4 = kVecs / kLanesPerRow;   // float4 columns a thread
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int g = hq / hkv;
  const int row0 = blockIdx.z * kRows;
  const int rows = min(kRows, g * tq - row0);
  const size_t slab = (static_cast<size_t>(b) * hq + h * g) * tq;
  const int* tbl = tables + static_cast<size_t>(b) * m;

  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                  // [kRows, kLd] scaled queries
  float* ks = qs + kRows * kLd;      // [kKeys, kLd] one K tile
  float* vs = ks + kKeys * kLd;      // [kKeys, kLd] one V tile
  __shared__ int warp_hi_s[kThreads / 32];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int my_row = tid / kLanesPerRow;
  const int sub = tid % kLanesPerRow;
  const bool row_ok = my_row < rows;
  const int lim =
      row_ok ? row_limit<kDecode>(pos, b, tq, row0 + my_row, m * bs) : -1;
  const int warp_hi = __reduce_max_sync(0xffffffffu, lim);
  if (lane == 0) warp_hi_s[tid >> 5] = warp_hi;

  // this tile's queries, scaled before the dot as the TPU kernel does
  for (int i = tid; i < rows * kVecs; i += kThreads) {
    const int r = i / kVecs, c = (i % kVecs) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c < d) {
      x = __ldg(reinterpret_cast<const float4*>(q + (slab + row0 + r) * d + c));
      x.x *= scale; x.y *= scale; x.z *= scale; x.w *= scale;
    }
    *reinterpret_cast<float4*>(qs + r * kLd + c) = x;
  }
  __syncthreads();
  int ctx_end = -1;   // keys [0, ctx_end) are read
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) ctx_end = max(ctx_end, warp_hi_s[w]);
  ctx_end += 1;

  float m_run = -INFINITY, l_run = 0.f;
  float4 acc[kCols4];
#pragma unroll
  for (int c = 0; c < kCols4; ++c) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int k0 = 0; k0 < ctx_end; k0 += kKeys) {
    __syncthreads();   // every reader of the previous tile is done
    // gather the tile through the table; keys at or past ctx_end are zeros
    for (int i = tid; i < kKeys * kVecs; i += kThreads) {
      const int r = i / kVecs, c = (i % kVecs) * 4;
      const int s = k0 + r;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (s < ctx_end && c < d) {
        const int j = s / bs;
        const int phys = min(max(__ldg(tbl + j), 0), n_blocks - 1);
        const size_t src =
            ((static_cast<size_t>(phys) * hkv + h) * bs + (s - j * bs)) * d + c;
        kx = __ldg(reinterpret_cast<const float4*>(k_pool + src));
        vx = __ldg(reinterpret_cast<const float4*>(v_pool + src));
      }
      *reinterpret_cast<float4*>(ks + r * kLd + c) = kx;
      *reinterpret_cast<float4*>(vs + r * kLd + c) = vx;
    }
    __syncthreads();

    // scores of this thread's 4 keys: key sub + 8 * u of the tile
    float sc[kKeysPerLane];
#pragma unroll
    for (int u = 0; u < kKeysPerLane; ++u) sc[u] = 0.f;
    const float4* qr = reinterpret_cast<const float4*>(qs + my_row * kLd);
#pragma unroll 4
    for (int c = 0; c < kVecs; ++c) {
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
      sc[u] = (k0 + sub + kLanesPerRow * u <= lim) ? sc[u] : -INFINITY;
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
  float* o = out + (slab + row0 + my_row) * d;
#pragma unroll
  for (int c = 0; c < kCols4; ++c) {
    const int col = 4 * (sub + kLanesPerRow * c);
    if (col < d) {
      *reinterpret_cast<float4*>(o + col) =
          make_float4(acc[c].x * inv, acc[c].y * inv, acc[c].z * inv,
                      acc[c].w * inv);
    }
  }
}

template <int D, bool kDecode>
int launch_f32(const void* q, const void* k_pool, const void* v_pool,
               const int* tables, const int* pos, void* out, int b, int hq,
               int hkv, int tq, int d, int bs, int m, int n_blocks,
               float scale, void* stream) {
  constexpr size_t smem = sizeof(float) * (kRows + 2 * kKeys) * (D + 4);
  const int row_tiles = ((hq / hkv) * tq + kRows - 1) / kRows;
  if (row_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = paged_attention_f32_kernel<D, kDecode>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(b, hkv, row_tiles);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k_pool),
      static_cast<const float*>(v_pool), tables, pos,
      static_cast<float*>(out), hq, hkv, tq, d, bs, m, n_blocks, scale);
  return static_cast<int>(cudaGetLastError());
}

// -- bf16: tensor cores (mma.sync), gathered K/V tiles by cp.async ----------

namespace tc {

using bf16 = __nv_bfloat16;
using namespace sm90;   // mma_bf16.cuh: cp.async, ldmatrix, mma.sync, split
constexpr int kThreads = 128;      // 4 warps
constexpr int kRows = 64;          // folded query rows per CTA, 16 a warp
constexpr float kLog2e = 1.4426950408889634f;

template <int D, int kKeys, bool kDecode>
__global__ void __launch_bounds__(kThreads)
paged_attention_bf16_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k_pool,
                            const bf16* __restrict__ v_pool,
                            const int* __restrict__ tables,
                            const int* __restrict__ pos,
                            bf16* __restrict__ out, int hq, int hkv, int tq,
                            int bs, int m, int n_blocks, float scale_log2) {
  constexpr int kLd = D + 8;            // padded smem row, in elements
  constexpr int kChunks = D / 8;        // 16-byte chunks a row
  static_assert(kRows * kChunks % kThreads == 0, "Q staging");
  static_assert(kKeys * kChunks % kThreads == 0, "K/V staging");

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int g = hq / hkv;
  const int n_rows = g * tq;
  const int row0 = blockIdx.z * kRows;
  const int rows = min(kRows, n_rows - row0);
  // the folded rows of (b, h): one contiguous slab of q and of out
  const size_t slab = (static_cast<size_t>(b) * hq + h * g) * tq;
  const int* tbl = tables + static_cast<size_t>(b) * m;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // [kRows, kLd]
  bf16* ks = qs + kRows * kLd;                    // [2, kKeys, kLd]
  bf16* vs = ks + 2 * kKeys * kLd;                // [2, kKeys, kLd]
  __shared__ int warp_hi_s[kThreads / 32];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2;

  // last key each of this thread's two rows reaches (-1: none); rows past
  // the slab take no part in the warp's limits
  int lim[2], lo = INT32_MAX, hi = -1;
  const int kmin[2] = {0, 0};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + 16 * warp + gid + 8 * i;
    lim[i] = -1;
    if (r < n_rows) {
      lim[i] = row_limit<kDecode>(pos, b, tq, r, m * bs);
      lo = min(lo, lim[i]);
      hi = max(hi, lim[i]);
    }
  }
  // keys every row of the warp reaches: a tile inside [0, warp_lo] needs
  // no mask; a tile past warp_hi is skipped by the warp
  const int warp_lo = __reduce_min_sync(0xffffffffu, lo);
  const int warp_hi = __reduce_max_sync(0xffffffffu, hi);
  if (lane == 0) warp_hi_s[warp] = warp_hi;
  __syncthreads();
  int ctx_end = -1;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) ctx_end = max(ctx_end, warp_hi_s[w]);
  ctx_end += 1;   // keys [0, ctx_end) are read; ctx_end <= M * bs
  const int n_tiles = (ctx_end + kKeys - 1) / kKeys;

  // gather keys k0 .. k0 + kKeys - 1 through the table; keys at or past
  // ctx_end are zero-filled and their table entries never read
  auto load_kv = [&](int kt, int stage) {
    const int k0 = kt * kKeys;
    bf16* kd = ks + stage * kKeys * kLd;
    bf16* vd = vs + stage * kKeys * kLd;
#pragma unroll
    for (int it = 0; it < kKeys * kChunks / kThreads; ++it) {
      const int i = tid + it * kThreads;
      const int r = i / kChunks, c = (i % kChunks) * 8;
      const int s = k0 + r;
      const bool ok = s < ctx_end;
      size_t src = 0;
      if (ok) {
        const int j = s / bs;
        const int phys = min(max(__ldg(tbl + j), 0), n_blocks - 1);
        src = ((static_cast<size_t>(phys) * hkv + h) * bs + (s - j * bs)) * D +
              c;
      }
      cp_async16(smem_addr(kd + r * kLd + c), k_pool + src, ok);
      cp_async16(smem_addr(vd + r * kLd + c), v_pool + src, ok);
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
  auto q_frag = [&](int kk, uint32_t (&a)[4]) {
    ldsm_x4(a, q_lane + kk * 32);
  };

  if (n_tiles > 0) {
    // Q once per CTA, then the first K/V tile, in one copy group
#pragma unroll
    for (int it = 0; it < kRows * kChunks / kThreads; ++it) {
      const int i = tid + it * kThreads;
      const int r = i / kChunks, c = (i % kChunks) * 8;
      const bool ok = r < rows;
      cp_async16(smem_addr(qs + r * kLd + c),
                 q + (ok ? (slab + row0 + r) * D + c : 0), ok);
    }
    load_kv(0, 0);
    cp_async_commit();
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int stage = kt & 1;
    if (kt + 1 < n_tiles) {
      load_kv(kt + 1, stage ^ 1);   // stage ^ 1 was freed by the last barrier
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = kt * kKeys;
    if (k0 <= warp_hi) {   // warp-uniform: some row of the warp reaches it
      // mask where the tile crosses the limit of one of the warp's rows
      attend_tile<D, kKeys>(o, m_run, l_run, q_frag,
                            k_lane + stage * kStageBytes,
                            v_lane + stage * kStageBytes, scale_log2, k0,
                            k0 + kKeys - 1 > warp_lo, kmin, lim);
    }
    __syncthreads();   // every reader of this stage is done
  }

  // out = acc / l, zeros where no key was valid
  store_rows<D>(o, l_run, row0 + 16 * warp + gid, n_rows, D,
                [&](int r) { return out + (slab + r) * D; });
}

template <int D, int kKeys, bool kDecode>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const int* tables, const int* pos, void* out, int b, int hq,
           int hkv, int tq, int /* d == D */, int bs, int m, int n_blocks,
           float scale, void* stream) {
  constexpr size_t smem = sizeof(bf16) * (kRows + 4 * kKeys) * (D + 8);
  const int row_tiles = ((hq / hkv) * tq + kRows - 1) / kRows;
  if (row_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = paged_attention_bf16_kernel<D, kKeys, kDecode>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(b, hkv, row_tiles);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_pool),
      static_cast<const bf16*>(v_pool), tables, pos, static_cast<bf16*>(out),
      hq, hkv, tq, bs, m, n_blocks, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// dtype: 0 = float32 (head_dim a multiple of 4, up to 512: every q and K/V
// row is whole 16-byte pieces), 1 = bfloat16 (head_dim 64, 128 or 256).
template <bool kDecode>
int dispatch(int dtype, const void* q, const void* k_pool, const void* v_pool,
             const int* tables, const int* pos, void* out, int b, int hq,
             int hkv, int tq, int d, int bs, int m, int n_blocks, float scale,
             void* stream) {
  if (b <= 0 || hkv <= 0 || hkv > 65535 || hq % hkv != 0 || tq <= 0 ||
      d <= 0 || bs <= 0 || m <= 0 || n_blocks <= 0 ||
      reinterpret_cast<uintptr_t>(q) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(k_pool) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v_pool) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define PAGED_ARGS q, k_pool, v_pool, tables, pos, out, b, hq, hkv, tq, d, \
                   bs, m, n_blocks, scale, stream
  if (dtype == 0 && d % 4 == 0) {
    if (d <= 64) return launch_f32<64, kDecode>(PAGED_ARGS);
    if (d <= 128) return launch_f32<128, kDecode>(PAGED_ARGS);
    if (d <= 256) return launch_f32<256, kDecode>(PAGED_ARGS);
    if (d <= 512) return launch_f32<512, kDecode>(PAGED_ARGS);
  }
  // the bf16 body's K/V tiles hold 64 keys, 32 at head_dim 256, where the
  // output accumulator takes 128 registers a thread
  if (dtype == 1 && d == 64) return tc::launch<64, 64, kDecode>(PAGED_ARGS);
  if (dtype == 1 && d == 128) return tc::launch<128, 64, kDecode>(PAGED_ARGS);
  if (dtype == 1 && d == 256) return tc::launch<256, 32, kDecode>(PAGED_ARGS);
#undef PAGED_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q/out [B, Hq, D]; pools [N, Hkv, bs, D]; tables [B, M] int32; ctx [B]
// int32 (keys 0..ctx-1 participate).  q and the pools 16-byte aligned.
extern "C" int paged_attention_decode(int dtype, const void* q,
                                      const void* k_pool, const void* v_pool,
                                      const int* tables, const int* ctx,
                                      void* out, int b, int hq, int hkv,
                                      int d, int bs, int m, int n_blocks,
                                      float scale, void* stream) {
  return dispatch<true>(dtype, q, k_pool, v_pool, tables, ctx, out, b, hq,
                        hkv, 1, d, bs, m, n_blocks, scale, stream);
}

// q/out [B, Hq, T, D]; qpos [B, T] int32 (key s reaches query t iff
// s <= qpos[b, t]); pools and tables as above.
extern "C" int paged_prefill_attention(int dtype, const void* q,
                                       const void* k_pool,
                                       const void* v_pool, const int* tables,
                                       const int* qpos, void* out, int b,
                                       int hq, int hkv, int tq, int d, int bs,
                                       int m, int n_blocks, float scale,
                                       void* stream) {
  return dispatch<false>(dtype, q, k_pool, v_pool, tables, qpos, out, b, hq,
                         hkv, tq, d, bs, m, n_blocks, scale, stream);
}
