// Paged attention through a block table: decode (one query per row) and
// multi-token prefill / mixed / speculative-verify tiles.
//
// Replaces: src/repro/kernels/paged_attention.py:109 paged_attention
// (Pallas body _paged_kernel, :63) and :215 paged_prefill_attention
// (_paged_prefill_kernel, :164).
//
// Bound: bytes.  A row's K/V history is read once and each key feeds only
// g (grouped q heads) x T query rows of 2*D flops, a few flops per byte
// at the main path's shapes (g = 6, T <= 32, bf16), below the ~295
// operations per byte where the tensor cores would become the limit.
//
// Design: one CTA per (row b, KV head h, tile of up to kMaxRows folded
// query rows).  The g grouped q heads are folded into the query rows
// (row r -> head h*g + r / T, token r % T), so every K/V block gathered
// into shared memory is shared by all g heads instead of being re-read
// per head.  There is no scalar prefetch on this card: the CTA reads its
// row's table entries itself, block by block.  The loop over logical
// blocks stops at the tile's max(qpos) + 1 (decode: ctx), so blocks past
// the context are never read.  Softmax is online and in fp32: running max,
// denominator and accumulator live in shared memory; key s reaches query
// row r iff s <= qpos[r], a masked key contributes exactly zero, and a row
// with no valid key (decode ctx == 0) emits zeros, as the TPU kernel does.
// Decode and prefill are one kernel body, instantiated twice: decode reads
// ctx[b] and uses qpos = ctx - 1.  Each K/V block is fetched with 16-byte
// vector loads into registers one block ahead of its use, so a block's
// memory latency overlaps the previous block's arithmetic instead of being
// paid per element.  Shared-memory rows are padded to D + 1 floats so the
// per-key dot products hit distinct banks, and the dot products keep four
// partial sums in flight.  They run on CUDA cores, not tensor cores;
// wgmma tiles and split-K over long contexts are later work.
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxRows = 16;  // folded query rows per CTA
constexpr int kMaxVec = 8;    // 16-byte vectors per thread per K (V) block

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

// One K and one V block in flight, as 16-byte vectors in registers.
struct BlockRegs {
  uint4 k[kMaxVec];
  uint4 v[kMaxVec];
};

__device__ __forceinline__ void load_block(BlockRegs& r, const uint4* kb,
                                           const uint4* vb, int nvec) {
#pragma unroll
  for (int u = 0; u < kMaxVec; ++u) {
    const int i = threadIdx.x + u * kThreads;
    if (i < nvec) {
      r.k[u] = __ldg(kb + i);
      r.v[u] = __ldg(vb + i);
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_block(const BlockRegs& r, float* ks,
                                            float* vs, int d, int ld,
                                            int nvec) {
  constexpr int kElems = 16 / sizeof(T);   // d is a multiple of kElems
#pragma unroll
  for (int u = 0; u < kMaxVec; ++u) {
    const int i = threadIdx.x + u * kThreads;
    if (i < nvec) {
      const int e0 = i * kElems;
      const int s = e0 / d, c0 = e0 - s * d;
      const T* ke = reinterpret_cast<const T*>(&r.k[u]);
      const T* ve = reinterpret_cast<const T*>(&r.v[u]);
#pragma unroll
      for (int e = 0; e < kElems; ++e) {
        ks[s * ld + c0 + e] = to_f32(ke[e]);
        vs[s * ld + c0 + e] = to_f32(ve[e]);
      }
    }
  }
}

size_t smem_bytes(int d, int bs) {
  const int ld = d + 1;
  return sizeof(float) * (2 * kMaxRows * ld + 2 * bs * ld + kMaxRows * bs +
                          3 * kMaxRows) +
         sizeof(int) * kMaxRows;
}

template <typename T, bool kDecode>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const int* __restrict__ tables,
                       const int* __restrict__ pos, T* __restrict__ out,
                       int hq, int hkv, int tq, int d, int bs, int m,
                       int n_blocks, float scale) {
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int g = hq / hkv;
  const int row0 = blockIdx.z * kMaxRows;
  const int rows = min(kMaxRows, g * tq - row0);
  const int ld = d + 1;

  extern __shared__ float smem[];
  float* qs = smem;                    // [kMaxRows, ld] scaled queries
  float* acc = qs + kMaxRows * ld;     // [kMaxRows, ld] output accumulator
  float* ks = acc + kMaxRows * ld;     // [bs, ld] one K block
  float* vs = ks + bs * ld;            // [bs, ld] one V block
  float* ps = vs + bs * ld;            // [kMaxRows, bs] scores / probs
  float* m_s = ps + kMaxRows * bs;     // [kMaxRows] running max
  float* l_s = m_s + kMaxRows;         // [kMaxRows] running denominator
  float* c_s = l_s + kMaxRows;         // [kMaxRows] rescale factor
  int* qp_s = reinterpret_cast<int*>(c_s + kMaxRows);  // [kMaxRows] qpos
  __shared__ int ctx_s;

  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    const int t = (row0 + i) % tq;
    qp_s[i] = kDecode ? pos[b] - 1 : pos[b * tq + t];
    m_s[i] = -INFINITY;
    l_s[i] = 0.f;
  }
  for (int i = threadIdx.x; i < rows * d; i += blockDim.x) {
    const int rr = i / d, c = i - rr * d;
    const int r = row0 + rr;
    const int head = h * g + r / tq, t = r % tq;
    const size_t qi = ((static_cast<size_t>(b) * hq + head) * tq + t) * d + c;
    qs[rr * ld + c] = to_f32(q[qi]) * scale;
    acc[rr * ld + c] = 0.f;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int mx = -1;
    for (int i = 0; i < rows; ++i) mx = max(mx, qp_s[i]);
    ctx_s = mx + 1;
  }
  __syncthreads();
  const int ctx = ctx_s;
  const int nblk = ctx > 0 ? min((ctx + bs - 1) / bs, m) : 0;
  const int nvec = bs * d * static_cast<int>(sizeof(T)) / 16;
  // clamp like an XLA gather: an out-of-range id never reads outside
  auto block_ptr = [&](const T* pool, int j) {
    const int phys = min(max(tables[b * m + j], 0), n_blocks - 1);
    return reinterpret_cast<const uint4*>(
        pool + (static_cast<size_t>(phys) * hkv + h) * bs * d);
  };
  BlockRegs regs;
  if (nblk > 0) load_block(regs, block_ptr(k_pool, 0), block_ptr(v_pool, 0),
                           nvec);

  for (int j = 0; j < nblk; ++j) {
    // the previous iteration ended with a barrier: ks/vs are free
    store_block<T>(regs, ks, vs, d, ld, nvec);
    if (j + 1 < nblk) {
      load_block(regs, block_ptr(k_pool, j + 1), block_ptr(v_pool, j + 1),
                 nvec);
    }
    __syncthreads();
    const int base = j * bs;
    for (int i = threadIdx.x; i < rows * bs; i += blockDim.x) {
      const int rr = i / bs, s = i - rr * bs;
      const float* qr = qs + rr * ld;
      const float* kr = ks + s * ld;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      for (int c = 0; c < d; c += 4) {   // d % 4 == 0 (16-byte rows)
        a0 += qr[c] * kr[c];
        a1 += qr[c + 1] * kr[c + 1];
        a2 += qr[c + 2] * kr[c + 2];
        a3 += qr[c + 3] * kr[c + 3];
      }
      const float dot = (a0 + a1) + (a2 + a3);
      ps[rr * bs + s] = (base + s <= qp_s[rr]) ? dot : -INFINITY;
    }
    __syncthreads();
    for (int rr = threadIdx.x; rr < rows; rr += blockDim.x) {
      const float m_prev = m_s[rr];
      float mx = m_prev;
      for (int s = 0; s < bs; ++s) mx = fmaxf(mx, ps[rr * bs + s]);
      float sum = 0.f;
      for (int s = 0; s < bs; ++s) {
        const float sc = ps[rr * bs + s];
        const float p = (sc == -INFINITY) ? 0.f : expf(sc - mx);
        ps[rr * bs + s] = p;
        sum += p;
      }
      const float corr = (mx == -INFINITY) ? 1.f : expf(m_prev - mx);
      l_s[rr] = l_s[rr] * corr + sum;
      m_s[rr] = mx;
      c_s[rr] = corr;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < rows * d; i += blockDim.x) {
      const int rr = i / d, c = i - rr * d;
      float a = acc[rr * ld + c] * c_s[rr];
      for (int s = 0; s < bs; ++s) a += ps[rr * bs + s] * vs[s * ld + c];
      acc[rr * ld + c] = a;
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < rows * d; i += blockDim.x) {
    const int rr = i / d, c = i - rr * d;
    const int r = row0 + rr;
    const int head = h * g + r / tq, t = r % tq;
    const float l = l_s[rr];
    const float denom = (l == 0.f) ? 1.f : l;  // ctx == 0 rows emit zeros
    const size_t oi = ((static_cast<size_t>(b) * hq + head) * tq + t) * d + c;
    out[oi] = from_f32<T>(acc[rr * ld + c] / denom);
  }
}

template <typename T, bool kDecode>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const int* tables, const int* pos, void* out, int b, int hq,
           int hkv, int tq, int d, int bs, int m, int n_blocks, float scale,
           void* stream) {
  if (b <= 0 || hkv <= 0 || hq % hkv != 0 || tq <= 0 || d <= 0 || bs <= 0 ||
      m <= 0 || n_blocks <= 0 || (d * sizeof(T)) % 16 != 0 ||
      bs * d * sizeof(T) > 16u * kThreads * kMaxVec ||
      reinterpret_cast<uintptr_t>(k_pool) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v_pool) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int row_tiles = ((hq / hkv) * tq + kMaxRows - 1) / kMaxRows;
  const dim3 grid(b, hkv, row_tiles);
  const size_t smem = smem_bytes(d, bs);
  auto kernel = paged_attention_kernel<T, kDecode>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), tables, pos, static_cast<T*>(out), hq,
      hkv, tq, d, bs, m, n_blocks, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q/out [B, Hq, D]; pools [N, Hkv, bs, D];
// tables [B, M] int32; ctx [B] int32 (keys 0..ctx-1 participate).
extern "C" int paged_attention_decode(int dtype, const void* q,
                                      const void* k_pool, const void* v_pool,
                                      const int* tables, const int* ctx,
                                      void* out, int b, int hq, int hkv,
                                      int d, int bs, int m, int n_blocks,
                                      float scale, void* stream) {
  if (dtype == 0)
    return launch<float, true>(q, k_pool, v_pool, tables, ctx, out, b, hq,
                               hkv, 1, d, bs, m, n_blocks, scale, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, true>(q, k_pool, v_pool, tables, ctx, out,
                                       b, hq, hkv, 1, d, bs, m, n_blocks,
                                       scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
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
  if (dtype == 0)
    return launch<float, false>(q, k_pool, v_pool, tables, qpos, out, b, hq,
                                hkv, tq, d, bs, m, n_blocks, scale, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, false>(q, k_pool, v_pool, tables, qpos, out,
                                        b, hq, hkv, tq, d, bs, m, n_blocks,
                                        scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
