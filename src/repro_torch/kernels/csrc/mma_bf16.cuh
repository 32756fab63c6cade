// Shared sm_90a building blocks of the bf16 tensor-core kernels
// (flash_attention.cu, paged_attention.cu) and of the staged page decode
// (bebop_decode.cu): 16-byte cp.async copies into shared memory, ldmatrix,
// mma.sync m16n8k16 bf16 x bf16 -> f32, the hi/lo split of a f32 pair,
// and the two attention kernels' step over one K/V tile and their
// epilogue.
//
// The fragment layouts are those of mma.m16n8k16 (PTX ISA): lane = 4 *
// gid + tig holds accumulator rows gid and gid + 8, columns 2 * tig and
// 2 * tig + 1 of each 8-column n-tile.
#pragma once

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; with valid false nothing is read and the
// 16 bytes are zero-filled (src-size 0), so no NaN bits reach a product.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c[16x8] += a[16x16] b[16x8], bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x0, x1) -> bf16 pairs hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split(float x0, float x1, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = pack(h);
  lo = pack(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// -- the bf16 attention kernels' tile step --------------------------------
//
// Both kernels stage Q and double-buffered tiles of kKeys K/V rows in
// shared memory as bf16 rows of D + 8 elements (16 bytes of padding, so
// the eight row addresses of every ldmatrix fall in distinct banks), and
// each walks its own tiles; a warp owns 16 query rows, this lane rows gid
// and gid + 8 (i = 0, 1).  o is the warp's [16, D] f32 output
// accumulator, m_run / l_run the running max (log2 domain) and this
// lane's part of the running sum of its two rows.

// One tile: S = Q K^T with f32 accumulators; the scores scaled to the
// log2 domain and, where need_mask, keys outside [kmin[i], kmax[i]] set
// to -inf; the online softmax step in f32 (a row's max and sum reduced
// over the 4 lanes that hold it by shuffles, no block-wide barrier); then
// O += P V with P split into hi = bf16(P) and lo = bf16(P - hi), which
// keeps the f32 P V to ~2^-16 of |P| (one bf16 P would round it at 2^-9).
// q_frag(kk, a) gives the warp's Q A-fragment of k-step kk; k_tile and
// v_tile are this lane's ldmatrix addresses into the tile (key rows for
// K's B fragments, key rows transposed for V's).  A masked key
// contributes exactly zero; a row with no valid key keeps m_run = -inf,
// o = 0 and l = 0.
template <int D, int kKeys, typename QFrag>
__device__ __forceinline__ void attend_tile(
    float (&o)[D / 8][4], float (&m_run)[2], float (&l_run)[2],
    QFrag q_frag, uint32_t k_tile, uint32_t v_tile, float scale_log2,
    int k0, bool need_mask, const int (&kmin)[2], const int (&kmax)[2]) {
  constexpr int kLd = D + 8;
  constexpr int kTilesS = kKeys / 8;    // S n-tiles a warp
  static_assert(kKeys % 16 == 0 && D % 16 == 0, "mma tile shape");
  const int tig = threadIdx.x & 3;

  float s[kTilesS][4];
#pragma unroll
  for (int j = 0; j < kTilesS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    q_frag(kk, a);
#pragma unroll
    for (int jj = 0; jj < kKeys / 16; ++jj) {
      uint32_t bk[4];
      ldsm_x4(bk, k_tile + (jj * 16 * kLd + kk * 16) * sizeof(__nv_bfloat16));
      mma_bf16(s[2 * jj], a, bk[0], bk[1]);
      mma_bf16(s[2 * jj + 1], a, bk[2], bk[3]);
    }
  }

#pragma unroll
  for (int j = 0; j < kTilesS; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[j][e] * scale_log2;
      if (need_mask) {
        const int kpos = k0 + 8 * j + 2 * tig + (e & 1);
        if (kpos < kmin[e >> 1] || kpos > kmax[e >> 1]) x = -INFINITY;
      }
      s[j][e] = x;
    }
  }

  // rows gid (e = 0, 1) and gid + 8 (e = 2, 3)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kTilesS; ++j)
      mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run[i], mx);
    // no valid key yet: subtract 0, so -inf - -inf never happens
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    const float corr = exp2f(m_run[i] - m_use);   // 0 while m_run = -inf
    m_run[i] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kTilesS; ++j) {
      s[j][2 * i] = exp2f(s[j][2 * i] - m_use);
      s[j][2 * i + 1] = exp2f(s[j][2 * i + 1] - m_use);
      sum += s[j][2 * i] + s[j][2 * i + 1];
    }
    l_run[i] = l_run[i] * corr + sum;   // this lane's part of the row sum
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][2 * i] *= corr;
      o[j][2 * i + 1] *= corr;
    }
  }

  // the S fragments of keys 16kk..16kk+15 are P's A-fragment for that
  // k-step
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    uint32_t hi[4], lo[4];
    split(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
    split(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
    split(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
    split(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
    for (int dd = 0; dd < D / 16; ++dd) {
      uint32_t bv[4];
      ldsm_x4_trans(bv, v_tile + (kk * 16 * kLd + dd * 16) *
                                     sizeof(__nv_bfloat16));
      mma_bf16(o[2 * dd], hi, bv[0], bv[1]);
      mma_bf16(o[2 * dd], lo, bv[0], bv[1]);
      mma_bf16(o[2 * dd + 1], hi, bv[2], bv[3]);
      mma_bf16(o[2 * dd + 1], lo, bv[2], bv[3]);
    }
  }
}

// out = o / l for this lane's rows r and r + 8 (r: the warp's first row +
// gid), zeros where no key was valid: the first d columns of row_ptr(row);
// rows at or past n_rows are not written.
template <int D, typename RowPtr>
__device__ __forceinline__ void store_rows(const float (&o)[D / 8][4],
                                           const float (&l_run)[2], int r,
                                           int n_rows, int d,
                                           RowPtr row_ptr) {
  const int tig = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (r + 8 * i >= n_rows) continue;
    const float den = l == 0.f ? 1.f : l;   // o is 0 there
    __nv_bfloat16* dst = row_ptr(r + 8 * i) + 2 * tig;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (8 * j + 2 * tig < d) {
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
            __floats2bfloat162_rn(o[j][2 * i] / den, o[j][2 * i + 1] / den);
      }
    }
  }
}

}  // namespace sm90
