// RG-LRU recurrence (RecurrentGemma): h_t = a_t * h_{t-1} + x_t, h_{-1} = 0.
//
// Replaces: src/repro/kernels/rglru_scan.py:51 rglru_scan (Pallas body
// _rglru_kernel, :27).
//
// Bound: bytes.  Each element of x and a is read once and each h written
// once for one multiply and one add: far below the card's operations per
// byte, so the least time is the bytes over the memory rate.  A channel's
// chain is serial in T (one rounded multiply, one rounded add a step:
// ~400 x 8 cycles at T 400, under the byte bound), so the whole problem is
// keeping enough bytes in flight on enough SMs.
//
// The old design (one thread per (row, channel), CTAs of 128, each thread
// loading its own step's x and a) put 32 CTAs on 132 SMs at B 1, D 4096,
// and had in flight only the few loads an unrolled loop hoists: 9% of the
// memory rate.
//
// Design: one warp a CTA, owning (row, slab of 128 bytes of channels: 32
// float32 or 64 bfloat16), so B 1, D 4096 float32 is 128 CTAs.  A ring of
// kStages tiles of [kSteps x slab] of x and of a in shared memory is kept
// full by 16-byte cp.async, kStages - 1 tiles ahead of the one being
// walked.  The warp reads a landed tile into registers and walks the chain,
// a lane a channel (two in bfloat16); each step's h goes into the tile's
// slot of x, and the finished tile leaves as whole rows, 16 bytes a lane
// (a 4-byte store a step from every lane held the kernel to a fraction of
// the memory rate).  A slab past D is masked at the edge (cp.async
// zero-fills the missing pieces, nothing past D is stored).  Rows that are
// not 16-byte aligned (D * itemsize not a multiple of 16) are staged and
// stored the same way by ordinary loads and stores.  The step is a rounded
// multiply then a rounded add (__fmul_rn, __fadd_rn, never contracted to
// an FMA), the same two roundings as the plain PyTorch version, so the two
// agree bit for bit.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace {

using sm90::cp_async16;
using sm90::cp_async_commit;
using sm90::cp_async_wait;
using sm90::smem_addr;

constexpr int kLanes = 32;       // one warp a CTA: it copies and walks
constexpr int kSlabBytes = 128;  // a slab row: one coalesced store a step
constexpr int kSteps = 32;       // steps a tile
constexpr int kStages = 8;       // tiles in the ring

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

template <typename T>
constexpr int kSlab = kSlabBytes / static_cast<int>(sizeof(T));  // channels
constexpr int kSmem = 2 * kStages * kSteps * kSlabBytes;  // x and a rings

// kAsync: rows are 16-byte aligned, tiles are copied in by cp.async and
// h leaves in 16-byte pieces
template <typename T, bool kAsync>
__global__ void __launch_bounds__(kLanes)
rglru_scan_kernel(const T* __restrict__ x, const T* __restrict__ a,
                  T* __restrict__ h, float* __restrict__ h_final, int t_len,
                  int d) {
  constexpr int kPer = kSlab<T> / kLanes;   // channels a lane
  extern __shared__ __align__(16) unsigned char smem[];
  // x's ring, then a's: [kStages][kSteps][kSlab] each
  T* xs = reinterpret_cast<T*>(smem);
  T* as = xs + kStages * kSteps * kSlab<T>;
  const int lane = threadIdx.x;
  const int c0 = blockIdx.x * kSlab<T>;
  const size_t row0 = static_cast<size_t>(blockIdx.y) * t_len;
  const int n_tiles = (t_len + kSteps - 1) / kSteps;

  auto stage = [&](int tile) {
    if (tile >= n_tiles) return;
    const int t0 = tile * kSteps;
    const int n = min(kSteps, t_len - t0);
    T* xd = xs + (tile % kStages) * kSteps * kSlab<T>;
    T* ad = as + (tile % kStages) * kSteps * kSlab<T>;
    if constexpr (kAsync) {
      // D is a multiple of a piece, so a piece is wholly in D or past it
      constexpr int kPieces = kSlabBytes / 16, kPiece = 16 / sizeof(T);
      for (int i = lane; i < n * kPieces; i += kLanes) {
        const int e = (i % kPieces) * kPiece;
        const bool ok = c0 + e < d;
        const size_t src = (row0 + t0 + i / kPieces) * d + (ok ? c0 + e : 0);
        cp_async16(smem_addr(xd + i * kPiece), x + src, ok);
        cp_async16(smem_addr(ad + i * kPiece), a + src, ok);
      }
    } else {
#pragma unroll 4
      for (int i = lane; i < n * kSlab<T>; i += kLanes) {
        const int e = i % kSlab<T>;
        if (c0 + e < d) {
          const size_t src = (row0 + t0 + i / kSlab<T>) * d + c0 + e;
          xd[i] = x[src];
          ad[i] = a[src];
        }
      }
    }
  };

  float state[kPer];
#pragma unroll
  for (int m = 0; m < kPer; ++m) state[m] = 0.f;
  const int e0 = lane * kPer;   // this lane's first channel in the slab
  for (int tile = 0; tile < kStages - 1; ++tile) {
    stage(tile);
    cp_async_commit();
  }
  for (int tile = 0; tile < n_tiles; ++tile) {
    __syncwarp();   // every lane is done with the slot about to be refilled
    stage(tile + kStages - 1);
    cp_async_commit();   // possibly empty: one group a tile, always
    cp_async_wait<kStages - 1>();
    __syncwarp();   // the tile is in, from every lane's copies
    const int t0 = tile * kSteps;
    const int n = min(kSteps, t_len - t0);
    // the whole tile into registers first (a short last tile reads stale
    // rows of its slot, never used), so the chain waits on no load
    const T* xt = xs + (tile % kStages) * kSteps * kSlab<T> + e0;
    const T* at = as + (tile % kStages) * kSteps * kSlab<T> + e0;
    float xr[kSteps][kPer], ar[kSteps][kPer];
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
#pragma unroll
      for (int m = 0; m < kPer; ++m) {
        xr[s][m] = to_f32(xt[s * kSlab<T> + m]);
        ar[s][m] = to_f32(at[s * kSlab<T> + m]);
      }
    }
    // h of the tile is gathered in x's slot (its values are in registers
    // now), then stored as whole rows, 16 bytes a lane
    T* hs = xs + (tile % kStages) * kSteps * kSlab<T>;
    __syncwarp();
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      if (s < n) {
#pragma unroll
        for (int m = 0; m < kPer; ++m) {
          state[m] = __fadd_rn(__fmul_rn(ar[s][m], state[m]), xr[s][m]);
          hs[s * kSlab<T> + e0 + m] = from_f32<T>(state[m]);
        }
      }
    }
    __syncwarp();
    if constexpr (kAsync) {
      constexpr int kPieces = kSlabBytes / 16, kPiece = 16 / sizeof(T);
      for (int i = lane; i < n * kPieces; i += kLanes) {
        const int e = (i % kPieces) * kPiece;
        if (c0 + e < d)
          *reinterpret_cast<uint4*>(h + (row0 + t0 + i / kPieces) * d + c0 +
                                    e) =
              *reinterpret_cast<const uint4*>(hs + i * kPiece);
      }
    } else {
      for (int i = lane; i < n * kSlab<T>; i += kLanes) {
        const int e = i % kSlab<T>;
        if (c0 + e < d) h[(row0 + t0 + i / kSlab<T>) * d + c0 + e] = hs[i];
      }
    }
  }
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    if (c0 + e0 + m < d)
      h_final[static_cast<size_t>(blockIdx.y) * d + c0 + e0 + m] = state[m];
  }
}

template <typename T, bool kAsync>
int launch(const void* x, const void* a, void* h, float* h_final, int b,
           int t_len, int d, void* stream) {
  auto kernel = rglru_scan_kernel<T, kAsync>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((d + kSlab<T> - 1) / kSlab<T>, b);
  kernel<<<grid, kLanes, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(a), static_cast<T*>(h),
      h_final, t_len, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* a, void* h, float* h_final, int b,
             int t_len, int d, void* stream) {
  const bool aligned = (static_cast<size_t>(d) * sizeof(T)) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(h) % 16 == 0;
  return aligned ? launch<T, true>(x, a, h, h_final, b, t_len, d, stream)
                 : launch<T, false>(x, a, h, h_final, b, t_len, d, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x, a, h [B, T, D] contiguous in one
// dtype; h_final [B, D] float32, the state after the last step.
extern "C" int rglru_scan(int dtype, const void* x, const void* a, void* h,
                          float* h_final, int b, int t_len, int d,
                          void* stream) {
  if (b <= 0 || b > 65535 || t_len <= 0 || d <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) return dispatch<float>(x, a, h, h_final, b, t_len, d, stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, a, h, h_final, b, t_len, d, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
