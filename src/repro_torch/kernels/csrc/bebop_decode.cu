// Bebop page decode on the device: one pass over an [N, stride] u8 page
// emits every column of a static decode plan.
//
// Replaces: src/repro/kernels/bebop_decode.py:110 decode_columns (Pallas
// body _multi_kernel, :103) and :69 decode_column (_column_kernel, :62),
// which is the same decode for a one-field plan.
//
// Bound: bytes.  Each output element costs a handful of integer ops on
// 1-4 input bytes, far below the card's ~295 operations per byte, so the
// time floor is reading the page once and writing each column once.
//
// Design: one CTA of 256 threads per tile of whole rows (about 8 KB of the
// page), as the TPU kernel takes a [block_n, stride] block into VMEM.  The
// tile's rows are one contiguous byte range, so the CTA copies it into
// shared memory with 16-byte cp.async copies, consecutive threads on
// consecutive addresses; a start or end off a 16-byte boundary (a page
// that is a row slice of a larger one, a stride that is not a multiple of
// 16) gets a scalar head and tail.  After one barrier the threads decode
// each field of the plan from shared memory: element e of the tile's
// [rows, count] block is row e / count, element e % count, and each thread
// steps that pair by a fixed (256 / count, 256 % count) in 32-bit integers,
// so no element pays a division.  Consecutive threads write consecutive
// output elements: a field's outputs for the tile are one contiguous run.
// A row wider than kMaxStagedRow is decoded in place from device memory,
// one CTA a row, by the same loop.  Staging costs a shared-memory round
// trip and a barrier that a bitcast does not need: a one-field plan whose
// output is the page's own bytes (offset 0, count x width = stride, no
// conversion; the served prompt pages' token column) is a copy, done with
// 16-byte loads and stores.  The plan (offset, count, wire and out
// code per field) is built once per schema by the wrapper and passed by
// value with the output pointers; there is no per-field launch.  The
// conversions are integer arithmetic with fixed results (float16 ->
// float32 included, NaN payloads quieted the way the host converters do),
// so the output is bit-identical to the plain PyTorch version and to the
// JAX reference.
#include <cstdint>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace {

using sm90::cp_async16;
using sm90::smem_addr;

constexpr int kMaxFields = 32;
constexpr int kThreads = 256;
constexpr int kTileBytes = 8192;   // page bytes a CTA stages, whole rows
// rows up to this wide are staged (static shared memory limit, less the
// 16-byte lead); wider rows are read in place
constexpr int kMaxStagedRow = 48 * 1024 - 16;

// wire codes (kernels/bebop_decode.py WIRE_CODES)
enum Wire { W_U32 = 0, W_I32 = 1, W_F32 = 2, W_U16 = 3, W_BF16 = 4,
            W_F16 = 5, W_U8 = 6 };
// out codes (kernels/bebop_decode.py OUT_CODES)
enum Out { O_U8 = 0, O_U16 = 1, O_I32 = 2, O_U32 = 3, O_F32 = 4 };

// A decode plan as kernels/bebop_decode.py _PackedPlan lays it out.
struct Field {
  int offset;
  int count;
  int wire;
  int out;
};
struct Plan {
  int n_fields;
  Field f[kMaxFields];
};
struct Outs {
  void* p[kMaxFields];
};

__host__ __device__ __forceinline__ int wire_width(int wire) {
  return (wire <= W_F32) ? 4 : (wire <= W_F16 ? 2 : 1);
}

// The output is the wire's own bits: a bitcast, no conversion.
bool same_bits(int wire, int out) {
  return ((wire == W_U32 || wire == W_I32) && (out == O_U32 || out == O_I32)) ||
         wire == W_F32 || (wire == W_U16 && out == O_U16) ||
         (wire == W_U8 && out == O_U8);
}

// IEEE binary16 bits -> binary32 bits, exact; a NaN keeps its payload and
// gets the quiet bit.
__device__ __forceinline__ uint32_t f16_bits_to_f32_bits(uint32_t h) {
  const uint32_t sign = (h & 0x8000u) << 16;
  const uint32_t exp = (h >> 10) & 0x1Fu;
  const uint32_t mant = h & 0x3FFu;
  if (exp == 0x1Fu) {
    return sign | 0x7F800000u | (mant << 13) | (mant ? 0x00400000u : 0u);
  }
  if (exp == 0u) {
    // subnormal or zero: mant * 2^-24 is exact in binary32
    const float v = static_cast<float>(mant) * 5.9604644775390625e-8f;
    return sign | __float_as_uint(v);
  }
  return sign | ((exp + 112u) << 23) | (mant << 13);
}

// The w little-endian bytes at p (shared or device memory), one load when
// they are aligned.
__device__ __forceinline__ uint32_t load_le(const uint8_t* p, int w) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (w == 4 && (a & 3) == 0) return *reinterpret_cast<const uint32_t*>(p);
  if (w == 2 && (a & 1) == 0) return *reinterpret_cast<const uint16_t*>(p);
  uint32_t v = p[0];
  for (int k = 1; k < w; ++k) v |= static_cast<uint32_t>(p[k]) << (8 * k);
  return v;
}

__device__ __forceinline__ void store(void* base, int e, uint32_t v, int wire,
                                      int out) {
  if (wire == W_F32 || wire == W_BF16 || wire == W_F16) {
    uint32_t bits = v;
    if (wire == W_BF16) bits = v << 16;
    if (wire == W_F16) bits = f16_bits_to_f32_bits(v);
    static_cast<uint32_t*>(base)[e] = bits;  // out is float32
    return;
  }
  switch (out) {
    case O_U8: static_cast<uint8_t*>(base)[e] = static_cast<uint8_t>(v); break;
    case O_U16: static_cast<uint16_t*>(base)[e] = static_cast<uint16_t>(v); break;
    case O_I32: static_cast<int32_t*>(base)[e] = static_cast<int32_t>(v); break;
    case O_U32: static_cast<uint32_t*>(base)[e] = v; break;
    default: static_cast<float*>(base)[e] = __uint2float_rn(v); break;
  }
}

__device__ __forceinline__ int out_size(int wire, int out) {
  if (wire == W_F32 || wire == W_BF16 || wire == W_F16) return 4;
  return out == O_U8 ? 1 : (out == O_U16 ? 2 : 4);
}

// A field that is the page's own bytes, copied as 16-byte vectors through
// the read-only data path.
__global__ void __launch_bounds__(kThreads)
copy_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst,
            long long n_vec) {
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n_vec; i += step) {
    dst[i] = __ldg(src + i);
  }
}

__global__ void __launch_bounds__(kThreads)
decode_kernel(const uint8_t* __restrict__ pages, int n, int stride,
              int tile_rows, bool staged, Plan plan, Outs outs) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * tile_rows;
  const int rows = min(tile_rows, n - r0);
  const uint8_t* tile = pages + static_cast<size_t>(r0) * stride;
  const uint8_t* src = tile;
  // read the first field's descriptor now: the wait and the barrier below
  // order memory, so a read after them would wait for the tile first
  const int n_fields = plan.n_fields;
  Field fd = plan.f[0];
  void* out = outs.p[0];
  if (staged) {
    // smem byte lead + t holds tile byte t: both sit at the same offset
    // mod 16, so every aligned 16-byte piece of the tile is one cp.async
    const int bytes = rows * stride;
    const int lead = static_cast<int>(reinterpret_cast<uintptr_t>(tile) & 15);
    uint8_t* dst = smem + lead;
    const int head = min(bytes, (16 - lead) & 15);
    const int n_vec = (bytes - head) >> 4;
    const int tail = head + (n_vec << 4);
    for (int i = tid; i < n_vec; i += kThreads) {
      cp_async16(smem_addr(dst + head + 16 * i), tile + head + 16 * i, true);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    if (tid < head) dst[tid] = tile[tid];
    if (tail + tid < bytes) dst[tail + tid] = tile[tail + tid];
    __syncthreads();
    src = dst;
  }
  for (int fi = 0;;) {
    const int w = wire_width(fd.wire);
    const int cnt = fd.count;
    const int total = rows * cnt;   // < 2^31: a tile's bytes, or one row
    uint8_t* base = static_cast<uint8_t*>(out) +
                    static_cast<size_t>(r0) * cnt * out_size(fd.wire, fd.out);
    // element e = r * cnt + j; every step adds kThreads to e
    const int dr = kThreads / cnt, dj = kThreads - dr * cnt;
    int r = tid / cnt, j = tid - r * cnt;
    for (int e = tid; e < total; e += kThreads) {
      store(base, e, load_le(src + r * stride + fd.offset + j * w, w),
            fd.wire, fd.out);
      j += dj;
      r += dr;
      if (j >= cnt) {
        j -= cnt;
        ++r;
      }
    }
    if (++fi == n_fields) break;
    fd = plan.f[fi];
    out = outs.p[fi];
  }
}

}  // namespace

// plan: a Plan (the fields to decode, count > 0 each); outs[i]: field i's
// [n, count] output.  pages: [n, stride] u8, contiguous, any alignment.
extern "C" int bebop_decode_columns(const void* plan, const void* pages,
                                    long long n, long long stride,
                                    void* const* outs, void* stream) {
  const Plan& p = *static_cast<const Plan*>(plan);
  if (p.n_fields < 1 || p.n_fields > kMaxFields || n <= 0 || n > INT32_MAX ||
      stride <= 0 || stride > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Field& f0 = p.f[0];
  const long long bytes = n * stride;
  if (p.n_fields == 1 && f0.offset == 0 &&
      f0.count * wire_width(f0.wire) == stride && same_bits(f0.wire, f0.out) &&
      bytes % 16 == 0 && reinterpret_cast<uintptr_t>(pages) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(outs[0]) % 16 == 0) {
    const long long n_vec = bytes / 16;
    long long blocks = (n_vec + kThreads - 1) / kThreads;
    if (blocks > 132 * 16) blocks = 132 * 16;   // grid-stride beyond
    copy_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        static_cast<const uint4*>(pages), static_cast<uint4*>(outs[0]),
        n_vec);
    return static_cast<int>(cudaGetLastError());
  }
  Outs o;
  for (int i = 0; i < p.n_fields; ++i) o.p[i] = outs[i];
  const bool staged = stride <= kMaxStagedRow;
  const int tile_rows =
      (staged && stride < kTileBytes) ? static_cast<int>(kTileBytes / stride)
                                      : 1;
  const long long blocks = (n + tile_rows - 1) / tile_rows;
  const size_t smem = staged ? tile_rows * stride + 16 : 0;
  decode_kernel<<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(
      static_cast<const uint8_t*>(pages), static_cast<int>(n),
      static_cast<int>(stride), tile_rows, staged, p, o);
  return static_cast<int>(cudaGetLastError());
}
