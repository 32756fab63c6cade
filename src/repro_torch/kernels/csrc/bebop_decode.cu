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
// Design: the plan (offset, count, wire code, out code, out pointer per
// field) travels by value in the kernel's parameter space; there is no
// per-field launch.  Threads walk a grid-stride loop over the (row,
// element) pairs of each field and compose the element's bytes
// little-endian from byte loads, so every byte of every column is read
// exactly once whatever the field's alignment, and the ragged edge is a
// bounds test on the pair index: N need not be padded to any tile.  The
// conversions are integer arithmetic with fixed results (float16 -> float32
// included, NaN payloads quieted the way the host converters do), so the
// output is bit-identical to the plain PyTorch version and to the JAX
// reference.  Byte loads leave bandwidth on the table; wide vector loads
// are later work.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxFields = 32;

// wire codes (kernels/bebop_decode.py WIRE_CODES)
enum Wire { W_U32 = 0, W_I32 = 1, W_F32 = 2, W_U16 = 3, W_BF16 = 4,
            W_F16 = 5, W_U8 = 6 };
// out codes (kernels/bebop_decode.py OUT_CODES)
enum Out { O_U8 = 0, O_U16 = 1, O_I32 = 2, O_U32 = 3, O_F32 = 4 };

struct Field {
  long long offset;
  long long count;
  int wire;
  int out;
  void* ptr;
};

struct Plan {
  int n_fields;
  Field f[kMaxFields];
};

__device__ __forceinline__ int wire_width(int wire) {
  return (wire <= W_F32) ? 4 : (wire <= W_F16 ? 2 : 1);
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

__global__ void decode_columns_kernel(const uint8_t* __restrict__ pages,
                                      long long n, long long stride,
                                      Plan plan) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (int fi = 0; fi < plan.n_fields; ++fi) {
    const Field fd = plan.f[fi];
    const int w = wire_width(fd.wire);
    const long long total = n * fd.count;
    for (long long i = first; i < total; i += step) {
      const long long r = i / fd.count;
      const long long j = i - r * fd.count;
      const uint8_t* p = pages + r * stride + fd.offset + j * w;
      uint32_t v = p[0];
      for (int k = 1; k < w; ++k) v |= static_cast<uint32_t>(p[k]) << (8 * k);
      if (fd.wire == W_F32 || fd.wire == W_BF16 || fd.wire == W_F16) {
        uint32_t bits = v;
        if (fd.wire == W_BF16) bits = v << 16;
        if (fd.wire == W_F16) bits = f16_bits_to_f32_bits(v);
        static_cast<uint32_t*>(fd.ptr)[i] = bits;  // out is float32
        continue;
      }
      switch (fd.out) {
        case O_U8: static_cast<uint8_t*>(fd.ptr)[i] = static_cast<uint8_t>(v); break;
        case O_U16: static_cast<uint16_t*>(fd.ptr)[i] = static_cast<uint16_t>(v); break;
        case O_I32: static_cast<int32_t*>(fd.ptr)[i] = static_cast<int32_t>(v); break;
        case O_U32: static_cast<uint32_t*>(fd.ptr)[i] = v; break;
        default: static_cast<float*>(fd.ptr)[i] = __uint2float_rn(v); break;
      }
    }
  }
}

}  // namespace

extern "C" int bebop_decode_columns(const void* pages, long long n,
                                    long long stride, int n_fields,
                                    const long long* offsets,
                                    const long long* counts,
                                    const int* wires, const int* outs,
                                    void* const* out_ptrs, void* stream) {
  if (n_fields < 1 || n_fields > kMaxFields || n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Plan plan;
  plan.n_fields = n_fields;
  long long widest = 0;
  for (int i = 0; i < n_fields; ++i) {
    plan.f[i].offset = offsets[i];
    plan.f[i].count = counts[i];
    plan.f[i].wire = wires[i];
    plan.f[i].out = outs[i];
    plan.f[i].ptr = out_ptrs[i];
    if (counts[i] > widest) widest = counts[i];
  }
  const int threads = 256;
  long long blocks = (n * widest + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond 16 per SM
  if (blocks < 1) blocks = 1;
  decode_columns_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(pages), n, stride, plan);
  return static_cast<int>(cudaGetLastError());
}
