// RG-LRU recurrence (RecurrentGemma): h_t = a_t * h_{t-1} + x_t, h_{-1} = 0.
//
// Replaces: src/repro/kernels/rglru_scan.py:51 rglru_scan (Pallas body
// _rglru_kernel, :27).
//
// Bound: bytes.  Each element of x and a is read once and each h written
// once for one multiply and one add: far below the card's operations per
// byte, so the least time is the bytes over the memory rate.
//
// Design: one thread per (batch row, channel), walking T.  The TPU kernel
// carries a [1, D] state across sequential grid steps; here nothing
// carries between blocks, so each thread holds its channel's fp32 state in
// a register for the whole sequence.  Neighbouring threads own neighbouring
// channels, so every step's loads and stores coalesce across the warp.  The
// loads of a step do not depend on the state, so the unrolled loop keeps
// several steps' loads in flight while the dependent multiply-adds run.
// The step is a rounded multiply then a rounded add (__fmul_rn,
// __fadd_rn, never contracted to an FMA), the same two roundings as the
// plain PyTorch version, so the two agree bit for bit in float32.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

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
__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const T* __restrict__ x, const T* __restrict__ a,
                  T* __restrict__ h, float* __restrict__ h_final, int t_len,
                  int d) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (c >= d) return;
  size_t i = static_cast<size_t>(b) * t_len * d + c;
  float state = 0.f;
#pragma unroll 8
  for (int t = 0; t < t_len; ++t, i += d) {
    const float xt = to_f32(__ldg(x + i));
    const float at = to_f32(__ldg(a + i));
    state = __fadd_rn(__fmul_rn(at, state), xt);
    h[i] = from_f32<T>(state);
  }
  h_final[static_cast<size_t>(b) * d + c] = state;
}

template <typename T>
int launch(const void* x, const void* a, void* h, float* h_final, int b,
           int t_len, int d, void* stream) {
  const dim3 grid((d + kThreads - 1) / kThreads, b);
  rglru_scan_kernel<T><<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(a), static_cast<T*>(h),
      h_final, t_len, d);
  return static_cast<int>(cudaGetLastError());
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
  if (dtype == 0) return launch<float>(x, a, h, h_final, b, t_len, d, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, a, h, h_final, b, t_len, d, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
