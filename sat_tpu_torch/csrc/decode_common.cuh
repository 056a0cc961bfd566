// Device helpers shared by the CUDA sources: loads and conversions between
// float32 and bfloat16, and warp reductions.  Accumulation is float; values
// are rounded to the input type where the JAX kernels cast them
// (sat_tpu/kernels/decoder_step.py::_kernel).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace sat {

constexpr int NT = 256;  // threads per block
constexpr int NWARPS = NT / 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }

__device__ __forceinline__ float ldf(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldf(const __nv_bfloat16* p) {
  return bf16_lo((uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p)));
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

}  // namespace sat

extern "C" const char* sat_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
