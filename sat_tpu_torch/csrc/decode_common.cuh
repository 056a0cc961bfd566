// Device helpers shared by the CUDA sources: loads and conversions between
// float32 and bfloat16, warp reductions, and the matrix-vector product gemv
// of one row (the loop's select phase).  Accumulation is float; values are
// rounded to the input type where the JAX kernels cast them
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

__host__ __device__ inline int pad4(int n) { return (n + 3) & ~3; }

template <typename T> struct Pack;
template <> struct Pack<float> { static constexpr int N = 4; };
template <> struct Pack<__nv_bfloat16> { static constexpr int N = 8; };

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

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
// x rounded to T's precision, as float
template <typename T> __device__ __forceinline__ float rnd(float x) { return to_f(from_f<T>(x)); }

// V consecutive elements of T as one raw load (16 bytes for V > 1), and
// their conversion to float.  Loading raw first lets a thread keep U loads in
// flight while holding 4 registers per load.
template <typename T, int V> struct Vec;
template <> struct Vec<float, 1> {
  using raw = float;
  __device__ __forceinline__ static raw load(const float* p) { return __ldg(p); }
  __device__ __forceinline__ static void unpack(raw w, float (&o)[1]) { o[0] = w; }
};
template <> struct Vec<__nv_bfloat16, 1> {
  using raw = unsigned short;
  __device__ __forceinline__ static raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  __device__ __forceinline__ static void unpack(raw w, float (&o)[1]) { o[0] = bf16_lo(w); }
};
template <> struct Vec<float, 4> {
  using raw = float4;
  __device__ __forceinline__ static raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ __forceinline__ static void unpack(raw w, float (&o)[4]) {
    o[0] = w.x; o[1] = w.y; o[2] = w.z; o[3] = w.w;
  }
};
template <> struct Vec<__nv_bfloat16, 8> {
  using raw = uint4;
  __device__ __forceinline__ static raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ static void unpack(raw w, float (&o)[8]) {
    o[0] = bf16_lo(w.x); o[1] = bf16_hi(w.x); o[2] = bf16_lo(w.y); o[3] = bf16_hi(w.y);
    o[4] = bf16_lo(w.z); o[5] = bf16_hi(w.z); o[6] = bf16_lo(w.w); o[7] = bf16_hi(w.w);
  }
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

// acc[v] += sum_{k in [k0, k1)} x[k] * W[k*ncols + col + v]
template <int V, typename T>
__device__ __forceinline__ void dot_cols(float (&acc)[V], const float* x,
                                         const T* __restrict__ W, int ncols, int col,
                                         int k0, int k1) {
  constexpr int U = 16;  // loads in flight per thread
  const T* wp = W + col;
  int k = k0;
  for (; k + U <= k1; k += U) {
    typename Vec<T, V>::raw w[U];
#pragma unroll
    for (int u = 0; u < U; ++u) w[u] = Vec<T, V>::load(wp + (size_t)(k + u) * ncols);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float f[V];
      Vec<T, V>::unpack(w[u], f);
      const float xv = x[k + u];
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = fmaf(xv, f[v], acc[v]);
    }
  }
  for (; k < k1; ++k) {
    float f[V];
    Vec<T, V>::unpack(Vec<T, V>::load(wp + (size_t)k * ncols), f);
    const float xv = x[k];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = fmaf(xv, f[v], acc[v]);
  }
}

// out[j] = (accumulate ? out[j] : 0) + sum_k x[k] * W[k*ncols + j] for
// j < ncols.  x and out are shared memory, W (K, ncols) row-major global
// memory; scratch holds NT * V floats for K-split partial sums.  The caller
// synchronises before (x ready) and after (out ready).
template <int V, typename T>
__device__ void gemv_v(const float* x, const T* __restrict__ W, int K, int ncols, float* out,
                       bool accumulate, float* scratch) {
  const int G = ncols / V;
  const int tid = threadIdx.x;
  const int ks = G >= NT ? 1 : NT / G;
  if (ks == 1) {
    for (int g = tid; g < G; g += NT) {
      float acc[V];
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = 0.f;
      dot_cols<V, T>(acc, x, W, ncols, g * V, 0, K);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float* o = out + g * V + v;
        *o = (accumulate ? *o : 0.f) + acc[v];
      }
    }
    return;
  }
  const int g = tid % G, kp = tid / G;
  const int kc = (K + ks - 1) / ks;
  if (kp < ks) {
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.f;
    const int k0 = min(K, kp * kc), k1 = min(K, k0 + kc);
    dot_cols<V, T>(acc, x, W, ncols, g * V, k0, k1);
#pragma unroll
    for (int v = 0; v < V; ++v) scratch[kp * ncols + g * V + v] = acc[v];
  }
  __syncthreads();
  for (int j = tid; j < ncols; j += NT) {
    float s = 0.f;
    for (int p = 0; p < ks; ++p) s += scratch[p * ncols + j];
    out[j] = (accumulate ? out[j] : 0.f) + s;
  }
}

template <typename T>
__device__ __forceinline__ void gemv(const float* x, const T* __restrict__ W, int K, int ncols,
                                     float* out, bool accumulate, float* scratch) {
  constexpr int V = Pack<T>::N;
  if (ncols % V == 0 && (reinterpret_cast<uintptr_t>(W) & 15) == 0)
    gemv_v<V, T>(x, W, K, ncols, out, accumulate, scratch);
  else
    gemv_v<1, T>(x, W, K, ncols, out, accumulate, scratch);
}

}  // namespace sat

extern "C" const char* sat_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
