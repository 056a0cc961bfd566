// Device code of the step kernel (decoder_step.cu): the shared-memory layout
// of a row and one decode step (attention, beta gate, LSTM cell, deep-output
// pre-projection) for it.  The loop kernels (greedy_loop.cu) use only its
// helpers: loads and conversions, warp reductions and gemv.
//
// Design.  One block of NT threads owns one row.  The row's state (h, c, the
// embedding, the context, the gates) lives in shared memory as float for the
// whole step.  Weights are read from global memory, where the n64 set (18 MB
// in f32) stays in the 50 MB L2.  Matrix-vector products give each thread VEC
// adjacent output columns (16-byte loads: 4 floats or 8 bf16) and split K
// across thread groups when a matrix has too few columns to occupy the block.
// Each thread keeps 16 loads in flight (64 registers of data in f32), so the
// step kernel is declared __launch_bounds__(NT, 1): one block per SM is
// enough, which frees ptxas to use 108-160 registers.  With
// __launch_bounds__(NT) alone it chose an occupancy target of 40-64
// registers, spilled, and ran about 4x slower (measured at n64 on an H100,
// PERF.md).  Accumulation, softmax
// and LSTM state are float; values are rounded to the input type where the
// JAX kernel casts them (sat_tpu/kernels/decoder_step.py::_kernel).
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

// Floats of dynamic shared memory for one row; V = 0 for the step kernel.
// Mirrored by smem_bytes() in sat_tpu_torch/kernels/decoder_step.py.
__host__ __device__ inline size_t smem_floats(int L, int D, int A, int H, int E, int V,
                                              int vec) {
  return (size_t)2 * pad4(H) + 2 * pad4(E) + pad4(A) + pad4(L) + 2 * pad4(D) +
         pad4(4 * H) + pad4(V) + (size_t)NT * vec;
}

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

template <typename T> struct StepArgs {
  const T* annot;    // (N, L, D)
  const T* att_enc;  // (N, L, A)
  const T *wd, *wf, *wb, *bb, *wie, *wiz, *whh, *bias, *wh, *wc;
  int L, D, A, H, E;
  int deep;
  float inv_sqrt_l;
};

struct Tile {
  float *h, *c, *e, *att, *alpha, *z, *xz, *gates, *tp, *logits, *scratch;
};

// Each array starts on a 16-byte boundary (pad4 floats).
__device__ inline Tile carve(float* base, int L, int D, int A, int H, int E, int V) {
  Tile s;
  float* p = base;
  s.h = p; p += pad4(H);
  s.c = p; p += pad4(H);
  s.e = p; p += pad4(E);
  s.tp = p; p += pad4(E);
  s.att = p; p += pad4(A);
  s.alpha = p; p += pad4(L);
  s.z = p; p += pad4(D);
  s.xz = p; p += pad4(D);
  s.gates = p; p += pad4(4 * H);
  s.logits = p; p += pad4(V);
  s.scratch = p;
  return s;
}

// One decode step for row `row`.  On entry s.h (h rounded to T), s.c (float)
// and s.e (the token embedding) hold the state and the block is
// synchronised.  On exit s.h/s.c hold h', c', s.z the context, s.alpha the
// attention weights and s.tp the deep-output pre-projection t, all float, and
// the block is synchronised.
template <typename T>
__device__ void step_body(const StepArgs<T>& a, const Tile& s, int row) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int L = a.L, D = a.D, A = a.A, H = a.H, E = a.E;

  // (1) att_dec = h Wd
  gemv<T>(s.h, a.wd, H, A, s.att, false, s.scratch);
  __syncthreads();
  // (2) attention logits: sum_a tanh(att_enc + att_dec) wf, scaled by 1/sqrt(L)
  for (int l = warp; l < L; l += NWARPS) {
    const T* ae = a.att_enc + ((size_t)row * L + l) * A;
    float acc = 0.f;
    for (int j = lane; j < A; j += 32) acc += tanhf(ldf(ae + j) + s.att[j]) * ldf(a.wf + j);
    acc = warp_sum(acc);
    if (lane == 0) s.alpha[l] = acc * a.inv_sqrt_l;
  }
  __syncthreads();
  // (3) softmax over L, one warp
  if (warp == 0) {
    float m = -INFINITY;
    for (int l = lane; l < L; l += 32) m = fmaxf(m, s.alpha[l]);
    m = warp_max(m);
    float sum = 0.f;
    for (int l = lane; l < L; l += 32) {
      const float ev = expf(s.alpha[l] - m);
      s.alpha[l] = ev;
      sum += ev;
    }
    sum = warp_sum(sum);
    for (int l = lane; l < L; l += 32) s.alpha[l] = s.alpha[l] / sum;
  }
  __syncthreads();
  // (4) context z = sum_l alpha_l annot_l, and (5) the beta GEMV h Wb
  const T* an = a.annot + (size_t)row * L * D;
  for (int d = tid; d < D; d += NT) {
    float acc = 0.f;
    for (int l = 0; l < L; ++l) acc = fmaf(s.alpha[l], ldf(an + (size_t)l * D + d), acc);
    s.z[d] = acc;
  }
  gemv<T>(s.h, a.wb, H, D, s.xz, false, s.scratch);
  __syncthreads();
  for (int d = tid; d < D; d += NT) {
    const float beta = sigmoidf(s.xz[d] + ldf(a.bb + d));
    s.xz[d] = rnd<T>(beta * s.z[d]);
  }
  __syncthreads();
  // (6) gates = e Wie + (beta z) Wiz + h Whh (+ bias below), order i, f, g, o
  gemv<T>(s.e, a.wie, E, 4 * H, s.gates, false, s.scratch);
  __syncthreads();
  gemv<T>(s.xz, a.wiz, D, 4 * H, s.gates, true, s.scratch);
  __syncthreads();
  gemv<T>(s.h, a.whh, H, 4 * H, s.gates, true, s.scratch);
  __syncthreads();
  // (7) LSTM cell; z rounded to T for the deep-output GEMV
  for (int j = tid; j < H; j += NT) {
    const float* g = s.gates;
    const float ig = sigmoidf(g[j] + ldf(a.bias + j));
    const float fg = sigmoidf(g[H + j] + ldf(a.bias + H + j));
    const float gg = tanhf(g[2 * H + j] + ldf(a.bias + 2 * H + j));
    const float og = sigmoidf(g[3 * H + j] + ldf(a.bias + 3 * H + j));
    const float cn = fg * s.c[j] + ig * gg;
    s.c[j] = cn;
    s.h[j] = rnd<T>(og * tanhf(cn));
  }
  for (int d = tid; d < D; d += NT) s.xz[d] = rnd<T>(s.z[d]);
  __syncthreads();
  // (8) t = tanh(e + h' Wh + z Wc), or h' Wh without deep output
  gemv<T>(s.h, a.wh, H, E, s.tp, false, s.scratch);
  __syncthreads();
  if (a.deep) {
    for (int j = tid; j < E; j += NT) s.tp[j] += s.e[j];
    __syncthreads();
    gemv<T>(s.xz, a.wc, D, E, s.tp, true, s.scratch);
    __syncthreads();
    for (int j = tid; j < E; j += NT) s.tp[j] = tanhf(s.tp[j]);
    __syncthreads();
  }
}

template <typename T>
inline StepArgs<T> step_args(const void* annot, const void* att_enc, const void* const* w,
                             int L, int D, int A, int H, int E, int deep) {
  StepArgs<T> a;
  a.annot = static_cast<const T*>(annot);
  a.att_enc = static_cast<const T*>(att_enc);
  a.wd = static_cast<const T*>(w[0]);
  a.wf = static_cast<const T*>(w[1]);
  a.wb = static_cast<const T*>(w[2]);
  a.bb = static_cast<const T*>(w[3]);
  a.wie = static_cast<const T*>(w[4]);
  a.wiz = static_cast<const T*>(w[5]);
  a.whh = static_cast<const T*>(w[6]);
  a.bias = static_cast<const T*>(w[7]);
  a.wh = static_cast<const T*>(w[8]);
  a.wc = static_cast<const T*>(w[9]);
  a.L = L; a.D = D; a.A = A; a.H = H; a.E = E;
  a.deep = deep;
  a.inv_sqrt_l = (float)pow((double)L, -0.5);  // as Python's float(L) ** -0.5
  return a;
}

}  // namespace sat

extern "C" const char* sat_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
