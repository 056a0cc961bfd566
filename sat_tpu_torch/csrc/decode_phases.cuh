// One decode step for a whole batch as four phases, the device code shared
// by the greedy loop (greedy_loop.cu) and the fused step (decoder_step.cu).
// Each source launches the phases through __global__ wrappers of its own, in
// order on one stream; the kernel boundaries are the grid-wide barriers:
//   1. hside    g1 = h [Wd | Wb | Whh]                       (K = H)
//   2. attend   scores, softmax, z, beta z, z (one row, a D slice)
//   3. gates    [e | beta z] [Wie; Wiz] + g_h + bias, LSTM cell
//   4. deepout  partial sums of [h' | z] [Wh; Wc], split over K
// The caller sums phase 4's K slices in slice order and applies the deep
// output's tanh (the loop in greedy_loop_tproj, the step in decoder_step_out).
//
// What bounds it on an H100.  At B = 64 a step's products are a (64 x K) by
// (K x N) matrix product per weight matrix: 4.6 M weights (18.6 MB in f32)
// for 64 x 4.6 M multiply-adds.  Reading the weights once per row makes the
// step bound by one SM's L2 bandwidth; read once per step for all rows, the
// weights take a few microseconds of L2 bandwidth and the step is bound by
// f32 FMAs.
//
// Design.  Phases 1, 3 and 4 are tiled products: a block covers up to 64
// rows (BM) by BN columns, so each weight is read once per step per tile of
// 64 rows.  The activations are kept feature-major (K, Bp), so both the
// weight tile and the row tile arrive in shared memory as 16-byte cp.async
// copies (two stages), and every thread accumulates a 4 x 4 register tile
// in f32 FMAs.  The threads of a block are split into KG groups over the K
// rows of each stage (enough warps to keep the FMA pipes busy); the groups'
// tiles are summed in a fixed order, and phase 4's K slices are summed in a
// fixed order by the caller, so a run is deterministic.  The column layouts
// of the packed weights (gate columns interleaved as 4u + q) are fixed by
// kernels/decoder_step.py::pack_loop_weights.  Values are rounded to T where
// step_math rounds them (h', beta z, z for Wc).  The bodies read no state of
// the loop (finished rows, the count of them): the loop's wrappers return
// before calling them where that state says so.
#pragma once

#include "decode_common.cuh"

namespace sat {

constexpr int BM = 64;          // rows per tile
constexpr int BK = 128;         // K rows per shared-memory stage
constexpr int ATT_SLICE = 256;  // D columns (and threads) per attend block
constexpr int P1_BN = 32, P1_KG = 2;  // hside: columns per block, K groups
constexpr int P3_BN = 16, P3_KG = 4;  // gates: 4 hidden units x 4 gates
constexpr int P4_BN = 32, P4_KG = 2;  // deepout
// The product kernels are declared __launch_bounds__(NT, 2): up to 128
// registers a thread.  With (NT) alone ptxas held the gates kernel <float>
// to 64 registers and spilled.

// The bodies take the kernel's argument struct by value (LoopArgs in
// greedy_loop.cu, StepArgs in decoder_step.cu) and read these of its fields:
//   annot (B, L, D), att_enc (B, L, A)          T*
//   w1 (H, N1)     [Wd | Wb | Whh (gates interleaved) | 0]      T*
//   wx (E + D, G)  [Wie; Wiz], gates interleaved                T*
//   wo (H + D, Ep) [Wh; Wc]                                     T*
//   wf (A,), bb (D,), bias (G,) interleaved     float*
//   xt (E + D, Bp) [e; beta z], yt (H + D, Bp) [h; z]  T*, feature-major
//   g1 (B, N1) phase-1 output, part (splits, B, Ep) phase-4 partial sums  float*
//   B, Bp, L, D, A, H, E; N1, G, Ep (padded widths of w1, wx, wo);
//   K4, kc, splits (phase 4: K, K rows per split, splits); deep  int
//   inv_sqrt_l  float
// Each source lays its struct out for its own kernels.  Grouping these
// fields into one nested struct shared by both made the loop's select
// kernel, which uses few of them, a third slower on an H100: ptxas kept
// fewer of its loads in flight (PERF.md).

// -- tiled product ---------------------------------------------------------------

template <typename T> struct Store { using type = float; };
template <> struct Store<__nv_bfloat16> { using type = unsigned short; };

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  // src-size 0 fills the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ld4(float (&o)[4], const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void ld4(float (&o)[4], const unsigned short* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  o[0] = bf16_lo(v.x); o[1] = bf16_hi(v.x); o[2] = bf16_lo(v.y); o[3] = bf16_hi(v.y);
}

// Dynamic shared memory of one tile: two stages of the row tile (k-major)
// and of the weight tile; once the products are done, each K group's f32
// sums take the place of the stages (red()).
template <typename T, int BN, int KG> struct Tiles {
  static constexpr int TX = BN / 4, TY = BM / 4;  // 4 x 4 register tiles
  static constexpr int NTH = TX * TY * KG;        // threads
  static constexpr int KPG = BK / KG;             // K rows per group and stage
  static constexpr int VE = 16 / (int)sizeof(T);  // elements per 16-byte copy
  typename Store<T>::type a[2][BK][BM];
  typename Store<T>::type w[2][BK][BN];
  __device__ float (*red())[BM][BN] { return reinterpret_cast<float(*)[BM][BN]>(a); }
  __device__ const float (*red() const)[BM][BN] {
    return reinterpret_cast<const float(*)[BM][BN]>(a);
  }
  static_assert(NTH == NT, "a tile takes one block of NT threads");
  static_assert(sizeof(float) * KG * BM * BN <= sizeof(a), "the sums fit the stages");
};

template <typename T, int BN, int KG>
__device__ __forceinline__ Tiles<T, BN, KG>& tiles() {
  extern __shared__ float4 smem_raw[];
  return *reinterpret_cast<Tiles<T, BN, KG>*>(smem_raw);
}

template <typename T, int BN, int KG>
__device__ __forceinline__ void stage_load(Tiles<T, BN, KG>& s, int st, const T* at, int lda,
                                           const T* w, int ldw, int m0, int n0, int kb,
                                           int k1) {
  using TL = Tiles<T, BN, KG>;
  constexpr int AC = BM / TL::VE, WC = BN / TL::VE;
  for (int i = threadIdx.x; i < BK * AC; i += TL::NTH) {
    const int kr = i / AC, mc = (i % AC) * TL::VE, k = kb + kr, m = m0 + mc;
    const bool ok = k < k1 && m < lda;
    cp_async16(&s.a[st][kr][mc], ok ? at + (size_t)k * lda + m : at, ok);
  }
  for (int i = threadIdx.x; i < BK * WC; i += TL::NTH) {
    const int kr = i / WC, nc = (i % WC) * TL::VE, k = kb + kr, n = n0 + nc;
    const bool ok = k < k1 && n < ldw;
    cp_async16(&s.w[st][kr][nc], ok ? w + (size_t)k * ldw + n : w, ok);
  }
  cp_async_commit();
}

// s.red()[g][m][n] = sum over the K rows k in [k0, k1) that group g takes of
// at[k][m0 + m] * w[k][n0 + n].  at is (K, lda) feature-major and w (K, ldw)
// row-major, with lda and ldw multiples of 8 elements and 16-byte aligned
// rows, so a 16-byte copy never straddles the edge: copies past k1, lda or
// ldw are zero-filled.  Returns with the block synchronised.
template <typename T, int BN, int KG>
__device__ __forceinline__ void gemm_tile(Tiles<T, BN, KG>& s, const T* __restrict__ at,
                                          int lda, const T* __restrict__ w, int ldw, int m0,
                                          int n0, int k0, int k1) {
  using TL = Tiles<T, BN, KG>;
  const int tid = threadIdx.x;
  const int g = tid / (TL::TX * TL::TY), r = tid % (TL::TX * TL::TY);
  const int tx = r % TL::TX, ty = r / TL::TX;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const int nk = k1 > k0 ? (k1 - k0 + BK - 1) / BK : 0;
  if (nk > 0) stage_load(s, 0, at, lda, w, ldw, m0, n0, k0, k1);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      stage_load(s, (kt + 1) & 1, at, lda, w, ldw, m0, n0, k0 + (kt + 1) * BK, k1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int st = kt & 1;
#pragma unroll
    for (int q = 0; q < TL::KPG; ++q) {
      const int kk = g * TL::KPG + q;
      float av[4], wv[4];
      ld4(av, &s.a[st][kk][ty * 4]);
      ld4(wv, &s.w[st][kk][tx * 4]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
    }
    __syncthreads();  // the next stage_load (or red()) overwrites this stage
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(&s.red()[g][ty * 4 + i][tx * 4]) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  __syncthreads();
}

// The sum over the K groups, in group order, of the tile's columns n..n+3 of row m.
template <typename T, int BN, int KG>
__device__ __forceinline__ float4 tile_sum4(const Tiles<T, BN, KG>& s, int m, int n) {
  float4 v = *reinterpret_cast<const float4*>(&s.red()[0][m][n]);
#pragma unroll
  for (int g = 1; g < KG; ++g) {
    const float4 u = *reinterpret_cast<const float4*>(&s.red()[g][m][n]);
    v.x += u.x; v.y += u.y; v.z += u.z; v.w += u.w;
  }
  return v;
}

// Writes the tile's f32 sums to out (rows < B, columns < N, row stride N).
template <typename T, int BN, int KG>
__device__ __forceinline__ void tile_store(const Tiles<T, BN, KG>& s, float* out, int B, int N,
                                           int m0, int n0) {
  for (int i = threadIdx.x; i < BM * BN / 4; i += Tiles<T, BN, KG>::NTH) {
    const int m = i / (BN / 4), n = (i % (BN / 4)) * 4;
    if (m0 + m < B && n0 + n < N)
      *reinterpret_cast<float4*>(out + (size_t)(m0 + m) * N + n0 + n) = tile_sum4(s, m, n);
  }
}

// -- the four phases ---------------------------------------------------------------
// Grids: hside (N1 / P1_BN, row tiles), attend (B, D / ATT_SLICE), gates
// (G / P3_BN, row tiles), deepout (Ep / P4_BN, row tiles, splits); see plan4.

// 1. g1 = h [Wd | Wb | Whh]: att_dec, x_beta and the recurrent gate sums.
template <typename T, typename Args>
__device__ __forceinline__ void hside_body(const Args a) {
  auto& s = tiles<T, P1_BN, P1_KG>();
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * P1_BN;
  gemm_tile(s, a.yt, a.Bp, a.w1, a.N1, m0, n0, 0, a.H);
  tile_store(s, a.g1, a.B, a.N1, m0, n0);
}

// 2. One row and one slice of D: attention scores over L (recomputed by every
// slice), softmax, z = sum_l alpha_l annot_l, beta z and z rounded to T.
// z_out, where given, receives the row's z in T (row-major, D wide).
// Returns the row's L attention weights in shared memory, for the caller to
// write out: with that write inside the body, the loop's bf16 attend kernel
// ran about 17 % slower on an H100 (PERF.md).
template <typename T, typename Args>
__device__ __forceinline__ const float* attend_body(const Args a, int row, T* z_out) {
  extern __shared__ float4 smem_raw[];
  float* alpha = reinterpret_cast<float*>(smem_raw);  // L
  constexpr int NW = ATT_SLICE / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int L = a.L, A = a.A, D = a.D;
  const float* g1 = a.g1 + (size_t)row * a.N1;  // att_dec = g1[0:A], x_beta = g1[A:A+D]
  for (int l = warp; l < L; l += NW) {
    const T* ae = a.att_enc + ((size_t)row * L + l) * A;
    float acc = 0.f;
    for (int j = lane; j < A; j += 32) acc += tanhf(ldf(ae + j) + g1[j]) * a.wf[j];
    acc = warp_sum(acc);
    if (lane == 0) alpha[l] = acc * a.inv_sqrt_l;
  }
  __syncthreads();
  if (warp == 0) {
    float m = -INFINITY;
    for (int l = lane; l < L; l += 32) m = fmaxf(m, alpha[l]);
    m = warp_max(m);
    float sum = 0.f;
    for (int l = lane; l < L; l += 32) {
      const float ev = expf(alpha[l] - m);
      alpha[l] = ev;
      sum += ev;
    }
    sum = warp_sum(sum);
    for (int l = lane; l < L; l += 32) alpha[l] = alpha[l] / sum;
  }
  __syncthreads();
  const int d = blockIdx.y * ATT_SLICE + tid;
  if (d < D) {
    const T* an = a.annot + (size_t)row * L * D + d;
    float z = 0.f;
    for (int l = 0; l < L; ++l) z = fmaf(alpha[l], ldf(an + (size_t)l * D), z);
    const float beta = sigmoidf(g1[A + d] + a.bb[d]);
    a.xt[(size_t)(a.E + d) * a.Bp + row] = from_f<T>(beta * z);
    a.yt[(size_t)(a.H + d) * a.Bp + row] = from_f<T>(z);
    if (z_out) z_out[d] = from_f<T>(z);
  }
  return alpha;
}

// 3. gates = [e | beta z] [Wie; Wiz] + g_h + bias, and the LSTM cell: the
// tile's columns 4u..4u+3 are gates i, f, g, o of hidden unit u.  The cell
// reads c from c_in and writes c' to c_out (both (B, H), in C: float for the
// loop, which keeps c in float, T for the step, whose c and c' are in the
// input type); h_out, where given, receives h' in T (row-major, H wide).
template <typename T, typename C, typename Args>
__device__ __forceinline__ void gates_body(const Args a, const C* c_in, C* c_out, T* h_out) {
  auto& s = tiles<T, P3_BN, P3_KG>();
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * P3_BN;
  gemm_tile(s, a.xt, a.Bp, a.wx, a.G, m0, n0, 0, a.E + a.D);
  for (int i = threadIdx.x; i < BM * P3_BN / 4; i += Tiles<T, P3_BN, P3_KG>::NTH) {
    const int m = i / (P3_BN / 4), q = (i % (P3_BN / 4)) * 4;
    const int row = m0 + m, u = (n0 + q) / 4;
    if (row >= a.B || u >= a.H) continue;
    const float4 x = tile_sum4(s, m, q);
    const float* gh = a.g1 + (size_t)row * a.N1 + a.A + a.D + 4 * u;
    const float* bi = a.bias + 4 * u;
    const float ig = sigmoidf(x.x + gh[0] + bi[0]);
    const float fg = sigmoidf(x.y + gh[1] + bi[1]);
    const float gg = tanhf(x.z + gh[2] + bi[2]);
    const float og = sigmoidf(x.w + gh[3] + bi[3]);
    const size_t ci = (size_t)row * a.H + u;
    const float cn = fg * to_f(c_in[ci]) + ig * gg;
    c_out[ci] = from_f<C>(cn);
    const T hn = from_f<T>(og * tanhf(cn));
    a.yt[(size_t)u * a.Bp + row] = hn;
    if (h_out) h_out[ci] = hn;
  }
}

// 4. part[z] = [h' | z] [Wh; Wc] over K rows [z kc, (z+1) kc).
template <typename T, typename Args>
__device__ __forceinline__ void deepout_body(const Args a) {
  auto& s = tiles<T, P4_BN, P4_KG>();
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * P4_BN;
  const int k0 = min(a.K4, (int)blockIdx.z * a.kc), k1 = min(a.K4, k0 + a.kc);
  gemm_tile(s, a.yt, a.Bp, a.wo, a.Ep, m0, n0, k0, k1);
  tile_store(s, a.part + (size_t)blockIdx.z * a.B * a.Ep, a.B, a.Ep, m0, n0);
}

// -- host side ---------------------------------------------------------------------

// The four phases' grid (x, y, z), threads, dynamic and static shared memory
// bytes, in launch order, for B rows.
template <typename T>
void plan4(int B, int L, int D, int N1, int G, int Ep, int splits, int (&p)[4][6]) {
  const int rt = (B + BM - 1) / BM;
  const int rows[4][6] = {
      {(N1 + P1_BN - 1) / P1_BN, rt, 1, NT, (int)sizeof(Tiles<T, P1_BN, P1_KG>), 0},
      {B, (D + ATT_SLICE - 1) / ATT_SLICE, 1, ATT_SLICE, (int)sizeof(float) * pad4(L), 0},
      {(G + P3_BN - 1) / P3_BN, rt, 1, NT, (int)sizeof(Tiles<T, P3_BN, P3_KG>), 0},
      {(Ep + P4_BN - 1) / P4_BN, rt, splits, NT, (int)sizeof(Tiles<T, P4_BN, P4_KG>), 0}};
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 6; ++j) p[i][j] = rows[i][j];
}

inline dim3 grid(const int (&p)[6]) { return dim3(p[0], p[1], p[2]); }

constexpr int MAX_DEVICES = 64;

// Lets kern use `bytes` of dynamic shared memory on the current device.
// allowed[dev] remembers the largest size already set there, so
// cudaFuncSetAttribute runs once per kernel, device and size, not per call.
template <typename K>
cudaError_t allow_smem(K kern, int bytes, int (&allowed)[MAX_DEVICES]) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && bytes <= allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < MAX_DEVICES) allowed[dev] = bytes;
  return err;
}

}  // namespace sat
