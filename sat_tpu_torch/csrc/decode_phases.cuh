// One decode step for a whole batch as four phases in five kernels, the
// device code shared by the greedy loop (greedy_loop.cu) and the fused step
// (decoder_step.cu).  Each source launches them through __global__ wrappers
// of its own, in order on one stream; the kernel boundaries are the
// grid-wide barriers:
//   1. hside    g1 = h [Wd | Wb | Whh]                       (K = H)
//   2. scores   the attention scores of each row over L (one image's rows,
//               a chunk of L)
//      attend   softmax, z, beta z, z (one image's rows, a D slice)
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
// step_math rounds them (h', beta z, z for Wc).
//
// The bfloat16 instance (MmaTiles, Products<__nv_bfloat16>) multiplies on
// the tensor cores: mma.sync m16n8k16, bf16 operands fed from the same
// stages by ldmatrix.trans, float32 sums, as the TPU kernel's
// jnp.dot(preferred_element_type=f32).  That makes the math nearly free
// (1.8 GFLOP a step at N = 192 is 1.8 us of the H100's 989 TFLOP/s) and
// leaves the bytes: each block streams its K rows of the weight tile and of
// the 64-row tile of activations from L2 (9.3 MB of weights a step, the row
// tile once per column block), and a kernel pays its launch and, per stage,
// a wait on the copies and a barrier.  The tiles keep the f32 columns and
// enough blocks (at least 64 of them at B = 64) to spread the streams over
// the SMs, and take 256-row stages for hside and gates, which halve the
// waits and barriers; on an H100 the launch, the copies, the MMA loop and
// the epilogue of a product added up with little overlap (PERF.md).  Wider
// tiles with K split over a thread-block cluster read fewer bytes but were
// slower there: the cluster's barriers and its exchange of partial sums
// through distributed shared memory cost more than the bytes saved.
// mma.sync and not wgmma: the products are bound by those bytes and waits,
// far below mma.sync's rate; wgmma waits for a measurement that shows the
// MMA issue rate binding.
//
// Phase 2 reads the annotations, (B / k, L, D) for B rows, k rows to an
// image (a beam's slots; 1 in the loop): 103 MB a step at L 196, D 2048,
// B / k = 64 in f32, 31 us of the H100's 3.35 TB/s, the one large input of
// the step.  Each image's annotations are streamed from device memory once
// per step for all its rows, staged in shared memory by cp.async, and each
// score (an A-wide sum of tanh terms, 4.8 M of them at N = 192, L 196) is
// computed once per row by its own kernel, so the attend blocks, one per
// image and D slice, do no redundant scoring and start their copies at once.
// Slices of 128 columns, one to a thread, and two stages of 26 positions
// were the fastest shape an H100 measured (PERF.md): 256-column slices, four
// columns a thread, three stages of 17 positions, two of 34 and TMA bulk
// copies were no faster.  The bodies read no state
// of the loop (finished rows, the count of them): the loop's wrappers return
// before calling them where that state says so.
#pragma once

#include "decode_common.cuh"

namespace sat {

constexpr int BM = 64;          // rows per tile
constexpr int BK = 128;         // K rows per shared-memory stage
constexpr int ATT_SLICE = 128;  // D columns (and threads) per attend block
constexpr int ATT_ST = 2;       // attend: annotation chunks staged at once
constexpr int ATT_RQ = 4;       // attend: rows summed per pass over a chunk
constexpr int ATT_KC = 32;      // attend: most rows of one image per block
// attend: L positions per chunk, 26 in f32: L 49 in two chunks, and eight
// blocks of a beam's three rows on an SM
template <typename T> constexpr int ATT_LC = 104 / (int)sizeof(T);
constexpr int SC_RB = 4;        // scores: rows per pass over A
constexpr int SC_J = 4;         // scores: terms a lane loads before evaluating them
constexpr int SC_L = NWARPS;    // scores: L positions per block, one to a warp
constexpr int P1_BN = 32, P1_KG = 2;  // float32 hside: columns per block, K groups
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

// Dynamic shared memory of one tile: two stages of the row tile (k-major)
// and of the weight tile; once the products are done, each K group's f32
// sums take the place of the stages (red()).  The float32 instance.
template <typename T, int BN, int KG> struct Tiles {
  static constexpr int TX = BN / 4, TY = BM / 4;  // 4 x 4 register tiles
  static constexpr int NTH = TX * TY * KG;        // threads
  static constexpr int KPG = BK / KG;             // K rows per group and stage
  static constexpr int VE = 16 / (int)sizeof(T);  // elements per 16-byte copy
  // columns, partial sums that tile_sum4 adds, stages, K rows a stage
  static constexpr int NCOL = BN, NRED = KG, STAGES = 2, MMA = 0, KROWS = BK;
  typename Store<T>::type a[2][BK][BM];
  typename Store<T>::type w[2][BK][BN];
  __device__ float (*red())[BM][BN] { return reinterpret_cast<float(*)[BM][BN]>(a); }
  __device__ const float (*red() const)[BM][BN] {
    return reinterpret_cast<const float(*)[BM][BN]>(a);
  }
  static_assert(NTH == NT, "a tile takes one block of NT threads");
  static_assert(sizeof(float) * KG * BM * BN <= sizeof(a), "the sums fit the stages");
};

template <typename TL> __device__ __forceinline__ TL& tiles() {
  extern __shared__ float4 smem_raw[];
  return *reinterpret_cast<TL*>(smem_raw);
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

// -- the bfloat16 instance: tensor cores --
// The same contract on bf16 operands: s.red()[g][m][n] holds float32 sums
// for g < NRED = KG, and tile_sum4 adds them in order.  Warps are WM x WN x
// KG: warp (wm, wn, g) takes rows wm BM / WM.., columns wn BN / WN.. of the
// tile and, of each stage of SK rows, the k16 steps g SPG .. (g + 1) SPG -
// 1, each an mma.sync m16n8k16 (bf16 operands, float32 sums) on operands
// that ldmatrix.trans reads from the stages as they are laid out: the row
// tile k-major (a[st][k][m], M contiguous) gives the row-major A fragment,
// the weight tile (w[st][k][n], N contiguous) the .col B fragment.  The
// 16-byte chunks of each stage row are stored XOR-swizzled by the row (swz),
// so the eight rows one ldmatrix phase reads at one column lie in eight
// different bank groups.  ST stages of SK rows, ST - 1 of them in flight.
// Each output element is its row's own dot product in a fixed K order (the
// order does not depend on N), so grouped rows equal copies bit for bit.
template <int BN, int WM, int WN, int ST, int SK> struct MmaTiles {
  static constexpr int KG = NWARPS / (WM * WN);       // K groups
  static constexpr int MF = BM / WM / 16, NF = BN / WN / 8;  // m16 and n8 fragments a warp
  static constexpr int SPG = SK / 16 / KG;            // k16 steps per group and stage
  static constexpr int NCOL = BN, NRED = KG, STAGES = ST, MMA = 1, KROWS = SK;
  unsigned short a[ST][SK][BM];
  unsigned short w[ST][SK][BN];
  __device__ float (*red())[BM][BN] { return reinterpret_cast<float(*)[BM][BN]>(a); }
  __device__ const float (*red() const)[BM][BN] {
    return reinterpret_cast<const float(*)[BM][BN]>(a);
  }
  static_assert(WM * WN * KG == NWARPS && SPG * 16 * KG == SK, "warps cover the tile and K");
  static_assert(NF % 2 == 0, "ldmatrix.x4 loads two n8 fragments of B");
  static_assert(sizeof(float) * KG * BM * BN <= sizeof(a) + sizeof(w), "the sums fit the stages");
};

// Where chunk c (16 bytes) of stage row k is stored, for rows of R chunks
// (a power of two): c XOR bits of k that differ among eight adjacent rows'
// positions, so those rows' chunk c fall in eight different bank groups.
template <int R> __device__ __forceinline__ int swz(int k, int c) {
  if constexpr (R >= 8) return c ^ (k & 7);
  else if constexpr (R == 1) return c;
  else return c ^ ((k / (8 / R)) & (R - 1));
}

template <int BN, int WM, int WN, int ST, int SK>
__device__ __forceinline__ void stage_load(MmaTiles<BN, WM, WN, ST, SK>& s, int st,
                                           const __nv_bfloat16* at, int lda,
                                           const __nv_bfloat16* w, int ldw, int m0, int n0,
                                           int kb, int k1) {
  constexpr int AC = BM / 8, WC = BN / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < SK * AC; i += NT) {
    const int kr = i / AC, c = i % AC, k = kb + kr, m = m0 + c * 8;
    const bool ok = k < k1 && m < lda;
    cp_async16(&s.a[st][kr][swz<AC>(kr, c) * 8], ok ? at + (size_t)k * lda + m : at, ok);
  }
  for (int i = threadIdx.x; i < SK * WC; i += NT) {
    const int kr = i / WC, c = i % WC, k = kb + kr, n = n0 + c * 8;
    const bool ok = k < k1 && n < ldw;
    cp_async16(&s.w[st][kr][swz<WC>(kr, c) * 8], ok ? w + (size_t)k * ldw + n : w, ok);
  }
  cp_async_commit();
}

__device__ __forceinline__ void ldsm4t(unsigned (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// d += a b: a 16 x 16 (row), b 16 x 8 (col), bf16; d 16 x 8 float32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// gemm_tile on bf16 operands (the contract above, see MmaTiles).
template <int BN, int WM, int WN, int ST, int SK>
__device__ __forceinline__ void gemm_tile(MmaTiles<BN, WM, WN, ST, SK>& s,
                                          const __nv_bfloat16* __restrict__ at, int lda,
                                          const __nv_bfloat16* __restrict__ w, int ldw, int m0,
                                          int n0, int k0, int k1) {
  using TL = MmaTiles<BN, WM, WN, ST, SK>;
  constexpr int MF = TL::MF, NF = TL::NF, SPG = TL::SPG;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp % WM, wn = (warp / WM) % WN, g = warp / (WM * WN);
  float acc[MF][NF][4];
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
  const int nk = k1 > k0 ? (k1 - k0 + SK - 1) / SK : 0;
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {
    if (i < nk) stage_load(s, i, at, lda, w, ldw, m0, n0, k0 + i * SK, k1);
    else cp_async_commit();
  }
  // this lane's row of the ldmatrix.x4 operands: matrix lj, row li
  const int lj = lane >> 3, li = lane & 7;
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<ST - 2>();
    __syncthreads();  // stage kt has landed; every warp is done with stage kt - 1
    const int nx = kt + ST - 1;
    if (nx < nk) stage_load(s, nx % ST, at, lda, w, ldw, m0, n0, k0 + nx * SK, k1);
    else cp_async_commit();
    const int st = kt % ST;
#pragma unroll
    for (int q = 0; q < SPG; ++q) {
      const int kb = (g * SPG + q) * 16;  // the step's first row in the stage
      if (k0 + kt * SK + kb >= k1) continue;  // zero rows (the warp's choice is uniform)
      unsigned af[MF][4], bq[NF][2];
#pragma unroll
      for (int i = 0; i < MF; ++i) {
        // matrices: (k 0-7, m 0-7), (k 0-7, m 8-15), (k 8-15, m 0-7), (k 8-15, m 8-15)
        const int kr = kb + (lj >> 1) * 8 + li, m = wm * (BM / WM) + i * 16 + (lj & 1) * 8;
        ldsm4t(af[i], &s.a[st][kr][swz<BM / 8>(kr, m / 8) * 8]);
      }
#pragma unroll
      for (int j = 0; j < NF; j += 2) {
        // matrices: (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15)
        const int kr = kb + (lj & 1) * 8 + li, n = wn * (BN / WN) + j * 8 + (lj >> 1) * 8;
        unsigned r[4];
        ldsm4t(r, &s.w[st][kr][swz<BN / 8>(kr, n / 8) * 8]);
        bq[j][0] = r[0]; bq[j][1] = r[1]; bq[j + 1][0] = r[2]; bq[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MF; ++i)
#pragma unroll
        for (int j = 0; j < NF; ++j) mma_bf16(acc[i][j], af[i], bq[j][0], bq[j][1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // red() overwrites the stages
  auto red = s.red();
  const int gr = lane >> 2, tq = lane & 3;  // the accumulator's row and column pair
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      const int m = wm * (BM / WM) + i * 16 + gr, n = wn * (BN / WN) + j * 8 + 2 * tq;
      *reinterpret_cast<float2*>(&red[g][m][n]) = make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(&red[g][m + 8][n]) = make_float2(acc[i][j][2], acc[i][j][3]);
    }
  __syncthreads();
}

// The sum over the K groups, in group order, of the tile's columns n..n+3 of row m.
template <typename TL>
__device__ __forceinline__ float4 tile_sum4(const TL& s, int m, int n) {
  float4 v = *reinterpret_cast<const float4*>(&s.red()[0][m][n]);
#pragma unroll
  for (int g = 1; g < TL::NRED; ++g) {
    const float4 u = *reinterpret_cast<const float4*>(&s.red()[g][m][n]);
    v.x += u.x; v.y += u.y; v.z += u.z; v.w += u.w;
  }
  return v;
}

// Writes the tile's f32 sums to out (rows < B, columns < N, row stride N).
template <typename TL>
__device__ __forceinline__ void tile_store(const TL& s, float* out, int B, int N, int m0,
                                           int n0) {
  constexpr int BN = TL::NCOL;
  for (int i = threadIdx.x; i < BM * BN / 4; i += NT) {
    const int m = i / (BN / 4), n = (i % (BN / 4)) * 4;
    if (m0 + m < B && n0 + n < N)
      *reinterpret_cast<float4*>(out + (size_t)(m0 + m) * N + n0 + n) = tile_sum4(s, m, n);
  }
}

// The tile of each product, by input type: float32 on the FMA pipes as
// above, bfloat16 on the tensor cores (MmaTiles<BN, WM, WN, ST, SK>).
template <typename T> struct Products;
template <> struct Products<float> {
  using hside = Tiles<float, P1_BN, P1_KG>;
  using gates = Tiles<float, P3_BN, P3_KG>;
  using deepout = Tiles<float, P4_BN, P4_KG>;
};
template <> struct Products<__nv_bfloat16> {
  using hside = MmaTiles<32, 2, 1, 2, 256>;
  using gates = MmaTiles<16, 1, 1, 2, 256>;
  using deepout = MmaTiles<32, 2, 1, 2, 128>;
};

// -- the phases ---------------------------------------------------------------------
// Grids: hside (N1 / BN, row tiles), scores (images, L / SC_L), attend
// (images, D / ATT_SLICE, row chunks), gates (G / BN, row tiles), deepout
// (Ep / BN, row tiles, splits), BN each product's tile's (Products); see
// plan5.

// 1. g1 = h [Wd | Wb | Whh]: att_dec, x_beta and the recurrent gate sums.
template <typename T, typename Args>
__device__ __forceinline__ void hside_body(const Args a) {
  using TL = typename Products<T>::hside;
  auto& s = tiles<TL>();
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * TL::NCOL;
  gemm_tile(s, a.yt, a.Bp, a.w1, a.N1, m0, n0, 0, a.H);
  tile_store(s, a.g1, a.B, a.N1, m0, n0);
}

// 2. attend, as two kernels.  Rows are grouped by image: the B rows are
// image-major and slot-minor, k to an image (the beam's slots; k = 1 in the
// loop), and row r reads image r / k of annot (B / k, L, D) and att_enc
// (B / k, L, A).  The order of every sum over a row is fixed and does not
// depend on k, so a grouped call equals the same call on k-fold copies of
// each image bit for bit.
//
// 2a. scores: sc[r][l] = (sum_j tanh(att_enc[i][l][j] + att_dec[r][j]) wf[j])
// / sqrt(L) for the k rows r of image i = blockIdx.x, at the SC_L positions
// l of blockIdx.y, one to a warp; each score once per row and step.  Lane j
// sums terms j, j + 32, ... in order, then the lanes in a fixed butterfly.
// A warp loads SC_J terms' operands a lane (att_enc, wf and SC_RB rows'
// att_dec) before it evaluates them, so their loads are in flight at once,
// and each att_enc element is loaded once for the SC_RB rows of a pass.
template <typename T, typename Args>
__device__ __forceinline__ void scores_body(const Args a, int k, float* sc) {
  const int lane = threadIdx.x & 31;
  const int img = blockIdx.x, L = a.L, A = a.A;
  const int l = blockIdx.y * SC_L + (threadIdx.x >> 5);
  if (l >= L) return;
  const T* ae = a.att_enc + ((size_t)img * L + l) * A;
  for (int q0 = 0; q0 < k; q0 += SC_RB) {
    const int row0 = img * k + q0, nq = min(SC_RB, k - q0);
    float acc[SC_RB];
#pragma unroll
    for (int q = 0; q < SC_RB; ++q) acc[q] = 0.f;
    for (int j0 = lane; j0 < A; j0 += 32 * SC_J) {
      float x[SC_J], w[SC_J], g[SC_RB][SC_J];
#pragma unroll
      for (int u = 0; u < SC_J; ++u) {
        const int j = j0 + 32 * u;
        const bool ok = j < A;
        x[u] = ok ? ldf(ae + j) : 0.f;
        w[u] = ok ? a.wf[j] : 0.f;
#pragma unroll
        for (int q = 0; q < SC_RB; ++q)
          g[q][u] = ok && q < nq ? a.g1[(size_t)(row0 + q) * a.N1 + j] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < SC_J; ++u)
        if (j0 + 32 * u < A) {
#pragma unroll
          for (int q = 0; q < SC_RB; ++q)
            if (q < nq) acc[q] += tanhf(x[u] + g[q][u]) * w[u];
        }
    }
#pragma unroll
    for (int q = 0; q < SC_RB; ++q)
      if (q < nq) {
        const float v = warp_sum(acc[q]);
        if (lane == 0) sc[(size_t)(row0 + q) * L + l] = v * a.inv_sqrt_l;
      }
  }
}

template <typename S> __device__ __forceinline__ float stored_f(S x);
template <> __device__ __forceinline__ float stored_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float stored_f<unsigned short>(unsigned short x) {
  return bf16_lo(x);
}

// One pass over a staged chunk for R rows: z[q] += alpha[q][l] x[l] over the
// chunk's nl positions in order.
template <int R, typename S>
__device__ __forceinline__ void attend_pass(float (&z)[ATT_RQ], const S* x, const float* al,
                                            int lc, int nl) {
#pragma unroll 4
  for (int l = 0; l < nl; ++l) {
    const float v = stored_f(x[l * ATT_SLICE]);
#pragma unroll
    for (int q = 0; q < R; ++q) z[q] = fmaf(al[q * lc + l], v, z[q]);
  }
}

template <typename S>
__device__ __forceinline__ void attend_pass(float (&z)[ATT_RQ], int n, const S* x,
                                            const float* al, int lc, int nl) {
  switch (n) {
    case 1: attend_pass<1>(z, x, al, lc, nl); break;
    case 2: attend_pass<2>(z, x, al, lc, nl); break;
    case 3: attend_pass<3>(z, x, al, lc, nl); break;
    default: attend_pass<ATT_RQ>(z, x, al, lc, nl); break;
  }
}

// 2b. attend: for up to ATT_KC rows of image i = blockIdx.x (the row chunk
// blockIdx.z) and the D slice blockIdx.y, the softmax of the rows' scores,
// z = sum_l alpha_l annot_l, beta z and z rounded to T.  The block streams
// its slice of the image's annotations once, in chunks of ATT_LC positions
// staged in shared memory by cp.async (ATT_ST chunks in flight, all of them
// from the start at L <= ATT_ST ATT_LC) together with its rows' scores there,
// and every thread adds its column of a chunk into the sums of all the
// block's rows, ATT_RQ rows per pass.  Each block takes the softmax of its
// rows itself (a row's max and sum of exponentials over L in a fixed
// order), so no block waits on another; the slice-0 blocks write alpha to
// aout (row r at aout + r astride).  z_out, where given, receives z in T
// (row-major, D wide).
template <typename T> struct AttendTile {
  static constexpr int LC = ATT_LC<T>;
  typename Store<T>::type x[ATT_ST][LC][ATT_SLICE];
};

__host__ __device__ inline int attend_rows(int k) { return k < ATT_KC ? k : ATT_KC; }

// Dynamic shared memory of an attend block of kb rows: the annotation
// stages, then in float the rows' sums zs[kb][ATT_SLICE] (only for kb >
// ATT_RQ: up to ATT_RQ rows' sums stay in registers, leaving room for more
// blocks on an SM), the score stages ss[ATT_ST][kb][LC], a chunk's
// weights al[kb][LC], each row's max and sum.
__host__ __device__ inline int attend_sums(int kb) { return kb > ATT_RQ ? kb * ATT_SLICE : 0; }
template <typename T> __host__ __device__ inline int attend_smem(int kb) {
  return (int)sizeof(AttendTile<T>) +
         4 * (attend_sums(kb) + kb * ((ATT_ST + 1) * ATT_LC<T> + 2));
}

__device__ __forceinline__ unsigned short raw_ld(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned short*>(p));
}
__device__ __forceinline__ float raw_ld(const float* p) { return __ldg(p); }

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

template <typename T, typename Args>
__device__ __forceinline__ void attend_body(const Args a, int k, const float* sc, float* aout,
                                            size_t astride, T* z_out) {
  constexpr int LC = ATT_LC<T>;
  extern __shared__ float4 smem_raw[];
  auto& tile = *reinterpret_cast<AttendTile<T>*>(smem_raw);
  const int kb = attend_rows(k);
  float* zs = reinterpret_cast<float*>(smem_raw) + sizeof(AttendTile<T>) / 4;
  float* ss = zs + attend_sums(kb);   // [ATT_ST][kb][LC]
  float* al = ss + ATT_ST * kb * LC;
  float* mx = al + kb * LC;
  float* sm = mx + kb;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int L = a.L, D = a.D, img = blockIdx.x;
  const int q0 = blockIdx.z * kb, nr = min(kb, k - q0), row0 = img * k + q0;
  const int d0 = blockIdx.y * ATT_SLICE, d = d0 + tid;
  const T* an = a.annot + (size_t)img * L * D;
  const float* sr = sc + (size_t)row0 * L;  // the block's rows' scores
  const int nch = (L + LC - 1) / LC;
  // 16-byte copies where every row of the slice starts on 16 bytes
  const bool vec = reinterpret_cast<uintptr_t>(a.annot) % 16 == 0 &&
                   ((size_t)D * sizeof(T)) % 16 == 0;
  auto load = [&](int c) {
    const int st = c % ATT_ST, lb = c * LC;
    if (vec) {
      constexpr int VE = 16 / (int)sizeof(T), CPR = ATT_SLICE / VE;
#pragma unroll 1
      for (int i = tid; i < LC * CPR; i += ATT_SLICE) {
        const int lr = i / CPR, dc = (i % CPR) * VE, l = lb + lr;
        const bool ok = l < L && d0 + dc < D;
        cp_async16(&tile.x[st][lr][dc], ok ? an + (size_t)l * D + d0 + dc : an, ok);
      }
    } else {
#pragma unroll 1
      for (int lr = 0; lr < LC; ++lr) {
        const int l = lb + lr;
        tile.x[st][lr][tid] = l < L && d < D ? raw_ld(an + (size_t)l * D + d)
                                             : typename Store<T>::type(0);
      }
    }
#pragma unroll 1
    for (int i = tid; i < nr * LC; i += ATT_SLICE) {
      const int q = i / LC, l = lb + i % LC;
      cp_async4(&ss[(st * kb + q) * LC + i % LC], l < L ? sr + (size_t)q * L + l : sr,
                l < L);
    }
    cp_async_commit();
  };
  // the first chunks' copies, and the loads of the epilogue's first rows,
  // run while the rows' max and sum are taken
#pragma unroll
  for (int c = 0; c < ATT_ST; ++c) {
    if (c < nch) load(c);
    else cp_async_commit();
  }
  const float bb = d < D ? a.bb[d] : 0.f;
  float xb[ATT_RQ];
#pragma unroll
  for (int q = 0; q < ATT_RQ; ++q)
    xb[q] = q < nr && d < D ? a.g1[(size_t)(row0 + q) * a.N1 + a.A + d] : 0.f;
  for (int q = warp; q < nr; q += ATT_SLICE / 32) {
    const float* s = sr + (size_t)q * L;
    float m = -INFINITY;
    for (int l = lane; l < L; l += 32) m = fmaxf(m, s[l]);
    m = warp_max(m);
    float sum = 0.f;
    for (int l = lane; l < L; l += 32) sum += expf(s[l] - m);
    sum = warp_sum(sum);
    if (lane == 0) {
      mx[q] = m;
      sm[q] = sum;
    }
  }
  const bool in_regs = kb <= ATT_RQ;
  float zr[ATT_RQ];  // the rows' sums where in_regs
#pragma unroll
  for (int q = 0; q < ATT_RQ; ++q) zr[q] = 0.f;
  if (!in_regs)
    for (int q = 0; q < nr; ++q) zs[q * ATT_SLICE + tid] = 0.f;
  for (int c = 0; c < nch; ++c) {
    const int st = c % ATT_ST, lb = c * LC, nl = min(LC, L - lb);
    cp_async_wait<ATT_ST - 1>();
    __syncthreads();  // chunk c's copies, and (c = 0) the rows' max and sum
    for (int i = tid; i < nr * LC; i += ATT_SLICE) {
      const int q = i / LC, lr = i % LC;
      if (lr >= nl) continue;
      const float v = expf(ss[(st * kb + q) * LC + lr] - mx[q]) / sm[q];
      al[q * LC + lr] = v;
      if (blockIdx.y == 0) aout[(size_t)(row0 + q) * astride + lb + lr] = v;
    }
    __syncthreads();
    const auto* x = &tile.x[st][0][tid];
    if (in_regs) {
      attend_pass(zr, nr, x, al, LC, nl);
    } else {
      for (int g = 0; g < nr; g += ATT_RQ) {
        const int n = min(ATT_RQ, nr - g);
        float* zg = zs + g * ATT_SLICE + tid;
        float z[ATT_RQ];
#pragma unroll
        for (int q = 0; q < ATT_RQ; ++q) z[q] = q < n ? zg[q * ATT_SLICE] : 0.f;
        attend_pass(z, n, x, al + g * LC, LC, nl);
#pragma unroll
        for (int q = 0; q < ATT_RQ; ++q)
          if (q < n) zg[q * ATT_SLICE] = z[q];
      }
    }
    __syncthreads();  // chunk c + ATT_ST's copies and weights overwrite these
    if (c + ATT_ST < nch) load(c + ATT_ST);
    else cp_async_commit();
  }
  if (d >= D) return;
  auto store = [&](int q, float z, float xbeta) {
    const int row = row0 + q;
    const float beta = sigmoidf(xbeta + bb);
    a.xt[(size_t)(a.E + d) * a.Bp + row] = from_f<T>(beta * z);
    a.yt[(size_t)(a.H + d) * a.Bp + row] = from_f<T>(z);
    if (z_out) z_out[(size_t)row * D + d] = from_f<T>(z);
  };
#pragma unroll
  for (int q = 0; q < ATT_RQ; ++q)
    if (q < nr) store(q, in_regs ? zr[q] : zs[q * ATT_SLICE + tid], xb[q]);
  for (int q = ATT_RQ; q < nr; ++q)
    store(q, zs[q * ATT_SLICE + tid], a.g1[(size_t)(row0 + q) * a.N1 + a.A + d]);
}

// 3. gates = [e | beta z] [Wie; Wiz] + g_h + bias, and the LSTM cell: the
// tile's columns 4u..4u+3 are gates i, f, g, o of hidden unit u.  The cell
// reads c from c_in and writes c' to c_out (both (B, H), in C: float for the
// loop, which keeps c in float, T for the step, whose c and c' are in the
// input type); h_out, where given, receives h' in T (row-major, H wide).
template <typename T, typename C, typename Args>
__device__ __forceinline__ void gates_body(const Args a, const C* c_in, C* c_out, T* h_out) {
  using TL = typename Products<T>::gates;
  constexpr int BN = TL::NCOL;
  auto& s = tiles<TL>();
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  gemm_tile(s, a.xt, a.Bp, a.wx, a.G, m0, n0, 0, a.E + a.D);
  for (int i = threadIdx.x; i < BM * BN / 4; i += NT) {
    const int m = i / (BN / 4), q = (i % (BN / 4)) * 4;
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
  using TL = typename Products<T>::deepout;
  auto& s = tiles<TL>();
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * TL::NCOL;
  const int k0 = min(a.K4, (int)blockIdx.z * a.kc), k1 = min(a.K4, k0 + a.kc);
  gemm_tile(s, a.yt, a.Bp, a.wo, a.Ep, m0, n0, k0, k1);
  tile_store(s, a.part + (size_t)blockIdx.z * a.B * a.Ep, a.B, a.Ep, m0, n0);
}

// -- host side ---------------------------------------------------------------------

// The five phase kernels' grid (x, y, z), threads, dynamic and static shared
// memory bytes, in launch order (hside, scores, attend, gates, deepout), for
// B rows, k to an image.
template <typename T>
void plan5(int B, int k, int L, int D, int N1, int G, int Ep, int splits, int (&p)[5][6]) {
  using P1 = typename Products<T>::hside;
  using P3 = typename Products<T>::gates;
  using P4 = typename Products<T>::deepout;
  const int rt = (B + BM - 1) / BM, imgs = B / k, kb = attend_rows(k);
  const int rows[5][6] = {
      {(N1 + P1::NCOL - 1) / P1::NCOL, rt, 1, NT, (int)sizeof(P1), 0},
      {imgs, (L + SC_L - 1) / SC_L, 1, NT, 0, 0},
      {imgs, (D + ATT_SLICE - 1) / ATT_SLICE, (k + kb - 1) / kb, ATT_SLICE,
       attend_smem<T>(kb), 0},
      {(G + P3::NCOL - 1) / P3::NCOL, rt, 1, NT, (int)sizeof(P3), 0},
      {(Ep + P4::NCOL - 1) / P4::NCOL, rt, splits, NT, (int)sizeof(P4), 0}};
  for (int i = 0; i < 5; ++i)
    for (int j = 0; j < 6; ++j) p[i][j] = rows[i][j];
}

inline dim3 grid(const int (&p)[6]) { return dim3(p[0], p[1], p[2]); }

// A product's tile, as the [design] lines print it: columns, K rows per
// stage, stages, K groups (warps or threads splitting each stage's rows), 1
// for tensor cores (0: FMA).
template <typename TL> void tile_design(int* o) {
  const int d[5] = {TL::NCOL, TL::KROWS, TL::STAGES, TL::NRED, TL::MMA};
  for (int i = 0; i < 5; ++i) o[i] = d[i];
}

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
