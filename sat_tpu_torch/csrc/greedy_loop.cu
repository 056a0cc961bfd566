// The greedy decode as batch-wide phase kernels: the CUDA counterpart of
// sat_tpu/kernels/greedy_loop.py::_loop_kernel (greedy_loop_decode).
//
// Function.  Per step: attention, beta gate, LSTM cell and deep-output
// pre-projection (the decode step of kernels/decoder_step.py), the vocabulary
// projection t Wout + bout, /temperature, the masks (START and PAD always,
// END and UNK at step 0), argmax (ties to the lower index), the token's
// log-probability scaled[tok] - logsumexp(scaled) over the unmasked row, PAD
// after END, and the finished / flen / score bookkeeping.  A finished row
// keeps PAD and a zero attention row on every later step, as the XLA scan
// does (the Pallas kernel keeps writing alpha there).  The embedding table is
// passed capped at embed_norm; the wrapper pre-fills tokens with PAD and
// alphas with zeros.
//
// What bounds it on an H100.  At B = 64 a step's products are a (64 x K) by
// (K x N) matrix product per weight matrix: 4.6 M weights (18.6 MB in f32)
// for 64 x 4.6 M multiply-adds.  Reading the weights once per row, as the
// TPU kernel's one-block-per-row translation did, makes the step bound by
// one SM's L2 bandwidth; read once per step for all rows, the weights take
// a few microseconds of L2 bandwidth and the step is bound by f32 FMAs.
//
// Design.  A step is five kernels over the whole batch, launched in order on
// one stream by sat_greedy_loop; the kernel boundaries are the grid-wide
// barriers:
//   1. greedy_loop_hside   g1 = h [Wd | Wb | Whh]           (K = H)
//   2. greedy_loop_attend  scores, softmax, z, beta z, z (one row, a D slice)
//   3. greedy_loop_gates   [e | beta z] [Wie; Wiz] + g_h + bias, LSTM cell
//   4. greedy_loop_deepout partial sums of [h' | z] [Wh; Wc], split over K
//   5. greedy_loop_select  t, logits, argmax, score, bookkeeping, next e
// Phases 1, 3 and 4 are tiled products: a block covers up to 64 rows (BM) by
// BN columns, so each weight is read once per step per tile of 64 rows.  The
// activations are kept feature-major (K, Bp), so both the weight tile and the
// row tile arrive in shared memory as 16-byte cp.async copies (two stages),
// and every thread accumulates a 4 x 4 register tile in f32 FMAs.  The
// threads of a block are split into KG groups over the K rows of each stage
// (enough warps to keep the FMA pipes busy); the groups' tiles are summed in
// a fixed order, and phase 4's K slices are summed in a fixed order by phase
// 5, so a run is deterministic.  The column layouts of the packed weights
// (gate columns interleaved as 4u + q) are fixed by
// kernels/greedy_loop.py::pack_loop_weights.  Values are rounded to T where
// step_math rounds them (h', beta z, z for Wc, t before Wout).  Phase 5
// counts finished rows in one integer; every kernel of a later step returns
// at once when it equals B.
#include <limits.h>

#include "decode_common.cuh"

namespace sat {

constexpr int BM = 64;          // rows per tile
constexpr int BK = 128;         // K rows per shared-memory stage
constexpr int ATT_SLICE = 256;  // D columns (and threads) per attend block
constexpr int P1_BN = 32, P1_KG = 2;  // hside: columns per block, K groups
constexpr int P3_BN = 16, P3_KG = 4;  // gates: 4 hidden units x 4 gates
constexpr int P4_BN = 32, P4_KG = 2;  // deepout
// The product kernels are declared __launch_bounds__(NT, 2): up to 128
// registers a thread.  With (NT) alone ptxas held greedy_loop_gates<float> to
// 64 registers and spilled.

template <typename T> struct LoopArgs {
  const T* annot;    // (B, L, D)
  const T* att_enc;  // (B, L, A)
  const T* w1;       // (H, N1)    [Wd | Wb | Whh (gates interleaved) | 0]
  const T* wx;       // (E + D, G) [Wie; Wiz], gates interleaved
  const T* wo;       // (H + D, Ep) [Wh; Wc]
  const float *wf, *bb, *bias;  // (A,), (D,), (G,) interleaved
  const T* emb;      // (V, E), capped
  const T* wout;     // (E, V)
  const float* bout; // (V,)
  T* xt;             // (E + D, Bp) [e; beta z], feature-major
  T* yt;             // (H + D, Bp) [h; z], feature-major
  float* c;          // (B, H)
  float* g1;         // (B, N1) phase-1 output
  float* part;       // (splits, B, Ep) phase-4 partial sums
  int* done;         // finished rows
  int* tokens;       // (B, S + 2)
  float* alphas;     // (B, S + 1, L)
  float* scores;     // (B,)
  int* flen;         // (B,)
  unsigned char* fin;  // (B,)
  int B, Bp, L, D, A, H, E, V, S;
  int N1, G, Ep;        // padded widths of w1, wx, wo
  int K4, kc, splits;   // phase 4: K, K rows per split, splits
  int deep;
  float inv_sqrt_l, temperature;
  int start_i, end_i, pad_i, unk_i;
};

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

// -- the five phases ---------------------------------------------------------------

// 1. g1 = h [Wd | Wb | Whh]: att_dec, x_beta and the recurrent gate sums.
template <typename T>
__global__ void __launch_bounds__(NT, 2)
greedy_loop_hside(LoopArgs<T> a) {
  if (*a.done == a.B) return;
  auto& s = tiles<T, P1_BN, P1_KG>();
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * P1_BN;
  gemm_tile(s, a.yt, a.Bp, a.w1, a.N1, m0, n0, 0, a.H);
  tile_store(s, a.g1, a.B, a.N1, m0, n0);
}

// 2. One row and one slice of D: attention scores over L (recomputed by every
// slice), softmax, z = sum_l alpha_l annot_l, beta z and z rounded to T.
template <typename T>
__global__ void __launch_bounds__(ATT_SLICE) greedy_loop_attend(LoopArgs<T> a, int t) {
  const int row = blockIdx.x;
  if (*a.done == a.B || a.fin[row]) return;
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
  }
  if (blockIdx.y == 0)
    for (int l = tid; l < L; l += ATT_SLICE)
      a.alphas[((size_t)row * (a.S + 1) + t) * L + l] = alpha[l];
}

// 3. gates = [e | beta z] [Wie; Wiz] + g_h + bias, and the LSTM cell: the
// tile's columns 4u..4u+3 are gates i, f, g, o of hidden unit u.
template <typename T>
__global__ void __launch_bounds__(NT, 2)
greedy_loop_gates(LoopArgs<T> a) {
  if (*a.done == a.B) return;
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
    float* cp = a.c + (size_t)row * a.H + u;
    const float cn = fg * *cp + ig * gg;
    *cp = cn;
    a.yt[(size_t)u * a.Bp + row] = from_f<T>(og * tanhf(cn));
  }
}

// 4. part[z] = [h' | z] [Wh; Wc] over K rows [z kc, (z+1) kc).
template <typename T>
__global__ void __launch_bounds__(NT, 2)
greedy_loop_deepout(LoopArgs<T> a) {
  if (*a.done == a.B) return;
  auto& s = tiles<T, P4_BN, P4_KG>();
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * P4_BN;
  const int k0 = min(a.K4, (int)blockIdx.z * a.kc), k1 = min(a.K4, k0 + a.kc);
  gemm_tile(s, a.yt, a.Bp, a.wo, a.Ep, m0, n0, k0, k1);
  tile_store(s, a.part + (size_t)blockIdx.z * a.B * a.Ep, a.B, a.Ep, m0, n0);
}

// 5. One row: t, the logits, the masked argmax and its log-probability, the
// bookkeeping, and the next token's embedding.
template <typename T>
__global__ void __launch_bounds__(NT) greedy_loop_select(LoopArgs<T> a, int t) {
  const int row = blockIdx.x;
  if (*a.done == a.B || a.fin[row]) return;
  extern __shared__ float4 smem_raw[];
  __shared__ int s_tok;
  const int E = a.E, V = a.V;
  float* tp = reinterpret_cast<float*>(smem_raw);  // E
  float* logits = tp + pad4(E);                    // V
  float* scratch = logits + pad4(V);               // NT * Pack<T>::N
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int j = tid; j < E; j += NT) {
    float v = 0.f;
    for (int p = 0; p < a.splits; ++p) v += a.part[((size_t)p * a.B + row) * a.Ep + j];
    if (a.deep) v = tanhf(to_f(a.xt[(size_t)j * a.Bp + row]) + v);
    tp[j] = rnd<T>(v);
  }
  __syncthreads();
  gemv<T>(tp, a.wout, E, V, logits, false, scratch);
  __syncthreads();
  if (warp == 0) {
    const float* bout = a.bout;
    float best = -INFINITY, mx = -INFINITY;
    int bi = INT_MAX;
    for (int v = lane; v < V; v += 32) {
      const float sc = (logits[v] + bout[v]) / a.temperature;
      mx = fmaxf(mx, sc);
      const bool masked = v == a.start_i || v == a.pad_i ||
                          (t == 0 && (v == a.end_i || v == a.unk_i));
      if (!masked && (sc > best || (sc == best && v < bi))) {
        best = sc;
        bi = v;
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(FULL, best, o);
      const int oi = __shfl_xor_sync(FULL, bi, o);
      if (ob > best || (ob == best && oi < bi)) {
        best = ob;
        bi = oi;
      }
    }
    mx = warp_max(mx);
    float se = 0.f;
    for (int v = lane; v < V; v += 32) se += expf((logits[v] + bout[v]) / a.temperature - mx);
    se = warp_sum(se);
    if (lane == 0) {
      if (bi >= V) bi = 0;  // only when every unmasked logit is NaN
      a.scores[row] += (logits[bi] + bout[bi]) / a.temperature - (logf(se) + mx);
      a.tokens[(size_t)row * (a.S + 2) + t + 1] = bi;
      if (bi == a.end_i) {
        a.fin[row] = 1;
        a.flen[row] = t;
        atomicAdd(a.done, 1);
      }
      s_tok = bi;
    }
  }
  __syncthreads();
  for (int j = tid; j < E; j += NT) a.xt[(size_t)j * a.Bp + row] = a.emb[(size_t)s_tok * E + j];
}

// -- host side ---------------------------------------------------------------------

// Each phase's grid (x, y, z), threads, dynamic and static shared memory bytes,
// in launch order.
template <typename T>
void plan(int B, int L, int D, int E, int V, int N1, int G, int Ep, int splits,
          int (&p)[5][6]) {
  const int rt = (B + BM - 1) / BM;
  const int sel = (int)(sizeof(float) * (pad4(E) + pad4(V) + (size_t)NT * Pack<T>::N));
  const int rows[5][6] = {
      {(N1 + P1_BN - 1) / P1_BN, rt, 1, NT, (int)sizeof(Tiles<T, P1_BN, P1_KG>), 0},
      {B, (D + ATT_SLICE - 1) / ATT_SLICE, 1, ATT_SLICE, (int)sizeof(float) * pad4(L), 0},
      {(G + P3_BN - 1) / P3_BN, rt, 1, NT, (int)sizeof(Tiles<T, P3_BN, P3_KG>), 0},
      {(Ep + P4_BN - 1) / P4_BN, rt, splits, NT, (int)sizeof(Tiles<T, P4_BN, P4_KG>), 0},
      {B, 1, 1, NT, sel, 0}};
  for (int i = 0; i < 5; ++i)
    for (int j = 0; j < 6; ++j) p[i][j] = rows[i][j];
}

template <typename K>
cudaError_t allow_smem(K kern, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

inline dim3 grid(const int (&p)[6]) { return dim3(p[0], p[1], p[2]); }

template <typename T>
cudaError_t run(const LoopArgs<T>& a, cudaStream_t st) {
  int p[5][6];
  plan<T>(a.B, a.L, a.D, a.E, a.V, a.N1, a.G, a.Ep, a.splits, p);
  cudaError_t err = allow_smem(greedy_loop_hside<T>, p[0][4]);
  if (err == cudaSuccess) err = allow_smem(greedy_loop_attend<T>, p[1][4]);
  if (err == cudaSuccess) err = allow_smem(greedy_loop_gates<T>, p[2][4]);
  if (err == cudaSuccess) err = allow_smem(greedy_loop_deepout<T>, p[3][4]);
  if (err == cudaSuccess) err = allow_smem(greedy_loop_select<T>, p[4][4]);
  if (err != cudaSuccess) return err;
  for (int t = 0; t <= a.S; ++t) {
    greedy_loop_hside<T><<<grid(p[0]), p[0][3], p[0][4], st>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    greedy_loop_attend<T><<<grid(p[1]), p[1][3], p[1][4], st>>>(a, t);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    greedy_loop_gates<T><<<grid(p[2]), p[2][3], p[2][4], st>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    greedy_loop_deepout<T><<<grid(p[3]), p[3][3], p[3][4], st>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    greedy_loop_select<T><<<grid(p[4]), p[4][3], p[4][4], st>>>(a, t);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(const void* const* in, void* const* st, void* const* out, const int* n,
                   float temperature, const int* special, cudaStream_t stream) {
  LoopArgs<T> a;
  a.annot = static_cast<const T*>(in[0]);
  a.att_enc = static_cast<const T*>(in[1]);
  a.w1 = static_cast<const T*>(in[2]);
  a.wx = static_cast<const T*>(in[3]);
  a.wo = static_cast<const T*>(in[4]);
  a.wf = static_cast<const float*>(in[5]);
  a.bb = static_cast<const float*>(in[6]);
  a.bias = static_cast<const float*>(in[7]);
  a.emb = static_cast<const T*>(in[8]);
  a.wout = static_cast<const T*>(in[9]);
  a.bout = static_cast<const float*>(in[10]);
  a.xt = static_cast<T*>(st[0]);
  a.yt = static_cast<T*>(st[1]);
  a.c = static_cast<float*>(st[2]);
  a.g1 = static_cast<float*>(st[3]);
  a.part = static_cast<float*>(st[4]);
  a.done = static_cast<int*>(st[5]);
  a.tokens = static_cast<int*>(out[0]);
  a.alphas = static_cast<float*>(out[1]);
  a.scores = static_cast<float*>(out[2]);
  a.flen = static_cast<int*>(out[3]);
  a.fin = static_cast<unsigned char*>(out[4]);
  a.B = n[0]; a.Bp = n[1]; a.L = n[2]; a.D = n[3]; a.A = n[4]; a.H = n[5]; a.E = n[6];
  a.V = n[7]; a.S = n[8]; a.N1 = n[9]; a.G = n[10]; a.Ep = n[11]; a.K4 = n[12];
  a.kc = n[13]; a.splits = n[14]; a.deep = n[15];
  a.inv_sqrt_l = (float)pow((double)a.L, -0.5);  // as Python's float(L) ** -0.5
  a.temperature = temperature;
  a.start_i = special[0]; a.end_i = special[1]; a.pad_i = special[2]; a.unk_i = special[3];
  return run<T>(a, stream);
}

}  // namespace sat

// dtype: 0 = float32, 1 = bfloat16.  Inputs: annot, att_enc, then the packed
// weights of kernels/greedy_loop.py::LoopWeights (w1, wx, wo, wf, bb, bias),
// emb, wout, bout.  State (written): xt, yt, c, g1, part, done (zeroed).
// Outputs: tokens (B, S+2) int32 pre-filled with START and PADs, alphas
// (B, S+1, L) float32 zeroed, scores (B,) float32 zeroed, flen (B,) int32,
// fin (B,) bool, both zeroed.  Sizes B, Bp, L, D, A, H, E, V, S, N1, G, Ep,
// K4, kc, splits, deep.  Launches 5 (S+1) kernels on the stream and returns
// the first cudaError_t.
extern "C" int sat_greedy_loop(int dtype, const void* annot, const void* att_enc,
                               const void* w1, const void* wx, const void* wo, const void* wf,
                               const void* bb, const void* bias, const void* emb,
                               const void* wout, const void* bout, void* xt, void* yt, void* c,
                               void* g1, void* part, void* done, void* tokens, void* alphas,
                               void* scores, void* flen, void* fin, int B, int Bp, int L, int D,
                               int A, int H, int E, int V, int S, int N1, int G, int Ep, int K4,
                               int kc, int splits, int deep, float temperature, int start_i,
                               int end_i, int pad_i, int unk_i, void* stream) {
  const void* in[11] = {annot, att_enc, w1, wx, wo, wf, bb, bias, emb, wout, bout};
  void* st[6] = {xt, yt, c, g1, part, done};
  void* out[5] = {tokens, alphas, scores, flen, fin};
  const int n[16] = {B, Bp, L, D, A, H, E, V, S, N1, G, Ep, K4, kc, splits, deep};
  const int special[4] = {start_i, end_i, pad_i, unk_i};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0) return cudaSuccess;
  if (dtype == 0) return sat::launch<float>(in, st, out, n, temperature, special, s);
  if (dtype == 1) return sat::launch<__nv_bfloat16>(in, st, out, n, temperature, special, s);
  return cudaErrorInvalidValue;
}

// The launch plan of sat_greedy_loop for these sizes: out[6 i + j] is phase
// i's grid x, y, z, threads, dynamic and static shared memory bytes.
extern "C" int sat_greedy_loop_plan(int dtype, int B, int L, int D, int E, int V, int N1, int G,
                                    int Ep, int splits, int* out) {
  int p[5][6];
  if (dtype == 0)
    sat::plan<float>(B, L, D, E, V, N1, G, Ep, splits, p);
  else if (dtype == 1)
    sat::plan<__nv_bfloat16>(B, L, D, E, V, N1, G, Ep, splits, p);
  else
    return cudaErrorInvalidValue;
  for (int i = 0; i < 5; ++i)
    for (int j = 0; j < 6; ++j) out[6 * i + j] = p[i][j];
  return cudaSuccess;
}
