// The greedy decode as batch-wide phase kernels: the CUDA counterpart of
// sat_tpu/kernels/greedy_loop.py::_loop_kernel (greedy_loop_decode).
//
// Function.  Per step: attention, beta gate, LSTM cell and deep-output
// pre-projection (the decode step of kernels/decoder_step.py), the vocabulary
// projection t Wout + bout, /temperature, the masks (START and PAD always,
// END and UNK at step 0), argmax (ties to the lower index), the token's
// log-probability scaled[tok] - logsumexp(scaled) over the whole row (masked
// entries included), PAD after END, and the finished / flen / score
// bookkeeping.  A finished row keeps PAD and a zero attention row on every
// later step, as the XLA scan does (the Pallas kernel keeps writing alpha
// there).  The embedding table is passed capped at embed_norm; the wrapper
// pre-fills tokens with PAD and alphas with zeros.
//
// Design.  A step is eight kernels over the whole batch, launched in order on
// one stream by sat_greedy_loop: greedy_loop_hside, _scores, _attend, _gates
// and _deepout run the four phases of decode_phases.cuh (whose comment gives
// their design and what bounds them; one image to a row here), and the
// selection takes three:
//   5. greedy_loop_tproj   t: phase 4's K slices summed, tanh(e + .), into tt
//   6. greedy_loop_logits  t Wout as a tiled product over 64 rows by SEL_BN
//                          columns; per (row, column tile) a partial: max,
//                          sum of exp, best unmasked value and index
//   7. greedy_loop_select  the partials combined per row in a fixed order,
//                          score, bookkeeping, next e
// The vocabulary product is (B x E) by (E x V): at B 64, E 256, V 4096 it is
// 67 M multiply-adds per step reading a 4 MB Wout (f32).  Tiled over 64 rows,
// Wout is read once per step per row tile and stays in L2, and V / SEL_BN
// blocks share the work (256 at V 4096; 16 columns measured faster than 32
// at V 97 and no slower at 4096), so the product's bound is its f32 FMAs,
// about 2 us a step at 67 TFLOP/s (an H100 measured about 8.5 us: latency
// bounds it, as it does the other products, PERF.md).  In bf16 the product
// runs on the tensor cores (LogitsTile, decode_phases.cuh).  Nothing V-wide is
// held per row, so shared memory does not bound V.  Wout is packed to (E, pad8(V)) with zero columns
// (kernels/decoder_step.py::pack_vocab_weights), so its rows are whole
// 16-byte copies; columns >= V take no part.  The loop keeps c in float and
// counts finished rows in one integer; every kernel of a later step returns
// at once when it equals B.  No float is summed by atomics: two runs agree
// bit for bit.
#include <limits.h>

#include "decode_phases.cuh"

namespace sat {

constexpr int SEL_BN = 16, SEL_KG = 4;  // logits: vocabulary columns per block, K groups

// The logits' tile by input type: float32 FMAs, or bf16 on the tensor cores
// (decode_phases.cuh), SEL_BN columns either way.
template <typename T> struct LogitsTile { using type = Tiles<float, SEL_BN, SEL_KG>; };
template <> struct LogitsTile<__nv_bfloat16> { using type = MmaTiles<SEL_BN, 2, 1, 2, 128>; };

// One row's partial of the selection over one tile of SEL_BN columns.
struct alignas(16) TilePart {
  float m;     // max of scaled over the tile's columns < V
  float s;     // sum of exp(scaled - m) over them
  float best;  // the best unmasked scaled value, -inf if none
  int idx;     // its column (the lower on ties), INT_MAX if none
};

template <typename T> struct LoopArgs {
  const T* annot;    // (B, L, D)
  const T* att_enc;  // (B, L, A)
  const T* w1;       // (H, N1)    [Wd | Wb | Whh (gates interleaved) | 0]
  const T* wx;       // (E + D, G) [Wie; Wiz], gates interleaved
  const T* wo;       // (H + D, Ep) [Wh; Wc]
  const float *wf, *bb, *bias;  // (A,), (D,), (G,) interleaved
  const T* emb;      // (V, E), capped
  const T* wout;     // (E, Vp), zero columns past V
  const float* bout; // (V,)
  T* xt;             // (E + D, Bp) [e; beta z], feature-major
  T* yt;             // (H + D, Bp) [h; z], feature-major
  float* c;          // (B, H)
  float* g1;         // (B, N1) phase-1 output
  float* part;       // (splits, B, Ep) phase-4 partial sums
  T* tt;             // (E, Bp) t, feature-major
  TilePart* vpart;   // (B, VT) the logits' tile partials
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
  int Vp, VT;           // Wout's padded width, vocabulary tiles
  float inv_sqrt_l, temperature;
  int start_i, end_i, pad_i, unk_i;
};

// -- the eight phase kernels -------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(NT, 2) greedy_loop_hside(LoopArgs<T> a) {
  if (*a.done == a.B) return;
  hside_body<T>(a);
}

// The attention kernels take the scores' scratch sc (B, L) as an argument
// of their own, leaving LoopArgs, whose layout the other kernels' schedules
// are sensitive to (decode_phases.cuh), as it was.
template <typename T>
__global__ void __launch_bounds__(NT) greedy_loop_scores(LoopArgs<T> a, float* sc) {
  if (*a.done == a.B || a.fin[blockIdx.x]) return;
  scores_body<T>(a, 1, sc);
}

template <typename T>
__global__ void __launch_bounds__(ATT_SLICE, 8) greedy_loop_attend(LoopArgs<T> a, const float* sc,
                                                                int t) {
  if (*a.done == a.B || a.fin[blockIdx.x]) return;
  attend_body<T>(a, 1, sc, a.alphas + (size_t)t * a.L, (size_t)(a.S + 1) * a.L, nullptr);
}

template <typename T>
__global__ void __launch_bounds__(NT, 2) greedy_loop_gates(LoopArgs<T> a) {
  if (*a.done == a.B) return;
  gates_body<T, float>(a, a.c, a.c, nullptr);
}

template <typename T>
__global__ void __launch_bounds__(NT, 2) greedy_loop_deepout(LoopArgs<T> a) {
  if (*a.done == a.B) return;
  deepout_body<T>(a);
}

// 5. t = phase 4's K slices summed in slice order, then tanh(e + .) with deep
// output, rounded to T and written feature-major into tt, the row tile of the
// vocabulary product; one thread per element.  tt's padding columns stay zero.
template <typename T>
__global__ void __launch_bounds__(NT) greedy_loop_tproj(LoopArgs<T> a) {
  if (*a.done == a.B) return;
  const int i = blockIdx.x * NT + threadIdx.x;
  if (i >= a.B * a.E) return;
  const int row = i / a.E, j = i % a.E;
  float v = 0.f;
  for (int p = 0; p < a.splits; ++p) v += a.part[((size_t)p * a.B + row) * a.Ep + j];
  if (a.deep) v = tanhf(to_f(a.xt[(size_t)j * a.Bp + row]) + v);
  a.tt[(size_t)j * a.Bp + row] = from_f<T>(v);
}

// 6. The logits of a tile of 64 rows by SEL_BN vocabulary columns, t Wout as
// a tiled product (K = E), and per row the tile's partial of the selection:
// over its columns v < V, scaled = (logit + bout) / temperature, their max
// m, sum exp(scaled - m), and the best unmasked value with its index (the
// lower index on ties).  TPR threads share a row, CPT columns each; the
// logits stay in registers.
template <typename T>
__global__ void __launch_bounds__(NT, 2) greedy_loop_logits(LoopArgs<T> a, int t) {
  if (*a.done == a.B) return;
  constexpr int TPR = NT / BM, CPT = SEL_BN / TPR;
  static_assert(CPT % 4 == 0, "a thread takes whole float4 columns of the tile");
  auto& s = tiles<typename LogitsTile<T>::type>();
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * SEL_BN;
  gemm_tile(s, a.tt, a.Bp, a.wout, a.Vp, m0, n0, 0, a.E);
  const int m = threadIdx.x / TPR, c0 = n0 + (threadIdx.x % TPR) * CPT;
  float sc[CPT];
  float mx = -INFINITY, best = -INFINITY;
  int bi = INT_MAX;
#pragma unroll
  for (int c = 0; c < CPT; c += 4) {
    const float4 v4 = tile_sum4(s, m, c0 - n0 + c);
    const float x4[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int col = c0 + c + u;
      sc[c + u] = col < a.V ? (x4[u] + a.bout[col]) / a.temperature : -INFINITY;
      if (col >= a.V) continue;
      mx = fmaxf(mx, sc[c + u]);
      const bool masked = col == a.start_i || col == a.pad_i ||
                          (t == 0 && (col == a.end_i || col == a.unk_i));
      if (!masked && (sc[c + u] > best || (sc[c + u] == best && col < bi))) {
        best = sc[c + u];
        bi = col;
      }
    }
  }
  // the row's TPR threads are adjacent lanes: reduce over them in a fixed order
#pragma unroll
  for (int o = 1; o < TPR; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
  float se = 0.f;
#pragma unroll
  for (int c = 0; c < CPT; ++c)
    if (c0 + c < a.V) se += expf(sc[c] - mx);
#pragma unroll
  for (int o = 1; o < TPR; o <<= 1) {
    se += __shfl_xor_sync(FULL, se, o);
    const float ob = __shfl_xor_sync(FULL, best, o);
    const int oi = __shfl_xor_sync(FULL, bi, o);
    if (ob > best || (ob == best && oi < bi)) {
      best = ob;
      bi = oi;
    }
  }
  if (c0 == n0 && m0 + m < a.B)
    a.vpart[(size_t)(m0 + m) * a.VT + blockIdx.x] = TilePart{mx, se, best, bi};
}

// 7. One warp per unfinished row: the row's VT tile partials combined, M =
// max m_j, S = sum s_j exp(m_j - M), the best value (lower index on ties);
// lane l takes tiles l, l + 32, ... in order and the lanes combine in a
// fixed butterfly, so two runs agree bit for bit.  Then the token's
// log-probability scaled[tok] - (log S + M), the bookkeeping, and the next
// token's embedding into xt.
template <typename T>
__global__ void __launch_bounds__(NT) greedy_loop_select(LoopArgs<T> a, int t) {
  const int lane = threadIdx.x & 31, row = blockIdx.x * NWARPS + (threadIdx.x >> 5);
  if (*a.done == a.B || row >= a.B || a.fin[row]) return;
  const TilePart* p = a.vpart + (size_t)row * a.VT;
  float mx = -INFINITY;
  for (int j = lane; j < a.VT; j += 32) mx = fmaxf(mx, p[j].m);
  mx = warp_max(mx);
  float se = 0.f, best = -INFINITY;
  int bi = INT_MAX;
  for (int j = lane; j < a.VT; j += 32) {
    const TilePart q = p[j];
    se += q.s * expf(q.m - mx);
    if (q.best > best || (q.best == best && q.idx < bi)) {
      best = q.best;
      bi = q.idx;
    }
  }
  se = warp_sum(se);
  for (int o = 16; o > 0; o >>= 1) {
    const float ob = __shfl_xor_sync(FULL, best, o);
    const int oi = __shfl_xor_sync(FULL, bi, o);
    if (ob > best || (ob == best && oi < bi)) {
      best = ob;
      bi = oi;
    }
  }
  // bi >= V only when every unmasked logit is NaN; S is NaN then, and so the score
  if (bi >= a.V) bi = 0;
  if (lane == 0) {
    a.scores[row] += best - (logf(se) + mx);
    a.tokens[(size_t)row * (a.S + 2) + t + 1] = bi;
    if (bi == a.end_i) {
      a.fin[row] = 1;
      a.flen[row] = t;
      atomicAdd(a.done, 1);
    }
  }
  for (int j = lane; j < a.E; j += 32)
    a.xt[(size_t)j * a.Bp + row] = a.emb[(size_t)bi * a.E + j];
}

// -- host side ---------------------------------------------------------------------

constexpr int NPHASES = 8;

inline int vocab_tiles(int V) { return (V + SEL_BN - 1) / SEL_BN; }

// Each phase's grid (x, y, z), threads, dynamic and static shared memory bytes,
// in launch order.
template <typename T>
void plan(int B, int L, int D, int E, int V, int N1, int G, int Ep, int splits,
          int (&p)[NPHASES][6]) {
  int p5[5][6];
  plan5<T>(B, 1, L, D, N1, G, Ep, splits, p5);
  const int rt = (B + BM - 1) / BM;
  const int sel[3][6] = {
      {(B * E + NT - 1) / NT, 1, 1, NT, 0, 0},
      {vocab_tiles(V), rt, 1, NT, (int)sizeof(typename LogitsTile<T>::type), 0},
      {(B + NWARPS - 1) / NWARPS, 1, 1, NT, 0, 0}};
  for (int j = 0; j < 6; ++j) {
    for (int i = 0; i < 5; ++i) p[i][j] = p5[i][j];
    for (int i = 0; i < 3; ++i) p[5 + i][j] = sel[i][j];
  }
}

template <typename T>
cudaError_t run(const LoopArgs<T>& a, float* sc, cudaStream_t st) {
  static int allowed[5][MAX_DEVICES];  // per type: see allow_smem
  int p[NPHASES][6];
  plan<T>(a.B, a.L, a.D, a.E, a.V, a.N1, a.G, a.Ep, a.splits, p);
  cudaError_t err = allow_smem(greedy_loop_hside<T>, p[0][4], allowed[0]);
  if (err == cudaSuccess) err = allow_smem(greedy_loop_attend<T>, p[2][4], allowed[1]);
  if (err == cudaSuccess) err = allow_smem(greedy_loop_gates<T>, p[3][4], allowed[2]);
  if (err == cudaSuccess) err = allow_smem(greedy_loop_deepout<T>, p[4][4], allowed[3]);
  if (err == cudaSuccess) err = allow_smem(greedy_loop_logits<T>, p[6][4], allowed[4]);
  if (err != cudaSuccess) return err;
  for (int t = 0; t <= a.S; ++t) {
    greedy_loop_hside<T><<<grid(p[0]), p[0][3], p[0][4], st>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    greedy_loop_scores<T><<<grid(p[1]), p[1][3], p[1][4], st>>>(a, sc);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    greedy_loop_attend<T><<<grid(p[2]), p[2][3], p[2][4], st>>>(a, sc, t);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    greedy_loop_gates<T><<<grid(p[3]), p[3][3], p[3][4], st>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    greedy_loop_deepout<T><<<grid(p[4]), p[4][3], p[4][4], st>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    greedy_loop_tproj<T><<<grid(p[5]), p[5][3], p[5][4], st>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    greedy_loop_logits<T><<<grid(p[6]), p[6][3], p[6][4], st>>>(a, t);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    greedy_loop_select<T><<<grid(p[7]), p[7][3], p[7][4], st>>>(a, t);
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
  a.tt = static_cast<T*>(st[5]);
  a.vpart = static_cast<TilePart*>(st[6]);
  a.done = static_cast<int*>(st[7]);
  float* sc = static_cast<float*>(st[8]);
  a.tokens = static_cast<int*>(out[0]);
  a.alphas = static_cast<float*>(out[1]);
  a.scores = static_cast<float*>(out[2]);
  a.flen = static_cast<int*>(out[3]);
  a.fin = static_cast<unsigned char*>(out[4]);
  a.B = n[0]; a.Bp = n[1]; a.L = n[2]; a.D = n[3]; a.A = n[4]; a.H = n[5]; a.E = n[6];
  a.V = n[7]; a.S = n[8]; a.N1 = n[9]; a.G = n[10]; a.Ep = n[11]; a.K4 = n[12];
  a.kc = n[13]; a.splits = n[14]; a.deep = n[15];
  a.Vp = (a.V + 7) & ~7;  // pad8, as the wrapper packs Wout
  a.VT = n[16];
  if (a.VT != vocab_tiles(a.V)) return cudaErrorInvalidValue;
  a.inv_sqrt_l = (float)pow((double)a.L, -0.5);  // as Python's float(L) ** -0.5
  a.temperature = temperature;
  a.start_i = special[0]; a.end_i = special[1]; a.pad_i = special[2]; a.unk_i = special[3];
  return run<T>(a, sc, stream);
}

}  // namespace sat

// dtype: 0 = float32, 1 = bfloat16.  Inputs: annot, att_enc, then the packed
// weights of kernels/decoder_step.py::LoopWeights (w1, wx, wo, wf, bb, bias),
// emb, wout (E, pad8(V)) and bout.  State (written): xt, yt, c, g1, part, tt
// (E, Bp) in the input type with zero padding columns, vpart (B, VT) of
// 16-byte tile partials, done (zeroed), sc (B, L) float32 attention scores.
// Outputs: tokens (B, S+2) int32 pre-filled with START and PADs, alphas (B,
// S+1, L) float32 zeroed, scores (B,) float32 zeroed, flen (B,) int32, fin
// (B,) bool, both zeroed.  Sizes B,
// Bp, L, D, A, H, E, V, S, N1, G, Ep, K4, kc, splits, deep, VT (the
// vocabulary tiles, ceil(V / 16); another value is refused).  Launches 8
// (S+1) kernels on the stream and returns the first cudaError_t.
extern "C" int sat_greedy_loop(int dtype, const void* annot, const void* att_enc,
                               const void* w1, const void* wx, const void* wo, const void* wf,
                               const void* bb, const void* bias, const void* emb,
                               const void* wout, const void* bout, void* xt, void* yt, void* c,
                               void* g1, void* part, void* tt, void* vpart, void* done,
                               void* sc, void* tokens, void* alphas, void* scores, void* flen, void* fin,
                               int B, int Bp, int L, int D, int A, int H, int E, int V, int S,
                               int N1, int G, int Ep, int K4, int kc, int splits, int deep,
                               int VT, float temperature, int start_i, int end_i, int pad_i,
                               int unk_i, void* stream) {
  const void* in[11] = {annot, att_enc, w1, wx, wo, wf, bb, bias, emb, wout, bout};
  void* st[9] = {xt, yt, c, g1, part, tt, vpart, done, sc};
  void* out[5] = {tokens, alphas, scores, flen, fin};
  const int n[17] = {B, Bp, L, D, A, H, E, V, S, N1, G, Ep, K4, kc, splits, deep, VT};
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
  int p[sat::NPHASES][6];
  if (dtype == 0)
    sat::plan<float>(B, L, D, E, V, N1, G, Ep, splits, p);
  else if (dtype == 1)
    sat::plan<__nv_bfloat16>(B, L, D, E, V, N1, G, Ep, splits, p);
  else
    return cudaErrorInvalidValue;
  for (int i = 0; i < sat::NPHASES; ++i)
    for (int j = 0; j < 6; ++j) out[6 * i + j] = p[i][j];
  return cudaSuccess;
}

// The tiles of the loop's products (hside, gates, deepout, logits) for
// dtype: out[5 i + j] as sat_decoder_step_tiles gives them.
extern "C" int sat_greedy_loop_tiles(int dtype, int* out) {
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  if (dtype == 0) {
    sat::tile_design<sat::Products<float>::hside>(out);
    sat::tile_design<sat::Products<float>::gates>(out + 5);
    sat::tile_design<sat::Products<float>::deepout>(out + 10);
    sat::tile_design<sat::LogitsTile<float>::type>(out + 15);
  } else {
    sat::tile_design<sat::Products<__nv_bfloat16>::hside>(out);
    sat::tile_design<sat::Products<__nv_bfloat16>::gates>(out + 5);
    sat::tile_design<sat::Products<__nv_bfloat16>::deepout>(out + 10);
    sat::tile_design<sat::LogitsTile<__nv_bfloat16>::type>(out + 15);
  }
  return cudaSuccess;
}
