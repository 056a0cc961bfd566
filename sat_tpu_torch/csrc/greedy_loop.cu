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
// Design.  A step is five kernels over the whole batch, launched in order on
// one stream by sat_greedy_loop: greedy_loop_hside, _attend, _gates and
// _deepout run the four phases of decode_phases.cuh (whose comment gives
// their design and what bounds them), and
//   5. greedy_loop_select  t, logits, argmax, score, bookkeeping, next e
// The loop keeps c in float.  Phase 5 rounds t to T before Wout, sums phase
// 4's K slices in slice order and counts finished rows in one integer; every
// kernel of a later step returns at once when it equals B.
#include <limits.h>

#include "decode_phases.cuh"

namespace sat {

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

// -- the five phases ---------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(NT, 2) greedy_loop_hside(LoopArgs<T> a) {
  if (*a.done == a.B) return;
  hside_body<T>(a);
}

template <typename T>
__global__ void __launch_bounds__(ATT_SLICE) greedy_loop_attend(LoopArgs<T> a, int t) {
  const int row = blockIdx.x;
  if (*a.done == a.B || a.fin[row]) return;
  const float* alpha = attend_body<T>(a, row, nullptr);
  if (blockIdx.y == 0)
    for (int l = threadIdx.x; l < a.L; l += ATT_SLICE)
      a.alphas[((size_t)row * (a.S + 1) + t) * a.L + l] = alpha[l];
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
  int p4[4][6];
  plan4<T>(B, L, D, N1, G, Ep, splits, p4);
  const int sel = (int)(sizeof(float) * (pad4(E) + pad4(V) + (size_t)NT * Pack<T>::N));
  const int select[6] = {B, 1, 1, NT, sel, 0};
  for (int j = 0; j < 6; ++j) {
    for (int i = 0; i < 4; ++i) p[i][j] = p4[i][j];
    p[4][j] = select[j];
  }
}

template <typename T>
cudaError_t run(const LoopArgs<T>& a, cudaStream_t st) {
  static int allowed[5][MAX_DEVICES];  // per type: see allow_smem
  int p[5][6];
  plan<T>(a.B, a.L, a.D, a.E, a.V, a.N1, a.G, a.Ep, a.splits, p);
  cudaError_t err = allow_smem(greedy_loop_hside<T>, p[0][4], allowed[0]);
  if (err == cudaSuccess) err = allow_smem(greedy_loop_attend<T>, p[1][4], allowed[1]);
  if (err == cudaSuccess) err = allow_smem(greedy_loop_gates<T>, p[2][4], allowed[2]);
  if (err == cudaSuccess) err = allow_smem(greedy_loop_deepout<T>, p[3][4], allowed[3]);
  if (err == cudaSuccess) err = allow_smem(greedy_loop_select<T>, p[4][4], allowed[4]);
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
// weights of kernels/decoder_step.py::LoopWeights (w1, wx, wo, wf, bb, bias),
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
