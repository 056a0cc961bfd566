// One fused decode step without the vocabulary projection: the CUDA
// counterpart of sat_tpu/kernels/decoder_step.py::_kernel (fused_decoder_step).
//
//   att_dec = h Wd;  alpha = softmax_L(tanh(att_enc + att_dec) wf / sqrt(L))
//   z = sum_L alpha annot;  beta = sigmoid(h Wb + bb)
//   gates = e Wie + (beta z) Wiz + h Whh + b  (i, f, g, o) -> h', c'
//   t = tanh(e + h' Wh + z Wc), or h' Wh without deep output
//
// Outputs t, h', c', z in the input type and alpha (N, L) in float.  c is
// read in the input type and c' rounded to it, as the JAX kernel does.  The
// N rows may share images k to one (a beam's slots): row r attends over
// image r / k of annotations (N / k, L, D) and att_enc (N / k, L, A); k = 1
// is one image per row.
//
// Design.  The step is the four batch-wide phases of decode_phases.cuh (whose
// comment gives what bounds them and how), between a prologue and an
// epilogue, seven kernels launched in order on the caller's stream by
// sat_decoder_step:
//   decoder_step_in       e, h -> the feature-major xt, yt; zero padding columns
//   decoder_step_hside    phase 1
//   decoder_step_scores   phase 2, the scores
//   decoder_step_attend   phase 2, the rest; alpha and z row-major
//   decoder_step_gates    phase 3; c' and h' row-major
//   decoder_step_deepout  phase 4
//   decoder_step_out      t: phase 4's K slices summed in slice order, tanh(e + .)
// Each weight is read once per step per tile of 64 rows, not once per row,
// and each image's annotations once per step, not once per row.
#include "decode_phases.cuh"

namespace sat {

template <typename T> struct StepArgs {
  const T* annot;    // (B / k, L, D)
  const T* att_enc;  // (B / k, L, A)
  const T* w1;       // (H, N1)    [Wd | Wb | Whh (gates interleaved) | 0]
  const T* wx;       // (E + D, G) [Wie; Wiz], gates interleaved
  const T* wo;       // (H + D, Ep) [Wh; Wc]
  const float *wf, *bb, *bias;  // (A,), (D,), (G,) interleaved
  const T *embed, *h, *c;       // (B, E), (B, H), (B, H)
  T* xt;             // (E + D, Bp) [e; beta z], feature-major
  T* yt;             // (H + D, Bp) [h; z], feature-major
  float* g1;         // (B, N1) phase-1 output
  float* part;       // (splits, B, Ep) phase-4 partial sums
  float* sc;         // (B, L) attention scores
  T *t_out, *h_out, *c_out, *z_out;  // (B, E), (B, H), (B, H), (B, D)
  float* alpha_out;                  // (B, L)
  int B, Bp, L, D, A, H, E;
  int N1, G, Ep;        // padded widths of w1, wx, wo
  int K4, kc, splits;   // phase 4: K, K rows per split, splits
  int deep;
  int k;                // rows per image
  float inv_sqrt_l;
};

constexpr int TT = 32;  // rows and features of a transpose tile in decoder_step_in

// Writes e (B, E) and h (B, H) transposed into xt[0:E] and yt[0:H], one tile
// of 32 features (of the E + H) by 32 rows per block, and zeroes the padding
// columns [B, Bp) of every row of xt and yt: the products read Bp columns.
template <typename T>
__global__ void __launch_bounds__(NT) decoder_step_in(StepArgs<T> a) {
  __shared__ float tile[TT][TT + 1];
  const int E = a.E, H = a.H, B = a.B, Bp = a.Bp;
  const int tx = threadIdx.x % TT, ty = threadIdx.x / TT;
  const int f0 = blockIdx.x * TT, r0 = blockIdx.y * TT;
  for (int i = ty; i < TT; i += NT / TT) {
    const int r = r0 + i, f = f0 + tx;
    float v = 0.f;
    if (r < B && f < E + H)
      v = f < E ? to_f(a.embed[(size_t)r * E + f]) : to_f(a.h[(size_t)r * H + f - E]);
    tile[i][tx] = v;
  }
  __syncthreads();
  for (int i = ty; i < TT; i += NT / TT) {
    const int f = f0 + i, r = r0 + tx;
    if (f < E + H && r < B)
      (f < E ? a.xt + (size_t)f * Bp : a.yt + (size_t)(f - E) * Bp)[r] =
          from_f<T>(tile[tx][i]);
  }
  const int pad = Bp - B, nx = E + a.D, rows = nx + H + a.D;
  const int nb = gridDim.x * gridDim.y, b = blockIdx.y * gridDim.x + blockIdx.x;
  for (int i = b * NT + threadIdx.x; i < rows * pad; i += nb * NT) {
    const int k = i / pad, m = B + i % pad;
    (k < nx ? a.xt + (size_t)k * Bp : a.yt + (size_t)(k - nx) * Bp)[m] = from_f<T>(0.f);
  }
}

template <typename T>
__global__ void __launch_bounds__(NT, 2) decoder_step_hside(StepArgs<T> a) {
  hside_body<T>(a);
}

template <typename T>
__global__ void __launch_bounds__(NT) decoder_step_scores(StepArgs<T> a) {
  scores_body<T>(a, a.k, a.sc);
}

template <typename T>
__global__ void __launch_bounds__(ATT_SLICE, 8) decoder_step_attend(StepArgs<T> a) {
  attend_body<T>(a, a.k, a.sc, a.alpha_out, a.L, a.z_out);
}

template <typename T>
__global__ void __launch_bounds__(NT, 2) decoder_step_gates(StepArgs<T> a) {
  gates_body<T, T>(a, a.c, a.c_out, a.h_out);
}

template <typename T>
__global__ void __launch_bounds__(NT, 2) decoder_step_deepout(StepArgs<T> a) {
  deepout_body<T>(a);
}

// t[r][j] = the sum of phase 4's K slices in slice order, then tanh(e + .)
// with deep output, rounded to T; one thread per element.
template <typename T>
__global__ void __launch_bounds__(NT) decoder_step_out(StepArgs<T> a) {
  const int i = blockIdx.x * NT + threadIdx.x;
  if (i >= a.B * a.E) return;
  const int r = i / a.E, j = i % a.E;
  float v = 0.f;
  for (int p = 0; p < a.splits; ++p) v += a.part[((size_t)p * a.B + r) * a.Ep + j];
  if (a.deep) v = tanhf(to_f(a.embed[i]) + v);
  a.t_out[i] = from_f<T>(v);
}

// -- host side ---------------------------------------------------------------------

constexpr int NKERNELS = 7;

// Each kernel's grid (x, y, z), threads, dynamic and static shared memory
// bytes, in launch order: in, hside, scores, attend, gates, deepout, out.
template <typename T>
void plan(int B, int k, int L, int D, int H, int E, int N1, int G, int Ep, int splits,
          int (&p)[NKERNELS][6]) {
  int p5[5][6];
  plan5<T>(B, k, L, D, N1, G, Ep, splits, p5);
  const int in[6] = {(E + H + TT - 1) / TT, (B + TT - 1) / TT, 1, NT, 0,
                     (int)sizeof(float) * TT * (TT + 1)};
  const int out[6] = {(B * E + NT - 1) / NT, 1, 1, NT, 0, 0};
  for (int j = 0; j < 6; ++j) {
    p[0][j] = in[j];
    for (int i = 0; i < 5; ++i) p[i + 1][j] = p5[i][j];
    p[6][j] = out[j];
  }
}

template <typename T>
cudaError_t run(const StepArgs<T>& a, cudaStream_t st) {
  static int allowed[4][MAX_DEVICES];  // per type: see allow_smem
  int p[NKERNELS][6];
  plan<T>(a.B, a.k, a.L, a.D, a.H, a.E, a.N1, a.G, a.Ep, a.splits, p);
  cudaError_t err = allow_smem(decoder_step_hside<T>, p[1][4], allowed[0]);
  if (err == cudaSuccess) err = allow_smem(decoder_step_attend<T>, p[3][4], allowed[1]);
  if (err == cudaSuccess) err = allow_smem(decoder_step_gates<T>, p[4][4], allowed[2]);
  if (err == cudaSuccess) err = allow_smem(decoder_step_deepout<T>, p[5][4], allowed[3]);
  if (err != cudaSuccess) return err;
  decoder_step_in<T><<<grid(p[0]), p[0][3], p[0][4], st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  decoder_step_hside<T><<<grid(p[1]), p[1][3], p[1][4], st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  decoder_step_scores<T><<<grid(p[2]), p[2][3], p[2][4], st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  decoder_step_attend<T><<<grid(p[3]), p[3][3], p[3][4], st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  decoder_step_gates<T><<<grid(p[4]), p[4][3], p[4][4], st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  decoder_step_deepout<T><<<grid(p[5]), p[5][3], p[5][4], st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  decoder_step_out<T><<<grid(p[6]), p[6][3], p[6][4], st>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* const* in, void* const* st, void* const* out, const int* n,
                   cudaStream_t stream) {
  StepArgs<T> a;
  a.embed = static_cast<const T*>(in[0]);
  a.h = static_cast<const T*>(in[1]);
  a.c = static_cast<const T*>(in[2]);
  a.annot = static_cast<const T*>(in[3]);
  a.att_enc = static_cast<const T*>(in[4]);
  a.w1 = static_cast<const T*>(in[5]);
  a.wx = static_cast<const T*>(in[6]);
  a.wo = static_cast<const T*>(in[7]);
  a.wf = static_cast<const float*>(in[8]);
  a.bb = static_cast<const float*>(in[9]);
  a.bias = static_cast<const float*>(in[10]);
  a.xt = static_cast<T*>(st[0]);
  a.yt = static_cast<T*>(st[1]);
  a.g1 = static_cast<float*>(st[2]);
  a.part = static_cast<float*>(st[3]);
  a.sc = static_cast<float*>(st[4]);
  a.t_out = static_cast<T*>(out[0]);
  a.h_out = static_cast<T*>(out[1]);
  a.c_out = static_cast<T*>(out[2]);
  a.z_out = static_cast<T*>(out[3]);
  a.alpha_out = static_cast<float*>(out[4]);
  a.B = n[0]; a.Bp = n[1]; a.L = n[2]; a.D = n[3]; a.A = n[4]; a.H = n[5]; a.E = n[6];
  a.N1 = n[7]; a.G = n[8]; a.Ep = n[9]; a.K4 = n[10]; a.kc = n[11]; a.splits = n[12];
  a.deep = n[13];
  a.k = n[14];
  if (a.k <= 0 || a.B % a.k) return cudaErrorInvalidValue;
  a.inv_sqrt_l = (float)pow((double)a.L, -0.5);  // as Python's float(L) ** -0.5
  return run<T>(a, stream);
}

}  // namespace sat

// dtype: 0 = float32, 1 = bfloat16.  Inputs: embed, h, c, annot (B / k,
// L, D), att_enc (B / k, L, A), then the packed weights of
// kernels/decoder_step.py::LoopWeights (w1, wx, wo, wf, bb, bias).  Scratch
// (written): xt (E+D, Bp), yt (H+D, Bp) in the input type, g1 (B, N1), part
// (splits, B, Ep) and sc (B, L) float32.  Outputs: t, h', c', z, alpha.
// Sizes B, Bp, L, D, A, H, E, N1, G, Ep, K4, kc, splits, deep, k (rows per
// image, a divisor of B).  Launches 7 kernels on the stream and returns the
// first cudaError_t.
extern "C" int sat_decoder_step(int dtype, const void* embed, const void* h, const void* c,
                                const void* annot, const void* att_enc, const void* w1,
                                const void* wx, const void* wo, const void* wf, const void* bb,
                                const void* bias, void* xt, void* yt, void* g1, void* part,
                                void* sc, void* t_out, void* h_out, void* c_out, void* z_out,
                                void* alpha_out, int B, int Bp, int L, int D, int A, int H,
                                int E, int N1, int G, int Ep, int K4, int kc, int splits,
                                int deep, int k, void* stream) {
  const void* in[11] = {embed, h, c, annot, att_enc, w1, wx, wo, wf, bb, bias};
  void* st[5] = {xt, yt, g1, part, sc};
  void* out[5] = {t_out, h_out, c_out, z_out, alpha_out};
  const int n[15] = {B, Bp, L, D, A, H, E, N1, G, Ep, K4, kc, splits, deep, k};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0) return cudaSuccess;
  if (dtype == 0) return sat::launch<float>(in, st, out, n, s);
  if (dtype == 1) return sat::launch<__nv_bfloat16>(in, st, out, n, s);
  return cudaErrorInvalidValue;
}

// The launch plan of sat_decoder_step for these sizes (B rows, k to an
// image): out[6 i + j] is kernel i's grid x, y, z, threads, dynamic and
// static shared memory bytes.
extern "C" int sat_decoder_step_plan(int dtype, int B, int k, int L, int D, int H, int E,
                                     int N1, int G, int Ep, int splits, int* out) {
  int p[sat::NKERNELS][6];
  if (k <= 0 || B % k) return cudaErrorInvalidValue;
  if (dtype == 0)
    sat::plan<float>(B, k, L, D, H, E, N1, G, Ep, splits, p);
  else if (dtype == 1)
    sat::plan<__nv_bfloat16>(B, k, L, D, H, E, N1, G, Ep, splits, p);
  else
    return cudaErrorInvalidValue;
  for (int i = 0; i < sat::NKERNELS; ++i)
    for (int j = 0; j < 6; ++j) out[6 * i + j] = p[i][j];
  return cudaSuccess;
}

// The tiles of the step's products (hside, gates, deepout) for dtype: out[5
// i + j] is product i's columns, K rows per stage, stages, K groups, and 1
// where it runs on tensor cores.
extern "C" int sat_decoder_step_tiles(int dtype, int* out) {
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  if (dtype == 0) {
    sat::tile_design<sat::Products<float>::hside>(out);
    sat::tile_design<sat::Products<float>::gates>(out + 5);
    sat::tile_design<sat::Products<float>::deepout>(out + 10);
  } else {
    sat::tile_design<sat::Products<__nv_bfloat16>::hside>(out);
    sat::tile_design<sat::Products<__nv_bfloat16>::gates>(out + 5);
    sat::tile_design<sat::Products<__nv_bfloat16>::deepout>(out + 10);
  }
  return cudaSuccess;
}
