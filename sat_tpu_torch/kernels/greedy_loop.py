"""The whole greedy decode as batch-wide CUDA phase kernels, ``csrc/greedy_loop.cu``.

Replaces the Pallas kernel ``sat_tpu/kernels/greedy_loop.py::_loop_kernel``
(driven by ``greedy_loop_decode``, gated by ``greedy_loop_supported``).  The
semantics are those of the XLA scan, ``sat_tpu/decode/beam.py::greedy_decode``
with ``fused=False``, which differs from the Pallas kernel in two places:

* a finished row's attention weights are zero on every later step (the
  Pallas kernel keeps writing them);
* ``embed_norm`` caps the embedding rows, for the lookup and for the tied
  output projection (the Pallas kernel skips the cap).  The wrapper caps the
  whole table once and the kernels use the capped table for both.

Dropped TPU artifacts: the 8-row sublane padding, the one-hot embedding
matmul (the select phase loads the row), the time-major output layout and
the 13 MB VMEM gate.

Design: one decode step for all B rows is five kernels (attention-side
product, attention, gate product with the LSTM cell, deep-output product,
selection), launched 5 (S+1) times on the current stream by one C call.  The
first four are the phases the fused step runs too (``csrc/decode_phases.cuh``):
the three products are tiled over 64 rows, so each weight is read once per
step per tile of 64 rows.  The kernel boundaries stand in for grid-wide
barriers, and a device count of finished rows makes every later kernel
return at once when the whole batch has finished.
``decoder_step.pack_loop_weights`` fixes the layout the kernels index.

``greedy_loop_decode`` launches the kernels for CUDA tensors and runs
``greedy_loop_plain``, the same function in PyTorch, for CPU tensors.  It
raises on anything the kernels do not take; it never falls back."""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..config import SATConfig
from ..models.decoder import capped_embedding
from . import _build
from .decoder_step import (DEEPOUT_SPLITS, MAX_SMEM, _DTYPES, FusedWeights,
                           LoopWeights, _check, _check_shapes,
                           attend_smem_bytes, check_loop_weights, deepout_rows,
                           pad8, ptrs, step_math, step_weights, stream_ptr,
                           unpack_loop_weights)

# wrapper calls that launched the kernels, since import (read and reset by
# chip_smoke.py)
launches = 0

NEG_INF = -1e9
PHASES = ("hside", "attend", "gates", "deepout", "select")
_THREADS = 256         # NT in csrc/decode_common.cuh


def _pad4(n: int) -> int:
    return (n + 3) // 4 * 4


def select_smem_bytes(E: int, V: int, itemsize: int = 4) -> int:
    """Dynamic shared memory of a select block: t, the logits and the
    vocabulary product's split-K scratch (csrc/greedy_loop.cu::plan)."""
    return 4 * (_pad4(E) + _pad4(V) + _THREADS * (16 // itemsize))


def _fits(L: int, E: int, V: int, itemsize: int) -> bool:
    return (attend_smem_bytes(L) <= MAX_SMEM
            and select_smem_bytes(E, V, itemsize) <= MAX_SMEM)


def greedy_loop_supported(cfg: SATConfig, L: int, itemsize: int = 4) -> bool:
    """One LSTM layer, and the per-row shared memory of the attend (L scores)
    and select (V + E floats and scratch) phases fits a block."""
    return cfg.decoder_layers == 1 and _fits(L, cfg.embed_dim, cfg.vocab_size,
                                             itemsize)


def _special(cfg: SATConfig) -> Tuple[int, int, int, int]:
    s = cfg.vocab_stoi
    return (int(s["<START>"]), int(s["<END>"]), int(s["<PAD>"]),
            int(s["<UNK>"]))


def greedy_scan(step, embed, cfg: SATConfig, h, c, L: int, *,
                max_gen_length: int, temperature: float = 1.0,
                early_exit: bool = False, all_finished=None):
    """The greedy selection loop, step by step, with the XLA scan's semantics
    (the kernels', and that of greedy_decode's plain and step-kernel paths).

    ``step(prev_embed, h, c) -> (logits (B, V), h', c', alpha (B, L))`` and
    ``embed(tokens (B,) int64) -> (B, E)``; h and c have the batch on their
    second-to-last dim.  Masks: START and PAD always, END and UNK at step 0.
    The token's log-prob is scaled[tok] - logsumexp(scaled) over the unmasked
    row; argmax ties go to the lower index.  Finished rows append PAD, keep
    their score and get zero alphas.  ``early_exit`` stops once every row has
    finished (one host sync per step on the card; ``all_finished(finished)``
    decides where given, as on a mesh of ranks); the outputs are the same.
    Returns (tokens (B, S+2) int32, alphas (B, S+1, L) float32,
    scores (B,) float32, flen (B,) int32, finished (B,) bool)."""
    b, dev, S = h.shape[-2], h.device, max_gen_length
    start_i, end_i, pad_i, unk_i = _special(cfg)
    always = torch.zeros(cfg.vocab_size, device=dev)
    always[[start_i, pad_i]] = NEG_INF
    step0 = always.clone()
    step0[[end_i, unk_i]] = NEG_INF

    tokens = torch.full((b, S + 2), pad_i, dtype=torch.int32, device=dev)
    tokens[:, 0] = start_i
    alphas = torch.zeros(b, S + 1, L, device=dev)
    scores = torch.zeros(b, device=dev)
    flen = torch.zeros(b, dtype=torch.int32, device=dev)
    finished = torch.zeros(b, dtype=torch.bool, device=dev)
    for t in range(S + 1):
        logits, h, c, alpha = step(embed(tokens[:, t].long()), h, c)
        # argmax + logsumexp: Z includes the masked tokens, the choice excludes them
        scaled = logits.float() / temperature
        token = torch.argmax(scaled + (step0 if t == 0 else always), dim=-1)
        tok_logp = (scaled.gather(1, token[:, None])[:, 0]
                    - torch.logsumexp(scaled, dim=-1))
        token = torch.where(finished, pad_i, token)
        scores = torch.where(finished, scores, scores + tok_logp)
        alphas[:, t] = torch.where(finished[:, None], 0.0, alpha.float())
        newly = ~finished & (token == end_i)
        flen = torch.where(newly, t, flen)
        finished = finished | newly
        tokens[:, t + 1] = token.to(torch.int32)
        if early_exit and (all_finished(finished) if all_finished
                           else bool(finished.all())):
            break
    return tokens, alphas, scores, flen, finished


def loop_weights(params, cfg: SATConfig, dtype: torch.dtype):
    """(LoopWeights, capped embedding table (V, E), Wout (E, V), bout (V,)
    f32), all in ``dtype`` apart from the float32 vectors."""
    lw = step_weights(params, cfg, dtype)
    emb = capped_embedding(params, cfg)
    if cfg.weight_tying and cfg.deep_output:
        wout = emb.T
        bout = torch.zeros(cfg.vocab_size, device=emb.device)
    else:
        wout = params.out_proj.w
        bout = (params.out_proj.b.float() if "b" in params.out_proj
                else torch.zeros(cfg.vocab_size, device=emb.device))
    return (lw, emb.to(dtype).contiguous(), wout.to(dtype).contiguous(),
            bout.float().contiguous())


def greedy_loop_plain(fw: LoopWeights, emb: torch.Tensor, wout: torch.Tensor,
                      bout: torch.Tensor, cfg: SATConfig,
                      annotations: torch.Tensor, att_enc: torch.Tensor,
                      h0: torch.Tensor, c0: torch.Tensor, *,
                      max_gen_length: int, temperature: float = 1.0):
    """The kernels' function in PyTorch: ``greedy_scan`` over the kernels'
    step (values rounded to the input type where the kernels round them),
    stopping once every row has finished, as the kernels do."""
    dt = annotations.dtype
    w = FusedWeights(*(x.float() for x in unpack_loop_weights(fw)))
    wout_f = wout.float()

    def step(e, h, c):
        t, h, c, _, alpha = step_math(w, cfg.deep_output, dt, e, h, c,
                                      annotations, att_enc)
        return t.to(dt).float() @ wout_f + bout, h, c, alpha

    return greedy_scan(step, lambda tok: emb[tok], cfg, h0, c0,
                       annotations.shape[1], max_gen_length=max_gen_length,
                       temperature=temperature, early_exit=True)


def greedy_loop_decode(params, cfg: SATConfig, annotations: torch.Tensor,
                       att_enc: torch.Tensor, h0: torch.Tensor,
                       c0: torch.Tensor, *, max_gen_length: int,
                       temperature: float = 1.0):
    """Run the whole greedy loop in one C call.

    annotations (B, L, D); att_enc (B, L, A); h0/c0 (B, H), one layer.
    Returns (tokens (B, S+2) int32, alphas (B, S+1, L) float32,
    scores (B,) float32, flen (B,) int32, finished (B,) bool)."""
    return greedy_loop(*loop_weights(params, cfg, annotations.dtype), cfg,
                       annotations, att_enc, h0, c0,
                       max_gen_length=max_gen_length, temperature=temperature)


def loop_plan(B: int, L: int, D: int, A: int, H: int, E: int, V: int,
              dtype: torch.dtype = torch.float32):
    """The launch plan of one step, as the C side computes it: for each phase
    of ``PHASES``, (grid (x, y, z), threads, dynamic and static shared memory
    bytes).  Needs the built library."""
    lib = _build.load("greedy_loop")
    out = (ctypes.c_int * 30)()
    _build.check(lib, lib.sat_greedy_loop_plan(
        _DTYPES[dtype], B, L, D, E, V, pad8(A + D + 4 * H), pad8(4 * H),
        pad8(E), DEEPOUT_SPLITS, out), "greedy_loop plan")
    return {name: (tuple(out[6 * i:6 * i + 3]), out[6 * i + 3],
                   out[6 * i + 4], out[6 * i + 5])
            for i, name in enumerate(PHASES)}


def greedy_loop(fw: LoopWeights, emb: torch.Tensor, wout: torch.Tensor,
                bout: torch.Tensor, cfg: SATConfig, annotations: torch.Tensor,
                att_enc: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor, *,
                max_gen_length: int, temperature: float = 1.0):
    """``greedy_loop_decode`` on weights already in the kernels' layout
    (``loop_weights``): the kernels for CUDA tensors, ``greedy_loop_plain``
    for CPU tensors."""
    global launches
    dev = annotations.device
    if dev.type == "cpu":
        return greedy_loop_plain(fw, emb, wout, bout, cfg, annotations,
                                 att_enc, h0, c0, max_gen_length=max_gen_length,
                                 temperature=temperature)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    out = run_loop(fw, emb, wout, bout, cfg, annotations, att_enc, h0, c0,
                   max_gen_length, temperature,
                   torch.zeros(1, dtype=torch.int32, device=dev))
    launches += 1
    return out


def run_loop(lw: LoopWeights, emb, wout, bout, cfg: SATConfig, annotations,
             att_enc, h0, c0, max_gen_length: int, temperature: float,
             done: torch.Tensor):
    """Check the inputs, allocate the batch state and make the C call.
    ``done`` (1,) int32 is the device count of finished rows; every kernel
    returns at once while it equals B (``greedy_loop`` passes a zero)."""
    dt, dev = annotations.dtype, annotations.device
    b, L, D = annotations.shape
    H, A, E, V, S = h0.shape[-1], att_enc.shape[-1], emb.shape[1], emb.shape[0], max_gen_length
    _check(dict(annotations=annotations, att_enc=att_enc, h0=h0, c0=c0,
                emb=emb, wout=wout), dt, dev)
    _check(dict(bout=bout), torch.float32, dev)
    _check_shapes(dict(att_enc=(att_enc.shape, (b, L, A)), h0=(h0.shape, (b, H)),
                       c0=(c0.shape, (b, H)), wout=(wout.shape, (E, V)),
                       bout=(bout.shape, (V,)), done=(done.shape, (1,))))
    check_loop_weights(lw, D, A, H, E, dt, dev)
    if not _fits(L, E, V, annotations.element_size()):
        raise ValueError("greedy loop: a row's state exceeds shared memory")
    start_i, end_i, pad_i, unk_i = _special(cfg)
    n1, G, Ep = lw.w1.shape[1], lw.wx.shape[1], lw.wo.shape[1]
    K4, kc = deepout_rows(H, D, cfg.deep_output)
    bp = pad8(b)

    # feature-major activations, padding columns zero: xt = [e; beta z],
    # yt = [h; z]; c and the products' outputs in float32
    xt = torch.zeros(E + D, bp, dtype=dt, device=dev)
    xt[:E, :b] = emb[start_i][:, None]
    yt = torch.zeros(H + D, bp, dtype=dt, device=dev)
    yt[:H, :b] = h0.T
    c = c0.to(torch.float32, copy=True)
    g1 = torch.empty(b, n1, dtype=torch.float32, device=dev)
    part = torch.empty(DEEPOUT_SPLITS, b, Ep, dtype=torch.float32, device=dev)

    tokens = torch.full((b, S + 2), pad_i, dtype=torch.int32, device=dev)
    tokens[:, 0] = start_i
    alphas = torch.zeros(b, S + 1, L, dtype=torch.float32, device=dev)
    scores = torch.zeros(b, dtype=torch.float32, device=dev)
    flen = torch.zeros(b, dtype=torch.int32, device=dev)
    finished = torch.zeros(b, dtype=torch.bool, device=dev)
    lib = _build.load("greedy_loop")
    with torch.cuda.device(dev):
        err = lib.sat_greedy_loop(
            _DTYPES[dt], *ptrs(annotations, att_enc, lw.w1, lw.wx, lw.wo, lw.wf,
                               lw.bb, lw.bias, emb, wout, bout, xt, yt, c, g1,
                               part, done, tokens, alphas, scores, flen, finished),
            b, bp, L, D, A, H, E, V, S, n1, G, Ep, K4, kc, DEEPOUT_SPLITS,
            int(cfg.deep_output), float(temperature), start_i, end_i, pad_i,
            unk_i, stream_ptr(dev))
    _build.check(lib, err, "greedy_loop kernels")
    return tokens, alphas, scores, flen, finished
