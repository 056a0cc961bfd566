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
matmul (the select kernel loads the row), the time-major output layout and
the 13 MB VMEM gate.

Design: one decode step for all B rows is eight kernels (attention-side
product, attention scores, attention context, gate product with the LSTM
cell, deep-output product, then the selection as t, the vocabulary product
with per-tile partials of the selection, and their combine per row),
launched 8 (S+1) times on the current stream by one C call.  The first five
are the phases the fused step runs too (``csrc/decode_phases.cuh``, one
image to a row here); the three products there and the vocabulary product
are tiled over 64 rows, so each weight, Wout included, is read once per step
per tile of 64 rows, and each row's scores are computed once per step.  The
vocabulary product splits V into tiles of ``VOCAB_TILE`` columns; each (row,
tile) leaves one partial (the tile's max and sum of exponentials, its best
unmasked logit and index), and the select kernel combines a row's partials
in a fixed order (``tile_select`` is the same selection in PyTorch).
Nothing V-wide is held per row, so the vocabulary does not bound the
kernels.  The kernel
boundaries stand in for grid-wide barriers, and a device count of finished
rows makes every later kernel return at once when the whole batch has
finished.  ``decoder_step.pack_loop_weights`` and
``decoder_step.pack_vocab_weights`` fix the layouts the kernels index.

``greedy_loop_decode`` launches the kernels for CUDA tensors and runs
``greedy_loop_plain``, the same function in PyTorch, for CPU tensors.  It
raises on anything the kernels do not take; it never falls back."""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from ..config import SATConfig
from ..models.decoder import capped_embedding
from . import _build
from .decoder_step import (BF16_TILES, DEEPOUT_SPLITS, TILE_FIELDS, _DTYPES,
                           FusedWeights, LoopWeights, _check, _check_shapes,
                           check_loop_weights, deepout_rows,
                           fused_step_supported, pack_vocab_weights, pad8,
                           ptrs, step_math, step_weights, stream_ptr,
                           unpack_loop_weights, unpack_vocab_weights)

# wrapper calls that launched the kernels, since import (read and reset by
# chip_smoke.py)
launches = 0

NEG_INF = -1e9
PHASES = ("hside", "scores", "attend", "gates", "deepout", "tproj", "logits",
          "select")
VOCAB_TILE = 16        # SEL_BN in csrc/greedy_loop.cu: columns per logits block
# the loop's tiled products: the step's, then the vocabulary product
PRODUCTS = ("hside", "gates", "deepout", "logits")
# their bfloat16 tiles (``decoder_step.BF16_TILES``; ``LogitsTile`` in
# csrc/greedy_loop.cu)
BF16_TILES = dict(BF16_TILES, logits=dict(bn=VOCAB_TILE, bk=128, stages=2, groups=4,
                                          mma=1))


def vocab_tiles(V: int) -> int:
    """The logits kernel's column tiles: one partial per row and tile."""
    return -(-V // VOCAB_TILE)


def _special(cfg: SATConfig) -> Tuple[int, int, int, int]:
    s = cfg.vocab_stoi
    return (int(s["<START>"]), int(s["<END>"]), int(s["<PAD>"]),
            int(s["<UNK>"]))


def selection_masks(cfg: SATConfig, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tokens the choice excludes, (V,) bool: (at step 0, at later
    steps).  START and PAD always, END and UNK at step 0."""
    start_i, end_i, pad_i, unk_i = _special(cfg)
    later = torch.zeros(cfg.vocab_size, dtype=torch.bool, device=device)
    later[[start_i, pad_i]] = True
    step0 = later.clone()
    step0[[end_i, unk_i]] = True
    return step0, later


def scan_select(logits: torch.Tensor, temperature: float,
                masked: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``greedy_scan``'s selection from ``logits`` (B, V): the argmax of
    scaled = logits / temperature with NEG_INF added where ``masked`` (ties
    to the lower index), and its log-probability scaled[token] -
    logsumexp(scaled), whose Z includes the masked tokens.  Returns (token
    (B,) int64, log-probability (B,) float32)."""
    scaled = logits.float() / temperature
    token = torch.argmax(scaled + torch.where(masked, NEG_INF, 0.0), dim=-1)
    return token, (scaled.gather(1, token[:, None])[:, 0]
                   - torch.logsumexp(scaled, dim=-1))


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
    step0, later = selection_masks(cfg, dev)

    tokens = torch.full((b, S + 2), pad_i, dtype=torch.int32, device=dev)
    tokens[:, 0] = start_i
    alphas = torch.zeros(b, S + 1, L, device=dev)
    scores = torch.zeros(b, device=dev)
    flen = torch.zeros(b, dtype=torch.int32, device=dev)
    finished = torch.zeros(b, dtype=torch.bool, device=dev)
    for t in range(S + 1):
        logits, h, c, alpha = step(embed(tokens[:, t].long()), h, c)
        token, tok_logp = scan_select(logits, temperature,
                                      step0 if t == 0 else later)
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


def tile_select(logits: torch.Tensor, temperature: float, masked: torch.Tensor,
                tile: int = VOCAB_TILE) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernels' selection in PyTorch, as ``greedy_loop_logits`` and
    ``greedy_loop_select`` split it (the tests hold it against
    ``greedy_scan``'s argmax and logsumexp).

    ``logits`` (B, V) float32, ``masked`` (V,) bool (the tokens the choice
    excludes at this step).  Each (row, tile of ``tile`` columns) gives a
    partial over the tile's columns: the max m of scaled = logits /
    temperature, the sum of exp(scaled - m), the best unmasked value and its
    column (the lower on ties; V if the tile has none).  A row's partials
    combine as M = max m, S = sum s exp(m - M), the best value (the lower
    column on ties).  Returns (token (B,) int64, scaled[token] - (log S +
    M) (B,)); a token >= V becomes 0, as in the kernel."""
    b, V = logits.shape
    nt = -(-V // tile)
    pad = nt * tile - V
    x = torch.nn.functional.pad(logits.float() / temperature, (0, pad),
                                value=-math.inf).view(b, nt, tile)
    m = x.max(-1).values
    s = torch.exp(x - m[..., None]).sum(-1)
    keep = torch.nn.functional.pad(~masked, (0, pad), value=False).view(nt, tile)
    best, at = torch.where(keep, x, -math.inf).max(-1)   # the first maximum
    col = torch.where(keep.any(-1), at + tile * torch.arange(nt, device=x.device), V)
    M = m.max(-1).values
    S = (s * torch.exp(m - M[:, None])).sum(-1)
    value, j = best.max(-1)                               # the first tile
    token = col.gather(1, j[:, None])[:, 0]
    return torch.where(token >= V, 0, token), value - (torch.log(S) + M)


def loop_weights(params, cfg: SATConfig, dtype: torch.dtype):
    """(LoopWeights, capped embedding table (V, E), Wout packed to (E,
    pad8(V)) by ``pack_vocab_weights``, bout (V,) f32), all in ``dtype``
    apart from the float32 vectors."""
    lw = step_weights(params, cfg, dtype)
    emb = capped_embedding(params, cfg)
    if cfg.weight_tying and cfg.deep_output:
        wout = emb.T
        bout = torch.zeros(cfg.vocab_size, device=emb.device)
    else:
        wout = params.out_proj.w
        bout = (params.out_proj.b.float() if "b" in params.out_proj
                else torch.zeros(cfg.vocab_size, device=emb.device))
    return (lw, emb.to(dtype).contiguous(), pack_vocab_weights(wout.to(dtype)),
            bout.float().contiguous())


def greedy_loop_plain(fw: LoopWeights, emb: torch.Tensor, wout: torch.Tensor,
                      bout: torch.Tensor, cfg: SATConfig,
                      annotations: torch.Tensor, att_enc: torch.Tensor,
                      h0: torch.Tensor, c0: torch.Tensor, *,
                      max_gen_length: int, temperature: float = 1.0):
    """The kernels' function in PyTorch: ``greedy_scan`` over the kernels'
    step (values rounded to the input type where the kernels round them),
    stopping once every row has finished, as the kernels do.  ``wout`` is
    packed as the kernels take it (``loop_weights``)."""
    dt = annotations.dtype
    w = FusedWeights(*(x.float() for x in unpack_loop_weights(fw)))
    wout_f = unpack_vocab_weights(wout, bout.shape[0]).float()

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
    out = (ctypes.c_int * (6 * len(PHASES)))()
    _build.check(lib, lib.sat_greedy_loop_plan(
        _DTYPES[dtype], B, L, D, E, V, pad8(A + D + 4 * H), pad8(4 * H),
        pad8(E), DEEPOUT_SPLITS, out), "greedy_loop plan")
    return {name: (tuple(out[6 * i:6 * i + 3]), out[6 * i + 3],
                   out[6 * i + 4], out[6 * i + 5])
            for i, name in enumerate(PHASES)}


def tile_design(dtype: torch.dtype = torch.float32):
    """The tiles of the loop's products (``PRODUCTS``) in ``dtype``, as the
    C side builds them (``decoder_step.tile_design``'s fields).  Needs the
    built library."""
    lib = _build.load("greedy_loop")
    n = len(TILE_FIELDS)
    out = (ctypes.c_int * (n * len(PRODUCTS)))()
    _build.check(lib, lib.sat_greedy_loop_tiles(_DTYPES[dtype], out),
                 "greedy_loop tiles")
    return {name: dict(zip(TILE_FIELDS, out[n * i:n * i + n]))
            for i, name in enumerate(PRODUCTS)}


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
                       c0=(c0.shape, (b, H)), wout=(wout.shape, (E, pad8(V))),
                       bout=(bout.shape, (V,)), done=(done.shape, (1,))))
    check_loop_weights(lw, D, A, H, E, dt, dev)
    if wout.data_ptr() % 16:
        raise ValueError("wout must be 16-byte aligned")
    if not fused_step_supported(cfg, L):
        raise ValueError("greedy loop: L attention scores exceed shared memory")
    start_i, end_i, pad_i, unk_i = _special(cfg)
    n1, G, Ep = lw.w1.shape[1], lw.wx.shape[1], lw.wo.shape[1]
    K4, kc = deepout_rows(H, D, cfg.deep_output)
    bp, vt = pad8(b), vocab_tiles(V)

    # feature-major activations, padding columns zero: xt = [e; beta z],
    # yt = [h; z], tt = t; c, the products' outputs and the attention
    # scores in float32; one 16-byte partial per row and vocabulary tile
    xt = torch.zeros(E + D, bp, dtype=dt, device=dev)
    xt[:E, :b] = emb[start_i][:, None]
    yt = torch.zeros(H + D, bp, dtype=dt, device=dev)
    yt[:H, :b] = h0.T
    tt = torch.zeros(E, bp, dtype=dt, device=dev)
    c = c0.to(torch.float32, copy=True)
    g1 = torch.empty(b, n1, dtype=torch.float32, device=dev)
    part = torch.empty(DEEPOUT_SPLITS, b, Ep, dtype=torch.float32, device=dev)
    vpart = torch.empty(b, vt, 4, dtype=torch.float32, device=dev)
    sc = torch.empty(b, L, dtype=torch.float32, device=dev)

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
                               part, tt, vpart, done, sc, tokens, alphas,
                               scores, flen, finished),
            b, bp, L, D, A, H, E, V, S, n1, G, Ep, K4, kc, DEEPOUT_SPLITS,
            int(cfg.deep_output), vt, float(temperature), start_i, end_i,
            pad_i, unk_i, stream_ptr(dev))
    _build.check(lib, err, "greedy_loop kernels")
    return tokens, alphas, scores, flen, finished
