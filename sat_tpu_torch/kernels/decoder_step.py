"""Fused decode step (attention + beta gate + LSTM cell + deep-output
pre-projection) as CUDA kernels, ``csrc/decoder_step.cu``.

Replaces the Pallas kernel ``sat_tpu/kernels/decoder_step.py::_kernel``
(driven by ``fused_decoder_step``): the same function, without the TPU's
8-row padding.  The vocabulary projection stays outside, a ``torch.matmul``
in ``fused_output_logits``, as the JAX package leaves it to XLA.

What bounds it on an H100: a step's products read 4.6 M weights (18.6 MB in
f32 at n64) for every row's multiply-adds, and the attention reads the
annotations (103 MB at L 196, D 2048 for 64 images in f32).  The design runs
the step as the batch-wide phases it shares with the greedy loop
(``csrc/decode_phases.cuh``: three products tiled over 64 rows, the
attention scores once per row, and the attention's context per image and D
slice) between a prologue that lays e and h out feature-major and an
epilogue that finishes t: seven kernels per step, launched by one C call,
each weight read once per tile of 64 rows and each image's annotations once
for all the rows that share it.  Rows may share images: N = Bi k rows over
(Bi, L, .) annotations, image-major and slot-minor, as beam search's B k
slots read their image (the TPU kernel takes k-fold copies instead; the
plain version makes them, ``repeat_interleave``).  The phases index the
packed layout ``LoopWeights``, which this module defines
(``pack_loop_weights``) and the loop kernels share.

``fused_decoder_step`` launches the kernels for CUDA tensors and runs
``fused_decoder_step_plain``, the same math in PyTorch, for CPU tensors.  It
raises on anything the kernels do not take; it never falls back."""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from ..config import SATConfig
from ..models.decoder import project_vocab
from ..parallel.mesh import ONE_RANK, Mesh
from . import _build

# wrapper calls that launched the kernels, since import (read and reset by
# chip_smoke.py)
launches = 0

MAX_SMEM = 232448      # bytes of shared memory a block may use on Hopper
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernels one call launches, in order (csrc/decoder_step.cu, named
# decoder_step_<kernel>)
KERNELS = ("in", "hside", "scores", "attend", "gates", "deepout", "out")
# phase 4 splits its K rows into this many slices; the caller sums their
# partial products in slice order
DEEPOUT_SPLITS = 16
# the tiled products of a step (csrc/decode_phases.cuh) and the fields of
# their tiles (``tile_design``): columns, K rows per stage, stages, K
# groups, 1 where they run on tensor cores
PRODUCTS = ("hside", "gates", "deepout")
TILE_FIELDS = ("bn", "bk", "stages", "groups", "mma")
# The bfloat16 products' tiles (``Products<__nv_bfloat16>``), which fix the
# order of their float32 sums over K rows [k0, k1): each of ``groups`` K
# groups takes, of each stage of ``bk`` rows, its share of 16-row chunks in
# order, and the groups are added in order.  ``chip_smoke.py`` holds them to
# the built library's ``tile_design``; ``tests/test_torch_loop_layout.py``
# sums in this order on the CPU.
BF16_TILES = {
    "hside": dict(bn=32, bk=256, stages=2, groups=4, mma=1),
    "gates": dict(bn=16, bk=256, stages=2, groups=8, mma=1),
    "deepout": dict(bn=32, bk=128, stages=2, groups=4, mma=1),
}


class FusedWeights(NamedTuple):
    """Decoder-step weights in the kernel layout (see pack_fused_weights)."""
    wd: torch.Tensor     # (H, A)   attention decoder projection
    wf: torch.Tensor     # (1, A)   attention scorer
    wb: torch.Tensor     # (H, D)   beta gate weight
    bb: torch.Tensor     # (1, D)   beta gate bias
    wie: torch.Tensor    # (E, 4H)  LSTM input weights, embedding part
    wiz: torch.Tensor    # (D, 4H)  LSTM input weights, context part
    whh: torch.Tensor    # (H, 4H)  LSTM recurrent weights
    bias: torch.Tensor   # (1, 4H)  b_ih + b_hh
    wh: torch.Tensor     # (H, E)   deep-output hidden projection
    wc: torch.Tensor     # (D, E)   deep-output context projection (zeros if not deep)


def pack_fused_weights(params, cfg: SATConfig,
                       dtype: torch.dtype = torch.float32) -> FusedWeights:
    """Decoder ParamTree -> kernel layout, contiguous, in ``dtype``."""
    if cfg.decoder_layers != 1:
        raise ValueError("the fused step kernel supports decoder_layers=1")
    E, D = cfg.embed_dim, cfg.encoder_dim
    lstm = params.lstm.layer_0
    if cfg.deep_output:
        wc = params.out_context.w
    else:
        wc = torch.zeros(D, E, dtype=dtype, device=lstm.w_ih.device)
    ws = (params.att_dec.w, params.f_att.w.reshape(1, -1), params.beta.w,
          params.beta.b.reshape(1, -1), lstm.w_ih[:E], lstm.w_ih[E:],
          lstm.w_hh, (lstm.b_ih + lstm.b_hh).reshape(1, -1),
          params.out_hidden.w, wc)
    return FusedWeights(*(w.to(dtype).contiguous() for w in ws))


def pad8(n: int) -> int:
    """n rounded up to 8 elements: a whole number of 16-byte copies."""
    return (n + 7) // 8 * 8


def attend_smem_bytes(L: int) -> int:
    """The bytes of one row's L attention scores in float32, padded to 16."""
    return 4 * ((L + 3) // 4 * 4)


def fused_step_supported(cfg: SATConfig, L: int) -> bool:
    """The kernels' gate: one LSTM layer, and one row's L scores fit a
    block's shared memory.  The attention kernels keep the scores in device
    memory and stage L in chunks, so L does not bound them; the bound on L
    is kept so that every configuration takes the route it took when a
    block held a row's scores."""
    return cfg.decoder_layers == 1 and attend_smem_bytes(L) <= MAX_SMEM


def rows_per_image(n: int, images: int) -> int:
    """k, the rows that share each of ``images`` images among ``n`` rows
    (image-major, slot-minor: row r reads image r // k); raises
    ``ValueError`` unless n is a multiple of the images."""
    if images <= 0 or n % images:
        if n == images == 0:
            return 1
        raise ValueError(f"{n} rows do not share {images} images evenly: "
                         "N must be a multiple of the images")
    return n // images


class LoopWeights(NamedTuple):
    """The step weights in the layout the phase kernels index.

    Gate columns are interleaved: column ``4u + q`` of the gate matrices
    (the Whh part of ``w1``, ``wx``, ``bias``) holds gate q (i, f, g, o) of
    hidden unit u, which is column ``q H + u`` of the ``FusedWeights``
    matrices (``gate_columns``), so one thread's four adjacent columns are
    the four gates of its unit.  Column counts are padded with zeros to
    multiples of 8 elements (``pad8``), so every row of a matrix is a whole
    number of 16-byte copies; K rows are not padded.  Small vectors are
    float32 holding the values of the working type."""
    w1: torch.Tensor     # (H, N1)   phase 1: columns [0, A) Wd, [A, A+D) Wb,
    #                       [A+D, A+D+4H) Whh interleaved; N1 = pad8(A+D+4H)
    wx: torch.Tensor     # (E+D, G)  phase 3: rows [0, E) Wie, [E, E+D) Wiz,
    #                       interleaved; G = pad8(4H)
    wo: torch.Tensor     # (H+D, Ep) phase 4: rows [0, H) Wh, [H, H+D) Wc;
    #                       Ep = pad8(E)
    wf: torch.Tensor     # (A,)  float32 attention scorer
    bb: torch.Tensor     # (D,)  float32 beta gate bias
    bias: torch.Tensor   # (G,)  float32 b_ih + b_hh, interleaved


def gate_columns(H: int, device=None) -> torch.Tensor:
    """Index of packed gate column ``4u + q``: the ``FusedWeights`` column
    ``q H + u`` it holds (see ``LoopWeights``)."""
    p = torch.arange(4 * H, device=device)
    return (p % 4) * H + p // 4


def pack_loop_weights(fw: FusedWeights) -> LoopWeights:
    """``FusedWeights`` -> the phase kernels' layout, in fw's type."""
    H, A = fw.wd.shape
    D, E = fw.wb.shape[1], fw.wie.shape[0]
    g = gate_columns(H, fw.wd.device)
    n1, G = pad8(A + D + 4 * H), pad8(4 * H)
    w1 = fw.wd.new_zeros(H, n1)
    w1[:, :A] = fw.wd
    w1[:, A:A + D] = fw.wb
    w1[:, A + D:A + D + 4 * H] = fw.whh[:, g]
    wx = fw.wd.new_zeros(E + D, G)
    wx[:E, :4 * H] = fw.wie[:, g]
    wx[E:, :4 * H] = fw.wiz[:, g]
    wo = fw.wd.new_zeros(H + D, pad8(E))
    wo[:H, :E] = fw.wh
    wo[H:, :E] = fw.wc
    bias = torch.zeros(G, device=fw.wd.device)
    bias[:4 * H] = fw.bias[0, g].float()
    return LoopWeights(w1, wx, wo, fw.wf[0].float(), fw.bb[0].float(), bias)


def unpack_loop_weights(lw: LoopWeights) -> FusedWeights:
    """The inverse of ``pack_loop_weights``: the same tensors, bit for bit."""
    H, A, D = lw.w1.shape[0], lw.wf.shape[0], lw.bb.shape[0]
    E, dt = lw.wx.shape[0] - D, lw.w1.dtype
    inv = torch.argsort(gate_columns(H, lw.w1.device))
    gates = lambda w: w[:, :4 * H][:, inv].contiguous()
    return FusedWeights(
        wd=lw.w1[:, :A].contiguous(), wf=lw.wf[None].to(dt),
        wb=lw.w1[:, A:A + D].contiguous(), bb=lw.bb[None].to(dt),
        wie=gates(lw.wx[:E]), wiz=gates(lw.wx[E:]),
        whh=gates(lw.w1[:, A + D:]), bias=gates(lw.bias[None]).to(dt),
        wh=lw.wo[:H, :E].contiguous(), wc=lw.wo[H:, :E].contiguous())


def pack_vocab_weights(wout: torch.Tensor) -> torch.Tensor:
    """Wout (E, V) -> (E, pad8(V)) with zero columns past V, in wout's type:
    every row a whole number of 16-byte copies for the loop's vocabulary
    product (``csrc/greedy_loop.cu``, ``greedy_loop_logits``)."""
    E, V = wout.shape
    out = wout.new_zeros(E, pad8(V))
    out[:, :V] = wout
    return out


def unpack_vocab_weights(wout: torch.Tensor, V: int) -> torch.Tensor:
    """The inverse of ``pack_vocab_weights``: Wout (E, V), bit for bit."""
    return wout[:, :V].contiguous()


def step_weights(params, cfg: SATConfig,
                 dtype: torch.dtype = torch.float32) -> LoopWeights:
    """Decoder ParamTree -> the phase kernels' layout, in ``dtype``."""
    return pack_loop_weights(pack_fused_weights(params, cfg, dtype))


def deepout_rows(H: int, D: int, deep: bool) -> Tuple[int, int]:
    """Phase 4's K (the rows of ``wo`` it reads: Wc only with deep output)
    and the K rows of each of its ``DEEPOUT_SPLITS`` slices; slice s covers
    rows [s kc, min(K, (s+1) kc))."""
    K = H + D if deep else H
    return K, -(-K // DEEPOUT_SPLITS)


def step_math(w: FusedWeights, deep_output: bool, dt: torch.dtype,
              e: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
              annotations: torch.Tensor, att_enc: torch.Tensor
              ) -> Tuple[torch.Tensor, ...]:
    """The kernel's step on float32 weights ``w``: returns float32
    (t, h', c', zt, alpha) with h' rounded to ``dt``, as the kernel keeps them."""
    rnd = lambda x: x.to(dt).float()
    L = annotations.shape[1]
    e, h = e.float(), h.float()
    att_dec = h @ w.wd
    s = torch.tanh(att_enc.float() + att_dec[:, None, :])
    att = (s * w.wf[None]).sum(-1) * (L ** -0.5)
    alpha = torch.softmax(att, dim=-1)
    zt = torch.einsum("bl,bld->bd", alpha, annotations.float())
    beta = torch.sigmoid(h @ w.wb + w.bb)
    xz = rnd(beta * zt)
    gates = e @ w.wie + xz @ w.wiz + h @ w.whh + w.bias
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c.float() + torch.sigmoid(i) * torch.tanh(g)
    h_new = rnd(torch.sigmoid(o) * torch.tanh(c_new))
    t = h_new @ w.wh
    if deep_output:
        t = torch.tanh(e + t + rnd(zt) @ w.wc)
    return t, h_new, c_new, zt, alpha


def fused_decoder_step_plain(lw: LoopWeights, cfg: SATConfig,
                             prev_embed: torch.Tensor, h: torch.Tensor,
                             c: torch.Tensor, annotations: torch.Tensor,
                             att_enc: torch.Tensor
                             ) -> Tuple[torch.Tensor, ...]:
    """The kernels' function in PyTorch on the packed weights: float
    accumulation, values rounded to the input type where the kernels round
    them.  Annotations and att_enc of Bi images serve N = Bi k rows, k to
    an image (``rows_per_image``): the step on their k-fold copies."""
    dt = prev_embed.dtype
    k = rows_per_image(prev_embed.shape[0], annotations.shape[0])
    if k > 1:
        annotations = annotations.repeat_interleave(k, 0)
        att_enc = att_enc.repeat_interleave(k, 0)
    w = FusedWeights(*(x.float() for x in unpack_loop_weights(lw)))
    t, h_new, c_new, zt, alpha = step_math(w, cfg.deep_output, dt, prev_embed,
                                           h, c, annotations, att_enc)
    return t.to(dt), h_new.to(dt), c_new.to(dt), zt.to(dt), alpha


def _check(tensors, dtype: torch.dtype, device: torch.device) -> None:
    if dtype not in _DTYPES:
        raise ValueError(f"kernel takes float32 or bfloat16, not {dtype}")
    for name, x in tensors.items():
        if x.device != device or x.dtype != dtype:
            raise ValueError(f"{name}: {x.dtype} on {x.device}; expected "
                             f"{dtype} on {device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_shapes(shapes) -> None:
    for name, (got, want) in shapes.items():
        if tuple(got) != tuple(want):
            raise ValueError(f"{name}: shape {tuple(got)}, expected {tuple(want)}")


def check_loop_weights(lw: LoopWeights, D: int, A: int, H: int, E: int,
                       dt: torch.dtype, device: torch.device) -> None:
    """Types, devices, shapes and 16-byte alignment of the packed weights."""
    _check(dict(w1=lw.w1, wx=lw.wx, wo=lw.wo), dt, device)
    _check(dict(wf=lw.wf, bb=lw.bb, bias=lw.bias), torch.float32, device)
    want = dict(w1=(H, pad8(A + D + 4 * H)), wx=(E + D, pad8(4 * H)),
                wo=(H + D, pad8(E)), wf=(A,), bb=(D,), bias=(pad8(4 * H),))
    _check_shapes({k: (getattr(lw, k).shape, v) for k, v in want.items()})
    if any(x.data_ptr() % 16 for x in (lw.w1, lw.wx, lw.wo)):
        raise ValueError("packed weights must be 16-byte aligned")


def ptrs(*tensors: torch.Tensor) -> Tuple[int, ...]:
    return tuple(x.data_ptr() for x in tensors)


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def step_plan(B: int, L: int, D: int, A: int, H: int, E: int,
              dtype: torch.dtype = torch.float32, k: int = 1):
    """The launch plan of one call at B rows, k to an image, as the C side
    computes it: for each kernel of ``KERNELS``, (grid (x, y, z), threads,
    dynamic and static shared memory bytes).  Needs the built library."""
    lib = _build.load("decoder_step")
    out = (ctypes.c_int * (6 * len(KERNELS)))()
    _build.check(lib, lib.sat_decoder_step_plan(
        _DTYPES[dtype], B, k, L, D, H, E, pad8(A + D + 4 * H), pad8(4 * H),
        pad8(E), DEEPOUT_SPLITS, out), "decoder_step plan")
    return {name: (tuple(out[6 * i:6 * i + 3]), out[6 * i + 3],
                   out[6 * i + 4], out[6 * i + 5])
            for i, name in enumerate(KERNELS)}


def tile_design(dtype: torch.dtype = torch.float32):
    """The tiles of the step's products (``PRODUCTS``) in ``dtype``, as the
    C side builds them: {product: {field of ``TILE_FIELDS``: value}}.
    Needs the built library."""
    lib = _build.load("decoder_step")
    n = len(TILE_FIELDS)
    out = (ctypes.c_int * (n * len(PRODUCTS)))()
    _build.check(lib, lib.sat_decoder_step_tiles(_DTYPES[dtype], out),
                 "decoder_step tiles")
    return {name: dict(zip(TILE_FIELDS, out[n * i:n * i + n]))
            for i, name in enumerate(PRODUCTS)}


def fused_decoder_step(lw: LoopWeights, cfg: SATConfig,
                       prev_embed: torch.Tensor, h: torch.Tensor,
                       c: torch.Tensor, annotations: torch.Tensor,
                       att_enc: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """One fused decode step minus the vocab projection, on weights in the
    phase kernels' layout (``step_weights``).

    prev_embed (N, E); h, c (N, H); annotations (Bi, L, D) and att_enc
    (Bi, L, A) of Bi images, N = Bi k: row r attends over image r // k (a
    beam's k slots share their image; Bi = N is one image per row).
    Raises ``ValueError`` unless N is a multiple of Bi.  Returns (t (N, E),
    h', c', zt (N, D)) in the input type and alpha (N, L) float32;
    ``logits = fused_output_logits(t)``."""
    global launches
    if prev_embed.device.type == "cpu":
        return fused_decoder_step_plain(lw, cfg, prev_embed, h, c,
                                        annotations, att_enc)
    if prev_embed.device.type != "cuda":
        raise ValueError(f"no kernel for device {prev_embed.device}")
    bi, L, D = annotations.shape
    n = prev_embed.shape[0]
    k = rows_per_image(n, bi)
    E, H, A = prev_embed.shape[-1], h.shape[-1], att_enc.shape[-1]
    dt, dev = prev_embed.dtype, prev_embed.device
    _check(dict(prev_embed=prev_embed, h=h, c=c, annotations=annotations,
                att_enc=att_enc), dt, dev)
    _check_shapes(dict(prev_embed=(prev_embed.shape, (n, E)), h=(h.shape, (n, H)),
                       c=(c.shape, (n, H)), att_enc=(att_enc.shape, (bi, L, A))))
    check_loop_weights(lw, D, A, H, E, dt, dev)
    if attend_smem_bytes(L) > MAX_SMEM:
        raise ValueError("fused step: L attention scores exceed shared memory")
    n1, G, Ep = lw.w1.shape[1], lw.wx.shape[1], lw.wo.shape[1]
    K4, kc = deepout_rows(H, D, cfg.deep_output)
    bp = pad8(n)

    # scratch: feature-major [e; beta z] and [h; z], the products' float32
    # sums, the attention scores
    xt = torch.empty(E + D, bp, dtype=dt, device=dev)
    yt = torch.empty(H + D, bp, dtype=dt, device=dev)
    g1 = torch.empty(n, n1, dtype=torch.float32, device=dev)
    part = torch.empty(DEEPOUT_SPLITS, n, Ep, dtype=torch.float32, device=dev)
    sc = torch.empty(n, L, dtype=torch.float32, device=dev)
    t = torch.empty(n, E, dtype=dt, device=dev)
    h_new = torch.empty(n, H, dtype=dt, device=dev)
    c_new = torch.empty(n, H, dtype=dt, device=dev)
    zt = torch.empty(n, D, dtype=dt, device=dev)
    alpha = torch.empty(n, L, dtype=torch.float32, device=dev)
    lib = _build.load("decoder_step")
    with torch.cuda.device(dev):
        err = lib.sat_decoder_step(
            _DTYPES[dt], *ptrs(prev_embed, h, c, annotations, att_enc, *lw,
                               xt, yt, g1, part, sc, t, h_new, c_new, zt, alpha),
            n, bp, L, D, A, H, E, n1, G, Ep, K4, kc, DEEPOUT_SPLITS,
            int(cfg.deep_output), k, stream_ptr(dev))
    _build.check(lib, err, "decoder_step kernels")
    launches += 1
    return t, h_new, c_new, zt, alpha


def fused_output_logits(params, cfg: SATConfig, t: torch.Tensor,
                        embedding: torch.Tensor, mesh: Mesh = ONE_RANK
                        ) -> torch.Tensor:
    """The vocab projection left outside the kernel: one matmul, float32
    logits (``models.decoder.project_vocab``, the bias added in float32).
    ``embedding`` is the table capped at ``embed_norm``
    (decoder.capped_embedding), used when the output is tied to it; a vocab
    TP slice is joined over ``mesh``.  The kernels' pre-projection ``t`` is
    the same on either side."""
    return project_vocab(params, cfg, t, embedding, mesh, float_bias=True)
