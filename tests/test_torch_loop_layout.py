"""The phase kernels' weight layout (``kernels/decoder_step.py::LoopWeights``),
held on the CPU against the step it must compute.

``layout_step`` follows the layout phase by phase as ``csrc/decode_phases.cuh``
indexes it: the phase-1 product and its column ranges, the gate-interleaved
phase-3 product with the LSTM cell on columns 4u..4u+3, and phase 4's split-K
partial products summed in slice order.  In bfloat16 each product sums in
the tensor-core kernels' K order (``kernel_product``: bf16 operands, float32
sums of 16-row chunks within each K group, the groups in order;
``kernels/decoder_step.py::BF16_TILES``).  It is held
against ``step_math`` on the ``FusedWeights`` the layout was packed from.
Tolerances, of each output's scale (its largest magnitude): float32 1e-5,
because the sums are taken in another order; bfloat16 2^-7, one bfloat16
step, because the values are rounded to bfloat16 at the same points, and
two float32 sums taken in another order that straddle a rounding boundary
round one step apart (one such element at n64 here).  Unpacking the layout
gives back ``pack_fused_weights``' tensors bit for bit."""

import numpy as np
import pytest
import torch

from sat_tpu_torch.config import SATConfig
from sat_tpu_torch.decode.beam import LOOP_ROUTE, decode_route
from sat_tpu_torch.kernels import decoder_step as KS
from sat_tpu_torch.kernels import greedy_loop as KL
from sat_tpu_torch.kernels.decoder_step import (FusedWeights,
                                                pack_fused_weights, step_math)
from sat_tpu_torch.models import decoder as TD
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

WIDTHS = [  # (E, D, A, H, V, L, B): n64, and the card tests' odd widths
    (256, 1024, 128, 512, 97, 49, 64),
    (8, 1024, 8, 12, 24, 1, 13),
    (10, 36, 9, 14, 29, 5, 30),
]


def make(E, D, A, H, V, deep=True, seed=0):
    """Random decoder params in the JAX layout, built with numpy."""
    stoi = {f"w{i}": i for i in range(1, V - 3)}
    stoi.update({"<UNK>": V - 3, "<START>": V - 2, "<END>": V - 1, "<PAD>": 0})
    cfg = SATConfig(vocab_size=V, vocab_stoi=stoi, embed_dim=E, encoder_dim=D,
                    attention_dim=A, decoder_dim=H, deep_output=deep)
    rng = np.random.default_rng(seed)
    u = lambda fan, *s: rng.uniform(-fan ** -0.5, fan ** -0.5, s).astype(np.float32)
    tree = {"embedding": rng.normal(size=(V, E)).astype(np.float32),
            "att_enc": {"w": u(D, D, A)}, "att_dec": {"w": u(H, H, A)},
            "f_att": {"w": u(A, A, 1)},
            "beta": {"w": u(H, H, D), "b": u(H, D)},
            "lstm": {"layer_0": {"w_ih": u(H, E + D, 4 * H), "w_hh": u(H, H, 4 * H),
                                 "b_ih": u(H, 4 * H), "b_hh": u(H, 4 * H)}},
            "out_hidden": {"w": u(H, H, E)},
            "out_proj": {"w": u(E, E, V), "b": u(E, V)}}
    if deep:
        tree["out_context"] = {"w": u(D, D, E)}
    return cfg, TD.ParamTree(tree), rng


def inputs(rng, cfg, B, L, dtype):
    """Step inputs e, h (in dtype), c (float32), annotations, att_enc."""
    E, D, H = cfg.embed_dim, cfg.encoder_dim, cfg.decoder_dim
    n = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    a = n(B, L, D).to(dtype)
    att_enc = torch.tanh(n(B, L, cfg.attention_dim)).to(dtype)
    return n(B, E).to(dtype), torch.tanh(n(B, H)).to(dtype), n(B, H), a, att_enc


def k_chunks(k0: int, k1: int, tile: dict):
    """The order in which a bfloat16 product sums its K rows [k0, k1): for
    each of its K groups (``tile["groups"]``), the group's 16-row chunks
    (c0, c1): of each stage of ``tile["bk"]`` rows, the group takes bk /
    (16 groups) chunks in order (``csrc/decode_phases.cuh``, the bf16
    ``gemm_tile``)."""
    bk, kg = tile["bk"], tile["groups"]
    spg = bk // 16 // kg
    groups = []
    for g in range(kg):
        chunks = []
        for st in range(k0, k1, bk):
            for q in range(spg):
                c0 = st + (g * spg + q) * 16
                if c0 < k1:
                    chunks.append((c0, min(k1, c0 + 16)))
        groups.append(chunks)
    return groups


def kernel_product(x, w, tile: dict, k0: int = 0, k1=None):
    """x[:, k0:k1] @ w[k0:k1] in float32 as the bf16 kernels sum it
    (``k_chunks``): each chunk's product, the chunks of a K group in
    order, then the groups in order."""
    k1 = w.shape[0] if k1 is None else k1
    x, w = x.float(), w.float()
    total = None
    for chunks in k_chunks(k0, k1, tile):
        acc = torch.zeros(x.shape[0], w.shape[1])
        for c0, c1 in chunks:
            acc = acc + x[:, c0:c1] @ w[c0:c1]
        total = acc if total is None else total + acc
    return total


def layout_step(lw: KS.LoopWeights, deep: bool, dt, e, h, c, annotations,
                att_enc):
    """One step from the packed tensors, phase by phase as the kernels index
    them, each product in bfloat16 in the kernels' K order
    (``kernel_product``).  Returns float32 (gates in FusedWeights column
    order, h', c', t rounded to dt)."""
    rnd = lambda x: x.to(dt).float()
    bf16 = dt == torch.bfloat16
    H, A, D = lw.w1.shape[0], lw.wf.shape[0], lw.bb.shape[0]
    E, B, L = lw.wx.shape[0] - D, e.shape[0], annotations.shape[1]
    e, h = e.float(), h.float()

    def product(name, x, w, k0=0, k1=None):
        if bf16:
            return kernel_product(x, w, KS.BF16_TILES[name], k0, k1)
        k1 = w.shape[0] if k1 is None else k1
        return x[:, k0:k1] @ w[k0:k1].float()

    # 1. hside: g1 = h w1; columns [0, A) att_dec, [A, A+D) x_beta, then g_h
    g1 = product("hside", h, lw.w1)
    att_dec, x_beta, g_h = g1[:, :A], g1[:, A:A + D], g1[:, A + D:A + D + 4 * H]
    # 2. attend
    s = torch.tanh(att_enc.float() + att_dec[:, None, :])
    alpha = torch.softmax((s * lw.wf).sum(-1) * (L ** -0.5), dim=-1)
    z = torch.einsum("bl,bld->bd", alpha, annotations.float())
    beta_z = rnd(torch.sigmoid(x_beta + lw.bb) * z)
    # 3. gates: [e | beta z] wx + g_h + bias, column 4u + q = gate q of unit u
    gates = product("gates", torch.cat([e, beta_z], 1), lw.wx)[:, :4 * H] + g_h + lw.bias[:4 * H]
    i, f, g, o = gates.view(B, H, 4).unbind(-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = rnd(torch.sigmoid(o) * torch.tanh(c_new))
    # 4. deepout: partial products of [h' | z] wo over the K slices, summed
    # in slice order by 5. select
    y = torch.cat([h_new, rnd(z)], 1)
    K, kc = KS.deepout_rows(H, D, deep)
    acc = torch.zeros(B, lw.wo.shape[1])
    for sl in range(KS.DEEPOUT_SPLITS):
        k0 = min(K, sl * kc)
        k1 = min(K, k0 + kc)
        acc = acc + product("deepout", y, lw.wo, k0, k1)
    t = acc[:, :E]
    if deep:
        t = torch.tanh(e + t)
    inv = torch.argsort(KS.gate_columns(H))
    return gates[:, inv], h_new, c_new, rnd(t)


def reference_step(fw: FusedWeights, deep: bool, dt, e, h, c, annotations,
                   att_enc):
    """The same outputs from ``step_math`` (gates as step_math forms them)."""
    w = FusedWeights(*(x.float() for x in fw))
    t, h_new, c_new, zt, _ = step_math(w, deep, dt, e, h, c, annotations, att_enc)
    beta = torch.sigmoid(h.float() @ w.wb + w.bb)
    xz = (beta * zt).to(dt).float()
    gates = e.float() @ w.wie + xz @ w.wiz + h.float() @ w.whh + w.bias
    return gates, h_new, c_new, t.to(dt).float()


@pytest.mark.parametrize("widths", WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("deep", [True, False])
def test_layout_step_matches_step_math(widths, dtype, deep):
    E, D, A, H, V, L, B = widths
    cfg, params, rng = make(E, D, A, H, V, deep=deep)
    lw, *_ = KL.loop_weights(params, cfg, dtype)
    fw = pack_fused_weights(params, cfg, dtype)
    x = inputs(rng, cfg, B, L, dtype)
    got = layout_step(lw, deep, dtype, *x)
    want = reference_step(fw, deep, dtype, *x)
    rel = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    for name, a, b in zip(("gates", "h'", "c'", "t"), got, want):
        scale = b.abs().max().item()
        err = (a - b).abs().max().item()
        assert err <= rel * scale, f"{name}: {err} > {rel} * {scale}"


def product_shapes(E, D, A, H, V):
    """(K, N, the K ranges summed) of each tiled product at these widths: the
    packed weights' rows and columns, deepout's ``DEEPOUT_SPLITS`` slices."""
    K4, kc = KS.deepout_rows(H, D, True)
    slices = [(min(K4, s * kc), min(K4, s * kc + kc)) for s in range(KS.DEEPOUT_SPLITS)]
    return {"hside": (H, KS.pad8(A + D + 4 * H), [(0, H)]),
            "gates": (E + D, KS.pad8(4 * H), [(0, E + D)]),
            "deepout": (H + D, KS.pad8(E), slices),
            "logits": (E, KS.pad8(V), [(0, E)])}


@pytest.mark.parametrize("widths", WIDTHS)
@pytest.mark.parametrize("name", KL.PRODUCTS)
def test_bf16_products_in_kernel_order(widths, name):
    """Each bf16 product's K order (``k_chunks``) takes every row of its K
    range once, in 16-row chunks that start a multiple of 16 rows into
    their stage; summed in that order (``kernel_product``) it is the
    product within 1e-5 of its scale (float32 sums in another order than
    float64's)."""
    E, D, A, H, V, L, B = widths
    K, N, ranges = product_shapes(E, D, A, H, V)[name]
    tile = KL.BF16_TILES[name]
    rng = np.random.default_rng(K + N)
    x = torch.from_numpy(rng.normal(size=(B, K)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.normal(size=(K, N)).astype(np.float32)).to(torch.bfloat16)
    for k0, k1 in ranges:
        groups = k_chunks(k0, k1, tile)
        assert len(groups) == tile["groups"]
        chunks = sorted(c for g in groups for c in g)
        assert all(c1 - c0 <= 16 and (c0 - k0) % tile["bk"] % 16 == 0 for c0, c1 in chunks)
        assert [r for c0, c1 in chunks for r in range(c0, c1)] == list(range(k0, k1))
        got = kernel_product(x, w, tile, k0, k1)
        want = x[:, k0:k1].double() @ w[k0:k1].double()
        scale = max(1.0, want.abs().max().item())
        assert (got.double() - want).abs().max().item() <= 1e-5 * scale


@pytest.mark.parametrize("V", [97, 4096, 4099])
def test_bf16_logits_in_kernel_order_select_as_the_scan(V):
    """The loop's vocabulary product in bf16 as the tensor-core kernel sums
    it (``kernel_product`` on the logits tile, Wout packed to pad8(V)), then
    its tile partials and their combine (``tile_select``), against
    ``scan_select`` on the float64 product: the same tokens, and
    log-probabilities within 1e-5 of their scale."""
    cfg, params, rng = make(256, 1024, 128, 512, V)
    _, _, wout, bout = KL.loop_weights(params, cfg, torch.bfloat16)
    t = torch.tanh(torch.from_numpy(rng.normal(size=(64, 256)).astype(np.float32)))
    t = t.to(torch.bfloat16)
    got = kernel_product(t, wout, KL.BF16_TILES["logits"])[:, :V] + bout
    want = (t.double() @ wout[:, :V].double() + bout.double()).float()
    masked = KL.selection_masks(cfg)[1]
    want_tok, want_lp = KL.scan_select(want, 1.0, masked)
    got_tok, got_lp = KL.tile_select(got, 1.0, masked)
    assert torch.equal(got_tok, want_tok)
    scale = want_lp.abs().max().item()
    assert (got_lp - want_lp).abs().max().item() <= 1e-5 * scale


@pytest.mark.parametrize("widths", WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("deep", [True, False])
def test_unpack_gives_back_fused_weights(widths, dtype, deep):
    E, D, A, H, V, L, B = widths
    cfg, params, _ = make(E, D, A, H, V, deep=deep)
    fw = pack_fused_weights(params, cfg, dtype)
    lw = KS.pack_loop_weights(fw)
    back = KS.unpack_loop_weights(lw)
    for name in FusedWeights._fields:
        a, b = getattr(back, name), getattr(fw, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a.view(torch.int16 if a.dtype == torch.bfloat16
                                  else torch.int32),
                           b.view(torch.int16 if b.dtype == torch.bfloat16
                                  else torch.int32)), name


@pytest.mark.parametrize("H", [1, 3, 12, 512])
def test_gate_columns_interleave_units(H):
    """Packed column 4u + q holds gate q of unit u, and every column once."""
    g = KS.gate_columns(H)
    assert sorted(g.tolist()) == list(range(4 * H))
    for u in range(min(H, 5)):
        assert g[4 * u:4 * u + 4].tolist() == [q * H + u for q in range(4)]


def test_layout_pads_columns_to_whole_copies():
    """Every packed matrix has a multiple of 8 columns, zero past the data,
    so each row is a whole number of 16-byte copies in either type."""
    E, D, A, H, V = 10, 36, 9, 13, 29
    cfg, params, _ = make(E, D, A, H, V)
    lw, *_ = KL.loop_weights(params, cfg, torch.bfloat16)
    assert lw.w1.shape == (H, KS.pad8(A + D + 4 * H))
    assert lw.wx.shape == (E + D, KS.pad8(4 * H))
    assert lw.wo.shape == (H + D, KS.pad8(E))
    for w, n in ((lw.w1, A + D + 4 * H), (lw.wx, 4 * H), (lw.wo, E), (lw.bias, 4 * H)):
        assert w.shape[-1] % 8 == 0 and not w[..., n:].any()
    for deep, K in ((True, H + D), (False, H)):
        k, kc = KS.deepout_rows(H, D, deep)
        rows = [r for s in range(KS.DEEPOUT_SPLITS)
                for r in range(min(k, s * kc), min(k, s * kc + kc))]
        assert k == K and rows == list(range(K))   # each K row in one slice


def test_loop_gate_uses_select_state():
    """The gate is the phase kernels' own need: one layer, and attend's L
    scores within a block's shared memory.  The selection holds nothing
    V-wide per block: a row's state is one 16-byte partial per vocabulary
    tile, in global memory, so the vocabulary does not bound the gate."""
    cfg, _, _ = make(256, 1024, 128, 512, 97)
    assert KL.vocab_tiles(97) == 7 and KL.vocab_tiles(60000) == 3750
    loop = lambda c, L: decode_route(torch.device("cuda"), c, L, greedy=True)
    assert loop(cfg, 49) == LOOP_ROUTE
    assert loop(cfg.replace(vocab_size=50000), 196) == LOOP_ROUTE
    assert loop(cfg.replace(vocab_size=60000), 196) == LOOP_ROUTE


@pytest.mark.parametrize("V", [97, 4096, 4099])
@pytest.mark.parametrize("tile", [KL.VOCAB_TILE, 12])
@pytest.mark.parametrize("temperature", [1.0, 0.7])
@pytest.mark.parametrize("t", [0, 3])
def test_tile_select_matches_scan_select(V, tile, temperature, t):
    """The loop kernels' selection as tile partials and their combine
    (``tile_select``) against ``greedy_scan``'s argmax and logsumexp
    (``scan_select``): tokens equal, log-probabilities within 1e-6 of their
    scale (float32 sums in another order).  Rows: equal maxima in two tiles
    and within one tile (the lower index), START, PAD, END and UNK holding
    the row's maximum (END and UNK masked at step 0 only; END and UNK lie
    in the last tile, which V 97 and 4,099 leave partial)."""
    cfg, _, _ = make(8, 8, 8, 8, V)
    unk, start, end, pad = V - 3, V - 2, V - 1, 0
    rng = np.random.default_rng(V + tile + t)
    logits = torch.from_numpy(rng.normal(scale=3.0, size=(8, V)).astype(np.float32))
    top = float(logits.max()) + 1.0
    lo, hi = 5, V // 2 + 3              # different tiles for either width
    logits[0, [hi, lo]] = top
    for row, tok in ((1, start), (2, pad), (3, end), (4, unk)):
        logits[row, tok] = top + 1.0
    logits[6, lo:lo + 2] = top
    masked = KL.selection_masks(cfg)[0 if t == 0 else 1]
    want_tok, want_lp = KL.scan_select(logits, temperature, masked)
    got_tok, got_lp = KL.tile_select(logits, temperature, masked, tile)
    assert want_tok[0] == lo and want_tok[6] == lo
    assert want_tok[1] != start and want_tok[2] != pad
    assert (want_tok[3] == end) == (t > 0) and (want_tok[4] == unk) == (t > 0)
    assert torch.equal(got_tok, want_tok)
    scale = want_lp.abs().max().item()
    assert (got_lp - want_lp).abs().max().item() <= 1e-6 * scale


@pytest.mark.parametrize("V", [97, 4099])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vocab_layout_pads_columns(V, dtype):
    """Wout packed to (E, pad8(V)): whole 16-byte rows, zero past V, and
    unpacked to ``out_proj.w`` in the type, bit for bit."""
    cfg, params, _ = make(10, 8, 8, 12, V)
    _, _, wout, bout = KL.loop_weights(params, cfg, dtype)
    assert wout.shape == (10, KS.pad8(V)) and wout.dtype == dtype
    assert wout.is_contiguous() and bout.shape == (V,)
    assert not wout[:, V:].any()
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    back = KS.unpack_vocab_weights(wout, V)
    assert torch.equal(back.view(bits), params.out_proj.w.to(dtype).view(bits))
