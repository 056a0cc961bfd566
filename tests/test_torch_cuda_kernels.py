"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips when no CUDA device is present (decided
inside the test, so every worker collects the same tests).  Run on a
machine with the card:  python -m pytest tests/test_torch_cuda_kernels.py -q
This file imports only torch and the port, as the card's machine has no JAX.
"""

import numpy as np
import pytest
import torch

from sat_tpu_torch.config import SATConfig
from sat_tpu_torch.decode.beam import beam_search, greedy_decode
from sat_tpu_torch.kernels import decoder_step as KS
from sat_tpu_torch.kernels import greedy_loop as KL
from sat_tpu_torch.models import decoder as TD

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def make(E, D, A, H, V, deep=True, tying=False, embed_norm=None, seed=0):
    """Random decoder params in the JAX layout, built with numpy."""
    stoi = {f"w{i}": i for i in range(1, V - 3)}
    stoi.update({"<UNK>": V - 3, "<START>": V - 2, "<END>": V - 1, "<PAD>": 0})
    cfg = SATConfig(vocab_size=V, vocab_stoi=stoi, embed_dim=E, encoder_dim=D,
                    attention_dim=A, decoder_dim=H, deep_output=deep,
                    weight_tying=tying, embed_norm=embed_norm)
    rng = np.random.default_rng(seed)
    u = lambda fan, *s: rng.uniform(-fan ** -0.5, fan ** -0.5, s).astype(np.float32)
    tree = {"embedding": rng.normal(size=(V, E)).astype(np.float32),
            "init_factorize": {"w": u(D, D, E), "b": u(D, E)},
            "init_proj": {"w": u(E, E, 2 * H), "b": u(E, 2 * H)},
            "att_enc": {"w": u(D, D, A)}, "att_dec": {"w": u(H, H, A)},
            "f_att": {"w": u(A, A, 1)},
            "beta": {"w": u(H, H, D), "b": np.full(D, 1.0 / H, np.float32)},
            "lstm": {"layer_0": {"w_ih": u(H, E + D, 4 * H), "w_hh": u(H, H, 4 * H),
                                 "b_ih": u(H, 4 * H), "b_hh": u(H, 4 * H)}},
            "out_hidden": {"w": u(H, H, E)}}
    if deep:
        tree["out_context"] = {"w": u(D, D, E)}
    if not (tying and deep):
        tree["out_proj"] = {"w": u(E, E, V)}
        if not tying:
            tree["out_proj"]["b"] = u(E, V)
            tree["out_proj"]["b"][V - 1] += 1.0   # let rows finish
    return cfg, TD.ParamTree(tree)


SHAPES = [  # (E, D, A, H, V, L, B): n64 widths, and odd narrow ones
    (256, 1024, 128, 512, 97, 49, 64),
    (8, 1024, 8, 12, 24, 1, 13),
    (10, 36, 9, 14, 29, 5, 300),
]
# the loop kernels also at one row and at one row past a 64-row tile
LOOP_SHAPES = SHAPES + [
    (256, 1024, 128, 512, 97, 49, 1),
    (256, 1024, 128, 512, 97, 49, 65),
]
# the step kernels also at three 64-row tiles (beam search's B k rows)
STEP_SHAPES = LOOP_SHAPES + [(256, 1024, 128, 512, 97, 49, 192)]
# the loop kernels also at the reference's 4,096 words, at a vocabulary that
# leaves its last tile partial, and at 60,000 words (3,750 vocabulary tiles)
WIDE_VOCAB = [(256, 1024, 128, 512, V, 49, 64) for V in (4096, 4099, 60000)]
LOOP_SHAPES = LOOP_SHAPES + WIDE_VOCAB


def device_kernels(fn):
    """fn()'s result and the names of the kernels it ran on the card.

    Now and then (0.2-2 % of short windows, ``profiler_windows.py``) the
    profiler drops every kernel record of a window whose own start or stop
    stalls for 50-130 ms, or the last kernels of it, while the host-side
    records of the same launches stay: the kernels' times fall outside
    the window it keeps.  The window therefore opens 0.05 s before the
    first kernel and closes 0.05 s after the last one finished."""
    import time
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)
        # the first kernel of a profiled window can go unrecorded: start with
        # one that is not counted
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        out = fn()
        torch.cuda.synchronize()
        time.sleep(0.05)
    return out, [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


@pytest.mark.parametrize("shape", STEP_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("deep", [True, False])
def test_step_kernel(shape, dtype, deep):
    dev = _card()
    E, D, A, H, V, L, B = shape
    cfg, p = make(E, D, A, H, V, deep=deep)
    p = p.to(dev)
    g = torch.Generator(device="cpu").manual_seed(1)
    a = torch.randn(B, L, D, generator=g).to(dev, dtype)
    att_enc = TD.attention_precompute(p.to(dtype), a).contiguous()
    e = torch.randn(B, E, generator=g).to(dev, dtype)
    h = torch.randn(B, H, generator=g).to(dev, dtype)
    c = torch.randn(B, H, generator=g).to(dev, dtype)
    lw = KS.step_weights(p, cfg, dtype)
    n0 = KS.launches
    got, names = device_kernels(lambda: KS.fused_decoder_step(lw, cfg, e, h, c, a, att_enc))
    ref = KS.fused_decoder_step_plain(lw, cfg, e, h, c, a, att_enc)
    torch.cuda.synchronize()
    assert KS.launches == n0 + 1
    # one wrapper call launches each of its kernels once, and no other of ours
    assert sum("decoder_step_" in n for n in names) == len(KS.KERNELS), names
    for k in KS.KERNELS:
        assert sum(f"decoder_step_{k}" in n for n in names) == 1, (k, names)
    for x, y in zip(got, ref):
        scale = max(1.0, y.float().abs().max().item())
        # bf16 outputs may differ by one rounding step of the output type
        tol = (1e-4 if dtype == torch.float32 else 1e-2) * scale
        assert (x.float() - y.float()).abs().max().item() <= tol


def _grouped_step_args(k, L, D, dtype, images=8, seed=4):
    """Step arguments at n64's decoder widths for ``images`` images of L
    positions and D features shared k rows to an image, on the card."""
    dev = _card()
    cfg, p = make(256, D, 128, 512, 97)
    p = p.to(dev)
    g = torch.Generator(device="cpu").manual_seed(seed)
    n = images * k
    a = torch.rand(images, L, D, generator=g).to(dev, dtype)
    att_enc = TD.attention_precompute(p.to(dtype), a).contiguous()
    e, h, c = (torch.randn(n, w, generator=g).to(dev, dtype) for w in (256, 512, 512))
    return KS.step_weights(p, cfg, dtype), cfg, e, h, c, a, att_enc


@pytest.mark.parametrize("k", [1, 3, 20])
@pytest.mark.parametrize("L", [1, 49, 169, 196])
@pytest.mark.parametrize("D", [300, 576, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_step_kernel(k, L, D, dtype):
    """The step kernels at N = 8 k rows over 8 images: against the plain
    version (which repeats each image k-fold), and bit for bit equal to the
    same call on k-fold copies and to a second call (every sum over a row in
    a fixed order, whatever k; no float atomics)."""
    lw, cfg, e, h, c, a, att_enc = _grouped_step_args(k, L, D, dtype)
    rep = lambda x: x.repeat_interleave(k, 0).contiguous()
    n0 = KS.launches
    got = KS.fused_decoder_step(lw, cfg, e, h, c, a, att_enc)
    again = KS.fused_decoder_step(lw, cfg, e, h, c, a, att_enc)
    copied = KS.fused_decoder_step(lw, cfg, e, h, c, rep(a), rep(att_enc))
    ref = KS.fused_decoder_step_plain(lw, cfg, e, h, c, a, att_enc)
    torch.cuda.synchronize()
    assert KS.launches == n0 + 3
    for name, x, y, z, r in zip(("t", "h'", "c'", "z", "alpha"), got, again, copied, ref):
        assert torch.equal(x, y) and torch.equal(x, z), name
        scale = max(1.0, r.float().abs().max().item())
        # bf16 outputs may differ by one rounding step of the output type
        tol = (1e-4 if dtype == torch.float32 else 1e-2) * scale
        assert (x.float() - r.float()).abs().max().item() <= tol, name


def test_grouped_wrapper_rejects_uneven_rows():
    lw, cfg, e, h, c, a, att_enc = _grouped_step_args(3, 5, 300, torch.float32)
    with pytest.raises(ValueError, match="multiple of the images"):
        KS.fused_decoder_step(lw, cfg, e[:-1], h[:-1], c[:-1], a, att_enc)
    with pytest.raises(ValueError, match="att_enc"):
        KS.fused_decoder_step(lw, cfg, e, h, c, a, att_enc[:4].contiguous())


@pytest.mark.parametrize("shape", LOOP_SHAPES)
@pytest.mark.parametrize("tying,embed_norm", [(False, None), (True, 1.5)])
@pytest.mark.parametrize("temperature", [1.0, 0.7])
def test_loop_kernel(shape, tying, embed_norm, temperature):
    dev = _card()
    E, D, A, H, V, L, B = shape
    cfg, p = make(E, D, A, H, V, tying=tying, embed_norm=embed_norm)
    p = p.to(dev)
    g = torch.Generator(device="cpu").manual_seed(2)
    a = torch.randn(B, L, D, generator=g).to(dev)
    n0 = KL.launches
    got = greedy_decode(p, cfg, a, max_gen_length=12, temperature=temperature,
                        fused="loop")
    ref = greedy_decode(p, cfg, a, max_gen_length=12, temperature=temperature,
                        fused=False)
    torch.cuda.synchronize()
    assert KL.launches == n0 + 1
    same = (got.tokens == ref.tokens).all(-1)[:, 0] & (got.lengths == ref.lengths)[:, 0]
    assert same.float().mean().item() >= 0.99
    assert (got.scores - ref.scores)[same].abs().max().item() <= 1e-3
    assert (got.alphas - ref.alphas)[same].abs().max().item() <= 1e-4


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("early_exit", [False, True])
def test_beam_search_runs_the_step_kernels(shape, early_exit):
    """beam_search on the card by default: the step kernels at B k rows, one
    call per executed step, with the plain path's best hypotheses."""
    dev = _card()
    E, D, A, H, V, L, B = shape
    B = min(B, 64)
    cfg, p = make(E, D, A, H, V)
    p = p.to(dev)
    g = torch.Generator(device="cpu").manual_seed(3)
    a = torch.randn(B, L, D, generator=g).to(dev)
    kw = dict(beamk=3, max_gen_length=12, rescore_method="LN",
              early_exit=early_exit)
    n0 = KS.launches
    got = beam_search(p, cfg, a, **kw)
    ran = KS.launches - n0
    ref = beam_search(p, cfg, a, fused=False, **kw)
    torch.cuda.synchronize()
    assert 1 <= ran <= 13 and (ran == 13 or early_exit)
    best = lambda r: r.tokens[torch.arange(B), r.scores.argmax(1)]
    same = (best(got) == best(ref)).all(-1)
    assert same.float().mean().item() >= 0.99
    assert torch.isfinite(got.scores).all()
    assert (got.scores.max(1).values - ref.scores.max(1).values)[same].abs().max() <= 1e-3
    with pytest.raises(ValueError, match="decoder_noise"):
        beam_search(p, cfg, a, decoder_noise=0.5, fused=True, **kw)
    n0 = KS.launches      # the default takes the plain path with noise (JAX's rule)
    beam_search(p, cfg, a, decoder_noise=0.5, **kw)
    beam_search(p, cfg, a, decoder_noise=0.5, fused=False, **kw)
    assert KS.launches == n0


def _loop_args(shape, dtype=torch.float32, seed=2):
    """The loop kernels' arguments at ``shape`` with seeded weights and
    annotations on the card."""
    dev = _card()
    E, D, A, H, V, L, B = shape
    cfg, p = make(E, D, A, H, V)
    p = p.to(dev).to(dtype)
    g = torch.Generator(device="cpu").manual_seed(seed)
    a = torch.randn(B, L, D, generator=g).to(dev, dtype)
    att_enc = TD.attention_precompute(p, a).contiguous()
    h, c = TD.init_lstm_state(p, a, cfg)
    return (*KL.loop_weights(p, cfg, dtype), cfg, a, att_enc, h[0].contiguous(),
            c[0].contiguous())


def test_loop_kernel_ties_go_to_the_lower_index():
    """Wout and bout repeat the first vocabulary tile across all 256 tiles,
    so every logit of a row ties with its copies, bit for bit, in other
    tiles: the kernel picks the lowest unmasked copy (a column of the first
    tile, or of the second for a copy of PAD's column 0; never END, whose
    copy in the first tile is lower), as its plain version does."""
    n = KL.VOCAB_TILE
    lw, emb, wout, bout, cfg, *rest = _loop_args(WIDE_VOCAB[0])
    V = bout.shape[0]
    base = torch.arange(V, device=bout.device) % n
    wout[:, :V] = wout[:, base]
    bout = bout[base].contiguous()
    args = (lw, emb, wout, bout, cfg, *rest)
    got = KL.greedy_loop(*args, max_gen_length=12)
    ref = KL.greedy_loop_plain(*args, max_gen_length=12)
    torch.cuda.synchronize()
    words = got[0][:, 1:]
    assert ((words >= 1) & (words < 2 * n)).all() and not got[4].any()
    assert ((words < n) | (words % n == 0)).all()
    same = (got[0] == ref[0]).all(-1) & (got[3] == ref[3])
    assert same.float().mean().item() >= 0.99
    assert (got[2] - ref[2])[same].abs().max().item() <= 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_loop_kernel_repeats_bit_for_bit(dtype):
    """No float is summed by atomics: two calls at V 4,096 give the same
    tokens, lengths, scores and alphas, bit for bit."""
    args = _loop_args(WIDE_VOCAB[0], dtype)
    first = KL.greedy_loop(*args, max_gen_length=20)
    second = KL.greedy_loop(*args, max_gen_length=20)
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)


# the (L, D) of chip_smoke.py phases 13-15 at E 256, A 128, H 512: resnet50 at
# encoder_size 14, mobilenet_v3_small, densenet121, squeezenet1_1
PHASE_WIDTHS = [(196, 2048), (49, 576), (49, 1024), (169, 512)]


@pytest.mark.parametrize("L,D", PHASE_WIDTHS)
def test_bf16_step_at_phase_widths(L, D):
    """The bf16 step (its products on the tensor cores) as beam search calls
    it, N = 192 rows over 64 images (k = 3), at each configuration of
    chip_smoke.py phases 13-15: each output within 1e-2 of its scale of the
    plain version (one rounding step of bf16 outputs), and a second call
    bit for bit (no float atomics)."""
    lw, cfg, e, h, c, a, att_enc = _grouped_step_args(3, L, D, torch.bfloat16, images=64)
    got = KS.fused_decoder_step(lw, cfg, e, h, c, a, att_enc)
    again = KS.fused_decoder_step(lw, cfg, e, h, c, a, att_enc)
    ref = KS.fused_decoder_step_plain(lw, cfg, e, h, c, a, att_enc)
    torch.cuda.synchronize()
    for name, x, y, r in zip(("t", "h'", "c'", "z", "alpha"), got, again, ref):
        assert torch.equal(x, y), name
        scale = max(1.0, r.float().abs().max().item())
        assert (x.float() - r.float()).abs().max().item() <= 1e-2 * scale, name


@pytest.mark.parametrize("L,D", PHASE_WIDTHS)
def test_bf16_loop_at_phase_widths(L, D):
    """The bf16 loop at the reference's 4,096 words and B 64, at each
    configuration of chip_smoke.py phases 13-15, against its plain version
    as ``chip_smoke.check_loop`` holds it: tokens and lengths equal on >=
    90 % of rows (one rounding of a near tie changes a row's path), scores
    and alphas within 1e-1 on those rows; a second call bit for bit."""
    args = _loop_args((256, D, 128, 512, 4096, L, 64), torch.bfloat16)
    first = KL.greedy_loop(*args, max_gen_length=20)
    second = KL.greedy_loop(*args, max_gen_length=20)
    ref = KL.greedy_loop_plain(*args, max_gen_length=20)
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)
    same = (first[0] == ref[0]).all(-1) & (first[3] == ref[3]) & (first[4] == ref[4])
    assert same.float().mean().item() >= 0.9
    assert (first[2] - ref[2])[same].abs().max().item() <= 1e-1
    assert (first[1] - ref[1])[same].abs().max().item() <= 1e-1


def test_loop_kernel_stops_once_every_row_finished():
    """Every row emits END at step 1: the device count of finished rows
    reaches B, the kernels of the later steps return at once, and those steps
    hold the PAD tokens and zero alphas of ``greedy_loop_plain``.  A count
    preset to B stops every step."""
    dev = _card()
    E, D, A, H, V, L, B = SHAPES[0]
    cfg, p = make(E, D, A, H, V)
    p.out_proj.b[V - 1] += 50.0   # END wins wherever it is not masked
    p = p.to(dev)
    g = torch.Generator(device="cpu").manual_seed(3)
    a = torch.randn(B, L, D, generator=g).to(dev)
    att_enc = TD.attention_precompute(p, a).contiguous()
    h, c = TD.init_lstm_state(p, a, cfg)
    args = (*KL.loop_weights(p, cfg, torch.float32), cfg, a, att_enc,
            h[0].contiguous(), c[0].contiguous())
    S, pad = 12, cfg.vocab_stoi["<PAD>"]
    done = torch.zeros(1, dtype=torch.int32, device=dev)
    got = KL.run_loop(*args, S, 1.0, done)
    ref = KL.greedy_loop_plain(*args, max_gen_length=S)
    torch.cuda.synchronize()
    assert done.item() == B
    assert ref[4].all() and (ref[3] == 1).all()
    for x, y in zip((got[0], got[3], got[4]), (ref[0], ref[3], ref[4])):
        assert torch.equal(x, y)
    assert (got[2] - ref[2]).abs().max().item() <= 1e-3
    assert (got[1] - ref[1]).abs().max().item() <= 1e-4
    assert (got[0][:, 3:] == pad).all() and (got[1][:, 2:] == 0).all()
    idle = KL.run_loop(*args, S, 1.0,
                       torch.full((1,), B, dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    assert (idle[0][:, 1:] == pad).all()
    assert (idle[1] == 0).all() and (idle[2] == 0).all() and not idle[4].any()


def test_wrapper_rejects_bad_input():
    dev = _card()
    cfg, p = make(8, 16, 8, 12, 24)
    p = p.to(dev)
    a = torch.randn(4, 3, 16, device=dev)
    att_enc = TD.attention_precompute(p, a)
    h, c = TD.init_lstm_state(p, a, cfg)
    lw = KS.step_weights(p, cfg)
    e = torch.randn(4, 8, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        KS.fused_decoder_step(lw, cfg, e, h[0], c[0], a, att_enc)   # h[0] strided
    with pytest.raises(ValueError, match="float16"):
        KS.fused_decoder_step(lw, cfg, e.half(), h[0].half(), c[0].half(),
                              a.half(), att_enc.half())


@pytest.mark.parametrize("precision", ["32", "16"])
def test_serve_runs_the_step_kernels(tmp_path, precision):
    """``serve.main`` on the card: 10 PNGs and a corrupt file at batch 4
    (three batches, the last padded) through the step kernels, one call per
    executed decode step; at float32 the captions of the same run on the
    CPU, scores within 1e-4."""
    _card()
    import json

    from sat_tpu_torch import serve
    from sat_tpu_torch.data.images import write_png
    from sat_tpu_torch.models.jax_import import model_to_jax_tree
    from sat_tpu_torch.models.model import SATModel
    from sat_tpu_torch.train.checkpoints import save_checkpoint

    V, S = 40, 8
    stoi = {f"w{i}": i for i in range(1, V - 3)}
    stoi.update({"<UNK>": V - 3, "<START>": V - 2, "<END>": V - 1, "<PAD>": 0})
    cfg = SATConfig(encoder_arch="shufflenet_v2_x0_5", input_size=64,
                    encoder_dim=32, vocab_size=V, vocab_stoi=stoi, embed_dim=16,
                    attention_dim=16, decoder_dim=32, deep_output=True)
    model = SATModel.create(cfg, torch.Generator().manual_seed(0))
    ck = str(tmp_path / "m.ckpt")
    save_checkpoint(ck, model.cfg, dict(model_to_jax_tree(model), step=0, epoch=0))
    rng = np.random.default_rng(0)
    for i in range(10):
        write_png(str(tmp_path / f"i{i}.png"),
                  rng.integers(0, 255, (80, 100, 3), dtype=np.uint8))
    (tmp_path / "k_corrupt.png").write_text("not an image at all")
    argv = ["--checkpoint", ck, "--images", str(tmp_path / "*.png"), "--batch", "4",
            "--beamk", "3", "--max_gen_length", str(S), "--precision", precision]
    n0 = KS.launches
    assert serve.main(argv + ["--output", str(tmp_path / "card.jsonl")]) == 0
    ran = KS.launches - n0
    assert 3 <= ran <= 3 * (S + 1)
    recs = [json.loads(l) for l in open(tmp_path / "card.jsonl")]
    assert len(recs) == 11 and sum("error" in r for r in recs) == 1
    assert all(np.isfinite(r["score"]) for r in recs if "error" not in r)
    if precision == "32":
        assert serve.main(argv + ["--output", str(tmp_path / "cpu.jsonl")],
                          device="cpu") == 0
        cpu = [json.loads(l) for l in open(tmp_path / "cpu.jsonl")]
        same = [a for a, b in zip(recs, cpu) if a.get("caption") == b.get("caption")]
        assert len(same) >= 10
        for a, b in zip(recs, cpu):
            if "error" not in a and a["caption"] == b["caption"]:
                assert abs(a["score"] - b["score"]) <= 1e-4


def test_mesh_ranks_on_the_card(tmp_path):
    """Two gloo ranks sharing the card (tests/_torch_mesh_rank.py, group
    "card"), on the meshes (2,) and (1, 2) data model: one step's gradients
    equal the one-process step's at tests/test_parallel.py:83's tolerance
    (the vocab slices joined), and beam search
    of each rank's rows runs the step kernels and gives the one-process
    tokens, its scores within 1e-5."""
    import json
    import os
    import subprocess
    import sys

    import _torch_mesh_rank as RK
    _card()
    torch.backends.cudnn.allow_tf32 = False
    ref = RK.step_and_beam(RK.card_model(torch.device("cuda")), RK.make_batch(0))
    ctx = tmp_path / "ctx.json"
    ctx.write_text(json.dumps({"out": str(tmp_path)}))
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.path.dirname(here))
    procs = [subprocess.Popen([sys.executable, os.path.join(here, "_torch_mesh_rank.py"),
                               "card", str(r), "2", str(tmp_path / "init"), str(ctx)],
                              env=env) for r in range(2)]
    assert [p.wait(timeout=600) for p in procs] == [0, 0]
    res = [torch.load(tmp_path / f"card_card_rank{r}.pt", weights_only=False)
           for r in range(2)]
    for tag in ("dp", "tp"):
        got = [r[tag] for r in res]
        assert abs(got[0]["loss"] - ref["loss"]) <= 1e-5 * abs(ref["loss"]), (
            tag, got[0]["loss"], ref["loss"])
        for name, g in ref["grads"].items():
            keys = name.split(".")
            ax = (0 if "embedding" in keys or keys[-1] == "b" else 1) \
                if tag == "tp" and ("embedding" in keys or "out_proj" in keys) else None
            full = got[0]["grads"][name] if ax is None else torch.cat(
                [x["grads"][name] for x in got], dim=ax)
            # tests/test_parallel.py:83's tolerance
            atol = max(5e-4 * float(g.abs().max().clamp(min=1e-3)), 2e-7)
            gap = float((full - g).abs().max())
            assert gap <= atol, (tag, name, gap, atol)
        for x in got:
            gap = float((x["scores"] - ref["scores"]).abs().max())
            assert x["launches"] > 0 and ref["launches"] > 0, (tag, x["launches"])
            assert torch.equal(x["tokens"], ref["tokens"]), (tag, gap)
            assert gap <= 1e-5, (tag, gap)

