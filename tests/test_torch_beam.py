"""Beam search and the caption API of sat_tpu_torch against sat_tpu's, on
the CPU at float32: the golden checkpoint's pinned tokens, the n64
checkpoint for every rescore method with and without early exit, the step
kernels' path (their plain version at B k rows), the sampling modes and the
hidden-state noise under noise shared by both packages, and the helpers."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sat_tpu.decode import beam as JB
from sat_tpu.models import decoder as JD
from sat_tpu.train.checkpoints import load_model_from_checkpoint as jax_load
from sat_tpu_torch.decode import beam as TB
from sat_tpu_torch.kernels import decoder_step as KS
from sat_tpu_torch.models import decoder as TD
from sat_tpu_torch.train.checkpoints import load_model_from_checkpoint
from test_torch_greedy import scenes
from test_torch_kernels import _n64, make
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
K, S = 3, 20
ATOL_SCORE = 1e-4   # float32 sums of up to 21 log-probs
ATOL_ALPHA = 1e-5   # softmax weights in [0, 1]


@pytest.fixture(scope="module")
def n64():
    """Both packages' n64 models and JAX's annotations of 4 scenes."""
    path = os.path.join(DATA, "best_n64_r4_serving.ckpt")
    jm, jv, _ = jax_load(path)
    tm, _ = load_model_from_checkpoint(path, device="cpu")
    imgs = scenes(4, jm.cfg.input_size, seed=0)
    janns = np.array(jm.encode(jv, jnp.asarray(imgs), train=False))
    return jm, jv, tm, imgs, janns


def _jax(n64, **kw):
    jm, jv, _, _, janns = n64
    res = JB.beam_search(jv["params"]["decoder"], jm.cfg, jnp.asarray(janns),
                         **kw)
    return jax.tree_util.tree_map(np.asarray, res)


def _port(n64, **kw):
    _, _, tm, _, janns = n64
    return TB.beam_search(tm.decoder, tm.cfg, torch.from_numpy(janns), **kw)


def _assert_same(got, ref, atol_score=ATOL_SCORE, atol_alpha=ATOL_ALPHA):
    np.testing.assert_array_equal(got.tokens.numpy(), ref.tokens)
    np.testing.assert_array_equal(got.lengths.numpy(), ref.lengths)
    for f in ("raw_scores", "scores", "perplexity"):
        np.testing.assert_allclose(getattr(got, f).numpy(), getattr(ref, f),
                                   rtol=0, atol=atol_score, err_msg=f)
    # alpha rows below each length are the ones a caption uses
    used = np.arange(ref.alphas.shape[2]) < ref.lengths[..., None]
    np.testing.assert_allclose(got.alphas.numpy()[used], ref.alphas[used],
                               rtol=0, atol=atol_alpha)


def test_golden_tokens():
    model, _ = load_model_from_checkpoint(os.path.join(DATA, "golden_v1.ckpt"),
                                          device="cpu")
    imgs = (np.arange(2 * 32 * 32 * 3, dtype=np.float32)
            .reshape(2, 32, 32, 3) % 256.0) / 255.0
    res = TB.beam_search(model.decoder, model.cfg,
                         model.encode(torch.from_numpy(imgs)), beamk=2,
                         max_gen_length=6, rescore_method="LN")
    with open(os.path.join(DATA, "golden_v1_expect.json")) as f:
        want = json.load(f)["tokens"]
    np.testing.assert_array_equal(res.tokens.numpy(), np.asarray(want))


@pytest.mark.parametrize("early_exit", [False, True])
@pytest.mark.parametrize("rescore_method", [None, "LN", "WR", "BAR"])
def test_beam_matches_jax(n64, rescore_method, early_exit):
    kw = dict(beamk=K, max_gen_length=S, rescore_method=rescore_method,
              early_exit=early_exit)
    ref = _jax(n64, **kw)
    got = _port(n64, **kw)
    _assert_same(got, ref)
    assert got.tokens.dtype == torch.int32 and got.lengths.dtype == torch.int32
    assert got.alphas.shape == (4, K, S + 1, n64[4].shape[1])
    assert (ref.lengths < S).all()   # every hypothesis ends: the test sees <END>


@pytest.mark.parametrize("rescore_method", [None, "LN"])
def test_kernel_path_on_cpu(n64, rescore_method):
    """fused=True on CPU tensors: the step kernels' plain version at B k rows,
    with JAX's default path as the reference (JAX's own fused path skips
    embed_norm, ROADMAP.md section 3)."""
    kw = dict(beamk=K, max_gen_length=S, rescore_method=rescore_method)
    step0 = KS.launches
    fused = _port(n64, fused=True, **kw)
    plain = _port(n64, fused=False, **kw)
    assert KS.launches == step0     # CPU tensors launch nothing
    ref = _jax(n64, **kw)
    np.testing.assert_array_equal(fused.tokens.numpy(), plain.tokens.numpy())
    np.testing.assert_allclose(fused.scores.numpy(), plain.scores.numpy(),
                               rtol=0, atol=1e-5)
    _assert_same(fused, ref, atol_score=1e-5)


def test_kernel_path_small_config():
    """The twin of test_fused_beam_and_sharding.py's fused check: random
    narrow weights, beamk 4, both port paths against JAX's beam search."""
    jcfg, tcfg, jp, tp = make()
    a = np.random.default_rng(7).normal(size=(3, 6, 8)).astype(np.float32)
    kw = dict(beamk=4, max_gen_length=12, rescore_method="LN")
    ref = jax.tree_util.tree_map(np.asarray, JB.beam_search(
        jp, jcfg, jnp.asarray(a), **kw))
    for fused in (False, True):
        got = TB.beam_search(tp, tcfg, torch.from_numpy(a), fused=fused, **kw)
        np.testing.assert_array_equal(got.tokens.numpy(), ref.tokens)
        np.testing.assert_allclose(got.scores.numpy(), ref.scores, rtol=0,
                                   atol=1e-5)


def test_fused_rules(monkeypatch):
    _, tcfg, _, tp = make()
    a = torch.ones(2, 6, 8)
    with pytest.raises(ValueError, match="decoder_noise"):
        TB.beam_search(tp, tcfg, a, beamk=2, max_gen_length=4,
                       decoder_noise=0.5, fused=True)
    _, tcfg2, _, tp2 = make(layers=2)
    with pytest.raises(ValueError, match="decoder_layers"):
        TB.beam_search(tp2, tcfg2, a, beamk=2, max_gen_length=4, fused=True)
    with pytest.raises(ValueError, match="loop kernel"):
        TB.beam_search(tp, tcfg, a, beamk=2, max_gen_length=4, fused="loop")

    # fused=None on CPU tensors: the plain path (the step is never called)
    def no_kernel(*args):
        raise AssertionError("the step kernels' path ran")
    monkeypatch.setattr(TB, "fused_decoder_step", no_kernel)
    TB.beam_search(tp, tcfg, a, beamk=2, max_gen_length=4)
    TB.beam_search(tp2, tcfg2, a, beamk=2, max_gen_length=4, decoder_noise=0.5)


@pytest.mark.parametrize("fused,layers,noisy,want", [
    (None, 1, False, True), (None, 1, True, False),
    (None, 2, False, False), (False, 2, True, False),
    (True, 1, False, True),
])
def test_selection_on_the_card(fused, layers, noisy, want):
    """On a CUDA device the default takes the step kernels where JAX's rule
    does (one LSTM layer, no decoder noise: sat_tpu/decode/beam.py's
    use_fused) and the plain path elsewhere."""
    cfg = _n64(decoder_layers=layers)
    dev = torch.device("cuda")
    if want is ValueError:
        with pytest.raises(ValueError):
            TB.select_beam_fused(fused, dev, cfg, 49, noisy)
    else:
        assert TB.select_beam_fused(fused, dev, cfg, 49, noisy) is want
    assert TB.select_beam_fused(None, torch.device("cpu"), cfg, 49, noisy) is False


@pytest.mark.parametrize("sample_method,noise", [
    ("multinomial", None), ("topk", None), ("beam", 0.5)])
def test_sampling_under_shared_noise(n64, monkeypatch, sample_method, noise):
    """One fixed numpy array stands in for every Gumbel or normal draw of
    both packages, so the tokens must agree exactly."""
    jm, _, tm, _, janns = n64
    b, v, H = janns.shape[0], tm.cfg.vocab_size, tm.cfg.decoder_dim
    rng = np.random.default_rng(5)
    g = rng.gumbel(size=(b, K, v)).astype(np.float32)
    z = rng.normal(size=(1, b, K, H)).astype(np.float32)
    monkeypatch.setattr(jax.random, "gumbel",
                        lambda key, shape=(), *a, **kw: jnp.asarray(g.reshape(shape)))
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape=(), *a, **kw: jnp.asarray(z.reshape(shape)))
    monkeypatch.setattr(TB, "gumbel_noise",
                        lambda shape, gen, dev: torch.from_numpy(g).reshape(shape))
    monkeypatch.setattr(TB, "normal_noise",
                        lambda shape, gen, dev: torch.from_numpy(z).reshape(shape))
    kw = dict(beamk=K, max_gen_length=S, sample_method=sample_method,
              decoder_noise=noise, rescore_method="LN")
    ref, got = _jax(n64, **kw), _port(n64, **kw)
    np.testing.assert_array_equal(got.tokens.numpy(), ref.tokens)
    np.testing.assert_array_equal(got.lengths.numpy(), ref.lengths)
    np.testing.assert_allclose(got.scores.numpy(), ref.scores, rtol=0,
                               atol=ATOL_SCORE)


def test_sampling_runs_with_the_generator(n64):
    """The real draws: a seeded generator repeats itself; None is seed 0."""
    kw = dict(beamk=K, max_gen_length=8, sample_method="multinomial",
              decoder_noise=0.5)
    a = _port(n64, generator=torch.Generator().manual_seed(0), **kw)
    b = _port(n64, **kw)
    assert torch.equal(a.tokens, b.tokens)
    assert torch.isfinite(a.scores).all()


def test_temperature_list(n64):
    kw = dict(beamk=K, max_gen_length=S, temperature=[0.5, 1.0, 2.0],
              rescore_method="LN")
    _assert_same(_port(n64, **kw), _jax(n64, **kw))


@pytest.mark.parametrize("k", [1, 2, 3, 8, 9])
def test_topk_small_matches_lax_topk(k):
    """Integer-valued rows, many exact ties: the same order as lax.top_k, and
    as JAX's topk_small with signed zeros too (its k <= 8 passes tie -0.0
    with 0.0, where lax.top_k puts 0.0 first)."""
    rng = np.random.default_rng(7)
    for shape in ((5, 64), (2, 3, 40), (9, 33)):
        x = np.round(rng.standard_normal(shape) * 2).astype(np.float32)
        for data, ref in ((x + 0.0, jax.lax.top_k), (x, JB.topk_small)):
            v, i = TB.topk_small(torch.from_numpy(data), k)
            vr, ir = ref(jnp.asarray(data), k)
            np.testing.assert_array_equal(i.numpy(), np.asarray(ir))
            np.testing.assert_array_equal(v.numpy(), np.asarray(vr))


@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("k", [1, 3, 5])
def test_init_lstm_state_beams(layers, k):
    jcfg, tcfg, jp, tp = make(layers=layers)
    a = np.random.default_rng(1).normal(size=(3, 6, 8)).astype(np.float32)
    for got, ref in zip(TD.init_lstm_state_beams(tp, torch.from_numpy(a), tcfg, k),
                        JD.init_lstm_state_beams(jp, jnp.asarray(a), jcfg, k)):
        assert got.shape == (layers, 3, k, tcfg.decoder_dim)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def golden():
    path = os.path.join(DATA, "golden_v1.ckpt")
    jm, jv, _ = jax_load(path)
    tm, _ = load_model_from_checkpoint(path, device="cpu")
    imgs = np.random.default_rng(0).uniform(size=(4, 32, 32, 3)).astype(np.float32)
    return jm, jv, tm, imgs, None


# the port's encoder differs from JAX's folded one by up to 1e-5 of the
# feature peak at n64 (test_torch_encoder.py), which carries into the
# scores and alphas; the golden checkpoint's narrow encoder agrees to 3e-8
# (the same tolerances as test_torch_greedy.py's whole slice)
CAPTION_ATOL = {"golden": (ATOL_SCORE, ATOL_ALPHA), "n64": (5e-4, 5e-5)}


@pytest.mark.parametrize("return_all", [False, True])
@pytest.mark.parametrize("ckpt", ["golden", "n64"])
def test_caption_matches_jax(request, ckpt, return_all):
    jm, jv, tm, imgs, _ = request.getfixturevalue(ckpt)
    atol_score, atol_alpha = CAPTION_ATOL[ckpt]
    kw = dict(beamk=K, max_gen_length=S, rescore_method="LN",
              return_all=return_all)
    tcaps, tscores, talphas, tppl = tm.caption(torch.from_numpy(imgs), **kw)
    jcaps, jscores, jalphas, jppl = jm.caption(jv, jnp.asarray(imgs), **kw)
    assert tcaps == jcaps
    np.testing.assert_allclose(np.array(tscores), np.array(jscores), rtol=0,
                               atol=atol_score)
    np.testing.assert_allclose(np.array(tppl), np.array(jppl), rtol=1e-4)
    flat = (lambda x: [m for row in x for m in row]) if return_all else list
    for ta, ja in zip(flat(talphas), flat(jalphas)):
        assert ta.shape == ja.shape and ta.shape[1:] == tuple(tm.grid_hw)
        np.testing.assert_allclose(ta, ja, rtol=0, atol=atol_alpha)
