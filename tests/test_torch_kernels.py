"""The plain PyTorch versions of the two CUDA kernels against JAX, and the
wrappers' CPU routing.  The CUDA kernels themselves are held against these
plain versions on the card by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sat_tpu.config import SATConfig as JaxConfig
from sat_tpu.decode.beam import greedy_decode as jax_greedy
from sat_tpu.kernels import decoder_step as JK
from sat_tpu.models import decoder as JD
from sat_tpu_torch.config import SATConfig
from sat_tpu_torch.decode.beam import decode_route, greedy_decode, select_fused
from sat_tpu_torch.kernels import decoder_step as KS
from sat_tpu_torch.kernels import greedy_loop as KL
from sat_tpu_torch.models import decoder as TD
from sat_tpu_torch.models.jax_import import decoder_from_jax
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

J = jnp.asarray
T = torch.from_numpy


def make(deep=True, tying=False, embed_norm=None, end_bias=0.0, layers=1,
         seed=3, v=31, **widths):
    stoi = {f"w{i}": i for i in range(1, v - 3)}
    stoi.update({"<UNK>": v - 3, "<START>": v - 2, "<END>": v - 1, "<PAD>": 0})
    kw = dict(vocab_size=v, vocab_stoi=stoi, embed_dim=10, encoder_dim=8,
              attention_dim=8, decoder_dim=16, decoder_layers=layers,
              deep_output=deep, weight_tying=tying, embed_norm=embed_norm)
    kw.update(widths)
    jp = JD.init_decoder_params(jax.random.PRNGKey(seed), JaxConfig(**kw))
    jp = jax.tree_util.tree_map(np.asarray, jp)
    if end_bias:
        jp["out_proj"]["b"] = jp["out_proj"]["b"].copy()
        jp["out_proj"]["b"][v - 1] += end_bias
    return JaxConfig(**kw), SATConfig(**kw), jp, decoder_from_jax(jp)


def annots(cfg, b=6, L=5, seed=7):
    return np.random.default_rng(seed).normal(
        size=(b, L, cfg.encoder_dim)).astype(np.float32)


@pytest.mark.parametrize("deep,tying", [(True, False), (False, False),
                                        (True, True)])
def test_step_plain_matches_jax(deep, tying):
    """One call at a tiny shape: the plain step against decoder_step and the
    Pallas kernel in interpret mode."""
    jcfg, tcfg, jp, tp = make(deep=deep, tying=tying)
    rng = np.random.default_rng(0)
    n, L = 5, 6
    a = rng.normal(size=(n, L, jcfg.encoder_dim)).astype(np.float32)
    e = rng.normal(size=(n, jcfg.embed_dim)).astype(np.float32)
    h = rng.normal(size=(1, n, jcfg.decoder_dim)).astype(np.float32)
    c = rng.normal(size=(1, n, jcfg.decoder_dim)).astype(np.float32)
    j_enc = JD.attention_precompute(jp, J(a))
    ref_logits, ref_h, ref_c, ref_z, ref_alpha = JD.decoder_step(
        jp, jcfg, J(e), J(h), J(c), J(a), j_enc)
    pal = JK.fused_decoder_step(JK.pack_fused_weights(jp, jcfg), jcfg, J(e),
                                J(h[0]), J(c[0]), J(a), j_enc, interpret=True)

    lw = KS.step_weights(tp, tcfg)
    t_enc = TD.attention_precompute(tp, T(a))
    got = KS.fused_decoder_step_plain(lw, tcfg, T(e), T(h[0]), T(c[0]), T(a), t_enc)
    logits = KS.fused_output_logits(tp, tcfg, got[0], TD.capped_embedding(tp, tcfg))
    for g, r in zip(got[1:], (ref_h[0], ref_c[0], ref_z, ref_alpha)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-5)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), rtol=0,
                               atol=1e-5)
    for g, r in zip(got, pal):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-5)


@pytest.mark.parametrize("n", [1, 9, 70])
@pytest.mark.parametrize("deep", [True, False])
def test_step_plain_on_packed_weights_matches_pallas(n, deep):
    """The step kernels' plain version, on the packed weights the phase
    kernels index, against the Pallas step kernel in interpret mode: one row,
    rows past the TPU's 8-row tile and past the port's 64-row tile.  Float32
    sums in another order: 1e-5."""
    jcfg, tcfg, jp, tp = make(deep=deep)
    rng = np.random.default_rng(n)
    L, E, D, H = 6, jcfg.embed_dim, jcfg.encoder_dim, jcfg.decoder_dim
    a = rng.normal(size=(n, L, D)).astype(np.float32)
    e, h, c = (rng.normal(size=(n, k)).astype(np.float32) for k in (E, H, H))
    att_enc = np.array(JD.attention_precompute(jp, J(a)))
    ref = JK.fused_decoder_step(JK.pack_fused_weights(jp, jcfg), jcfg, J(e), J(h),
                                J(c), J(a), J(att_enc), interpret=True)
    got = KS.fused_decoder_step_plain(KS.step_weights(tp, tcfg), tcfg, T(e), T(h),
                                      T(c), T(a), T(att_enc))
    for name, g, r in zip(("t", "h'", "c'", "z", "alpha"), got, ref):
        assert g.shape == r.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-5,
                                   err_msg=name)


def _jax_run(jp, jcfg, a, S, temperature, fused=False):
    r = jax_greedy(jp, jcfg, J(a), max_gen_length=S, temperature=temperature,
                   fused=fused)
    return {k: np.asarray(getattr(r, k)) for k in r._fields}


def _port_run(tp, tcfg, a, S, temperature, fused):
    r = greedy_decode(tp, tcfg, T(a), max_gen_length=S,
                      temperature=temperature, fused=fused)
    return {k: getattr(r, k).numpy() for k in r._fields}


def _assert_same(got, ref, alphas=True):
    np.testing.assert_array_equal(got["tokens"], ref["tokens"])
    np.testing.assert_array_equal(got["lengths"], ref["lengths"])
    np.testing.assert_allclose(got["raw_scores"], ref["raw_scores"], atol=1e-5)
    np.testing.assert_allclose(got["perplexity"], ref["perplexity"], rtol=1e-5)
    if alphas:
        np.testing.assert_allclose(got["alphas"], ref["alphas"], atol=1e-6)


@pytest.mark.parametrize("temperature", [1.0, 0.7])
@pytest.mark.parametrize("fused", ["loop", True])
def test_kernel_plain_versions_match_scan(temperature, fused):
    """With an END bias rows finish at different steps; the plain versions of
    both kernels must give the scan's tokens, lengths, scores and alphas."""
    jcfg, tcfg, jp, tp = make(end_bias=1.0)
    a = annots(jcfg, b=9)
    ref = _jax_run(jp, jcfg, a, 8, temperature)
    lengths = ref["lengths"][:, 0]
    assert (lengths < 8).any() and len(set(lengths.tolist())) > 1
    _assert_same(_port_run(tp, tcfg, a, 8, temperature, fused), ref)


@pytest.mark.parametrize("fused", ["loop", True])
def test_embed_norm_matches_scan(fused):
    """embed_norm with tied weights: the kernels' capped table serves the
    lookup and the projection, as decoder_step does."""
    jcfg, tcfg, jp, tp = make(tying=True, embed_norm=0.9)
    a = annots(jcfg)
    _assert_same(_port_run(tp, tcfg, a, 6, 1.0, fused),
                 _jax_run(jp, jcfg, a, 6, 1.0))


def test_finished_row_alphas():
    """Every row finishes at step 1.  The port's loop matches the scan on
    tokens, scores and alphas; the JAX loop kernel matches on tokens and
    scores but keeps writing the finished rows' alphas."""
    jcfg, tcfg, jp, tp = make(end_bias=1.5)
    a = annots(jcfg, b=4)
    scan = _jax_run(jp, jcfg, a, 6, 1.0)
    assert (scan["lengths"] == 1).all()
    port = _port_run(tp, tcfg, a, 6, 1.0, "loop")
    _assert_same(port, scan)
    assert (port["alphas"][:, :, 2:] == 0).all()
    pallas = _jax_run(jp, jcfg, a, 6, 1.0, fused="loop")
    _assert_same(pallas, scan, alphas=False)
    assert np.abs(pallas["alphas"] - scan["alphas"]).max() > 1e-2


@pytest.mark.parametrize("jax_fused", [False, "loop"])
def test_loop_at_a_wide_vocabulary_matches_jax(jax_fused):
    """The port's loop kernel path (its plain version on CPU tensors, which
    reads the packed Wout) at V 4,099, a vocabulary of 257 tiles whose last
    holds three words, against JAX's scan and its Pallas loop kernel in
    interpret mode."""
    jcfg, tcfg, jp, tp = make(v=4099, embed_dim=8, decoder_dim=12,
                              encoder_dim=16, attention_dim=8)
    a = annots(jcfg, b=13, L=5)
    _assert_same(_port_run(tp, tcfg, a, 4, 1.0, "loop"),
                 _jax_run(jp, jcfg, a, 4, 1.0, fused=jax_fused))


def test_cpu_tensors_take_the_plain_version():
    jcfg, tcfg, jp, tp = make(end_bias=1.0)
    a = T(annots(jcfg))
    step0, loop0 = KS.launches, KL.launches
    att_enc = TD.attention_precompute(tp, a)
    h, c = TD.init_lstm_state(tp, a, tcfg)
    e = TD.embed_tokens(tp, torch.tensor([28] * 6), tcfg)
    lw = KS.step_weights(tp, tcfg)
    got = KS.fused_decoder_step(lw, tcfg, e, h[0], c[0], a, att_enc)
    ref = KS.fused_decoder_step_plain(lw, tcfg, e, h[0], c[0], a, att_enc)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    loop = KL.greedy_loop_decode(tp, tcfg, a, att_enc, h[0].contiguous(),
                                 c[0].contiguous(), max_gen_length=5)
    plain = KL.greedy_loop_plain(*KL.loop_weights(tp, tcfg, torch.float32),
                                 tcfg, a, att_enc, h[0], c[0], max_gen_length=5)
    for g, r in zip(loop, plain):
        assert torch.equal(g, r)
    greedy_decode(tp, tcfg, a, max_gen_length=5)   # fused=None on the CPU
    assert (KS.launches, KL.launches) == (step0, loop0)


def test_other_devices_raise():
    jcfg, tcfg, jp, tp = make()
    a = T(annots(jcfg)).to("meta")
    meta = decoder_from_jax(jp).to("meta")
    att_enc = TD.attention_precompute(meta, a)
    h, c = TD.init_lstm_state(meta, a, tcfg)
    with pytest.raises(ValueError, match="no kernel"):
        KL.greedy_loop_decode(meta, tcfg, a, att_enc, h[0], c[0],
                              max_gen_length=3)
    lw = KS.step_weights(meta, tcfg)
    with pytest.raises(ValueError, match="no kernel"):
        KS.fused_decoder_step(lw, tcfg, torch.zeros(6, 10, device="meta"),
                              h[0], c[0], a, att_enc)


def test_gates():
    _, n64, _, _ = make(v=97)
    n64 = n64.replace(embed_dim=256, encoder_dim=1024, attention_dim=128,
                      decoder_dim=512)
    greedy = lambda cfg, L: decode_route(torch.device("cuda"), cfg, L, greedy=True)
    assert greedy(n64, 49) == "loop kernel"
    assert KS.fused_step_supported(n64, 49)
    assert greedy(n64.replace(decoder_layers=2), 49) == "plain (decoder_layers 2)"
    assert not KS.fused_step_supported(n64.replace(decoder_layers=2), 49)
    big = n64.replace(vocab_size=60000)  # no kernel holds a logits row
    assert greedy(big, 196) == "loop kernel"
    # only attend's L scores per block count
    assert KS.fused_step_supported(big, 196)
    assert KS.fused_step_supported(n64, 58112)       # 232,448 bytes of scores
    assert not KS.fused_step_supported(n64, 58113)


def test_two_layer_default_is_plain():
    """On CPU tensors the default runs the plain path for any depth."""
    jcfg, tcfg, jp, tp = make(layers=2)
    a = annots(jcfg)
    _assert_same(_port_run(tp, tcfg, a, 5, 1.0, None),
                 _jax_run(jp, jcfg, a, 5, 1.0))
    with pytest.raises(ValueError, match="decoder_layers"):
        _port_run(tp, tcfg, a, 5, 1.0, "loop")


def _n64(**kw):
    _, cfg, _, _ = make(v=97)
    return cfg.replace(embed_dim=256, encoder_dim=1024, attention_dim=128,
                       decoder_dim=512, **kw)


@pytest.mark.parametrize("cfg_kw,device,want", [
    ({}, "cuda", "loop"),
    ({"vocab_size": 60000}, "cuda", "loop"),  # no V-wide state in the loop kernels
    ({"decoder_layers": 2}, "cpu", False),
    ({}, "cpu", False),
])
def test_default_selection(cfg_kw, device, want):
    """fused=None: the loop kernel on the card where it fits, else the step
    kernel; the plain path only for CPU tensors."""
    assert select_fused(None, torch.device(device), _n64(**cfg_kw), 49) == want


@pytest.mark.parametrize("fused", [None, True, "loop"])
def test_two_layer_kernel_paths_raise_on_the_card(fused):
    """A two-layer stack on a CUDA device: either kernel asked for raises;
    the default takes the plain path by the stated rule (decode_route)."""
    cuda, cfg2 = torch.device("cuda"), _n64(decoder_layers=2)
    if fused is None:
        assert select_fused(None, cuda, cfg2, 49) is False
        assert decode_route(cuda, cfg2, 49, greedy=True) == "plain (decoder_layers 2)"
    else:
        with pytest.raises(ValueError, match="decoder_layers"):
            select_fused(fused, cuda, cfg2, 49)
    assert select_fused(False, torch.device("cuda"),
                        _n64(decoder_layers=2), 49) is False
