"""Every inference function of sat_tpu_torch.models.decoder and ops.lstm
against its sat_tpu counterpart, on random parameters, at float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sat_tpu.config import SATConfig as JaxConfig
from sat_tpu.models import decoder as JD
from sat_tpu.ops import lstm as JL
from sat_tpu_torch.config import SATConfig
from sat_tpu_torch.models import decoder as TD
from sat_tpu_torch.models.jax_import import decoder_from_jax
from sat_tpu_torch.ops import lstm as TL
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ATOL = 1e-5  # float32, sums of at most a few hundred terms


def make(layers=1, deep=True, tying=False, embed_norm=None, seed=0):
    v = 29
    stoi = {f"w{i}": i for i in range(1, v - 3)}
    stoi.update({"<UNK>": v - 3, "<START>": v - 2, "<END>": v - 1, "<PAD>": 0})
    kw = dict(vocab_size=v, vocab_stoi=stoi, embed_dim=10, encoder_dim=12,
              attention_dim=9, decoder_dim=14, decoder_layers=layers,
              deep_output=deep, weight_tying=tying, embed_norm=embed_norm)
    jparams = JD.init_decoder_params(jax.random.PRNGKey(seed), JaxConfig(**kw))
    tparams = decoder_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    return JaxConfig(**kw), SATConfig(**kw), jparams, tparams


def inputs(cfg, b=5, L=7, seed=1):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return dict(annot=f(b, L, cfg.encoder_dim), embed=f(b, cfg.embed_dim),
                h=f(cfg.decoder_layers, b, cfg.decoder_dim) * 0.5,
                c=f(cfg.decoder_layers, b, cfg.decoder_dim) * 0.5,
                ids=rng.integers(0, cfg.vocab_size, size=(b,)))


def close(got, ref, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=atol)


J = jnp.asarray
T = torch.from_numpy


@pytest.mark.parametrize("embed_norm", [None, 0.8])
def test_embed_tokens(embed_norm):
    jcfg, tcfg, jp, tp = make(embed_norm=embed_norm)
    x = inputs(jcfg)
    close(TD.embed_tokens(tp, T(x["ids"]), tcfg),
          JD.embed_tokens(jp, J(x["ids"]), jcfg))


@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("batch_reshape", [False, True])
def test_init_lstm_state(layers, batch_reshape):
    jcfg, tcfg, jp, tp = make(layers=layers)
    x = inputs(jcfg)
    jh, jc = JD.init_lstm_state(jp, J(x["annot"]), jcfg,
                                batch_reshape=batch_reshape)
    th, tc = TD.init_lstm_state(tp, T(x["annot"]), tcfg,
                                batch_reshape=batch_reshape)
    assert th.shape == jh.shape == (layers, 5, jcfg.decoder_dim)
    close(th, jh)
    close(tc, jc)


def test_attention_and_beta():
    jcfg, tcfg, jp, tp = make()
    x = inputs(jcfg)
    j_enc = JD.attention_precompute(jp, J(x["annot"]))
    t_enc = TD.attention_precompute(tp, T(x["annot"]))
    close(t_enc, j_enc)
    jz, ja = JD.soft_attention(jp, j_enc, J(x["annot"]), J(x["h"][0]))
    tz, ta = TD.soft_attention(tp, t_enc, T(x["annot"]), T(x["h"][0]))
    close(tz, jz)
    close(ta, ja)
    close(TD.beta_gate(tp, T(x["h"][0])), JD.beta_gate(jp, J(x["h"][0])))


@pytest.mark.parametrize("deep,tying,embed_norm", [
    (True, False, None), (False, False, None), (True, True, None),
    (True, True, 0.8), (False, True, 0.8)])
def test_deep_output(deep, tying, embed_norm):
    jcfg, tcfg, jp, tp = make(deep=deep, tying=tying, embed_norm=embed_norm)
    x = inputs(jcfg)
    z = x["annot"][:, 0]
    ref = JD.deep_output(jp, jcfg, J(x["embed"]), J(x["h"][0]), J(z))
    got = TD.deep_output(tp, tcfg, T(x["embed"]), T(x["h"][0]), T(z))
    assert got.shape == ref.shape == (5, jcfg.vocab_size)
    close(got, ref)


@pytest.mark.parametrize("layers", [1, 2])
def test_lstm(layers):
    jcfg, tcfg, jp, tp = make(layers=layers)
    x = inputs(jcfg)
    xin = np.concatenate([x["embed"], x["annot"][:, 0]], axis=-1)
    jc0 = JL.lstm_cell(J(xin), J(x["h"][0]), J(x["c"][0]), jp["lstm"]["layer_0"])
    tc0 = TL.lstm_cell(T(xin), T(x["h"][0]), T(x["c"][0]), tp.lstm.layer_0)
    close(tc0[0], jc0[0])
    close(tc0[1], jc0[1])
    jh, jc = JL.lstm_stack_step(J(xin), J(x["h"]), J(x["c"]), jp["lstm"])
    th, tc = TL.lstm_stack_step(T(xin), T(x["h"]), T(x["c"]), tp.lstm)
    close(th, jh)
    close(tc, jc)


@pytest.mark.parametrize("layers,deep,tying,embed_norm", [
    (1, True, False, None), (2, True, False, None), (1, False, False, None),
    (2, False, False, None), (1, True, True, 0.8), (2, True, True, 0.8)])
def test_decoder_step(layers, deep, tying, embed_norm):
    jcfg, tcfg, jp, tp = make(layers=layers, deep=deep, tying=tying,
                              embed_norm=embed_norm)
    x = inputs(jcfg)
    j_enc = JD.attention_precompute(jp, J(x["annot"]))
    ref = JD.decoder_step(jp, jcfg, J(x["embed"]), J(x["h"]), J(x["c"]),
                          J(x["annot"]), j_enc)
    got = TD.decoder_step(tp, tcfg, T(x["embed"]), T(x["h"]), T(x["c"]),
                          T(x["annot"]), TD.attention_precompute(tp, T(x["annot"])))
    for g, r in zip(got, ref):
        assert tuple(g.shape) == tuple(r.shape)
        close(g, r)


def test_param_tree_names():
    _, _, jp, tp = make(layers=2, deep=True)
    flat = {k for k in tp.state_dict()}
    assert {"att_dec.w", "lstm.layer_0.w_ih", "lstm.layer_1.b_hh", "embedding",
            "out_proj.b", "beta.b"} <= flat
    assert all(not p.requires_grad for p in tp.parameters())
    np.testing.assert_array_equal(tp.lstm.layer_1.w_hh.numpy(),
                                  np.asarray(jp["lstm"]["layer_1"]["w_hh"]))
