"""The step kernels' grouped rows on the CPU: N = Bi k rows over the
(Bi, L, .) annotations and att_enc of Bi images, row r reading image r // k,
as beam search's k slots read their image.

The step's plain version on grouped inputs is held against JAX's Pallas step
(``sat_tpu.kernels.decoder_step.fused_decoder_step`` in interpret mode) on
the same inputs repeated k-fold, which is how the TPU kernel takes them.
Tolerances, of each output's scale (its largest magnitude, at least 1):
float32 1e-5, because the sums are taken in another order; bfloat16 2^-7,
one bfloat16 step, because both round to bfloat16 at the same points and
two float32 sums taken in another order can straddle a rounding boundary.
The CUDA kernels are held against this plain version on the card
(``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sat_tpu.config import SATConfig as JaxConfig
from sat_tpu.kernels import decoder_step as JK
from sat_tpu.models import decoder as JD
from sat_tpu_torch.config import SATConfig
from sat_tpu_torch.decode import beam as TB
from sat_tpu_torch.decode.beam import LOOP_ROUTE, STEP_ROUTE, decode_route
from sat_tpu_torch.kernels import decoder_step as KS
from sat_tpu_torch.models import decoder as TD
from sat_tpu_torch.models.jax_import import decoder_from_jax
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

J = jnp.asarray
T = torch.from_numpy
DTYPES = {"float32": (torch.float32, jnp.float32, 1e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2.0 ** -7)}


def make(D, deep=True, seed=3, v=31):
    """Both packages' decoders from one JAX initialisation, narrow widths
    around encoder dim D."""
    stoi = {f"w{i}": i for i in range(1, v - 3)}
    stoi.update({"<UNK>": v - 3, "<START>": v - 2, "<END>": v - 1, "<PAD>": 0})
    kw = dict(vocab_size=v, vocab_stoi=stoi, embed_dim=10, encoder_dim=D,
              attention_dim=8, decoder_dim=16, deep_output=deep)
    jp = JD.init_decoder_params(jax.random.PRNGKey(seed), JaxConfig(**kw))
    jp = jax.tree_util.tree_map(np.asarray, jp)
    return JaxConfig(**kw), SATConfig(**kw), jp, decoder_from_jax(jp)


def grouped_inputs(jp, cfg, bi, k, L, seed):
    """float32 numpy e, h, c (N = bi k rows), annotations and att_enc (bi
    images)."""
    rng = np.random.default_rng(seed)
    n = bi * k
    a = rng.normal(size=(bi, L, cfg.encoder_dim)).astype(np.float32)
    att_enc = np.array(JD.attention_precompute(jp, J(a)), np.float32)
    e, h, c = (rng.normal(size=(n, w)).astype(np.float32)
               for w in (cfg.embed_dim, cfg.decoder_dim, cfg.decoder_dim))
    return e, h, c, a, att_enc


# (k, images): N past the port's 64-row tile at every k
GROUPS = [(1, 71), (3, 24), (5, 15)]
SHAPES = [(7, 300), (13, 36)]   # (L, D): odd L, D not a multiple of 256


@pytest.mark.parametrize("k,bi", GROUPS)
@pytest.mark.parametrize("L,D", SHAPES)
@pytest.mark.parametrize("deep", [True, False])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_grouped_plain_step_matches_pallas_on_copies(k, bi, L, D, deep, dtype):
    tdt, jdt, rel = DTYPES[dtype]
    jcfg, tcfg, jp, tp = make(D, deep=deep)
    e, h, c, a, att_enc = grouped_inputs(jp, jcfg, bi, k, L, seed=k * 100 + L)
    rep = lambda x: np.repeat(x, k, axis=0)
    ref = JK.fused_decoder_step(JK.pack_fused_weights(jp, jcfg, jdt), jcfg,
                                *(J(x).astype(jdt) for x in (e, h, c, rep(a),
                                                             rep(att_enc))),
                                interpret=True)
    tx = [T(x).to(tdt) for x in (e, h, c, a, att_enc)]
    lw = KS.step_weights(tp, tcfg, tdt)
    got = KS.fused_decoder_step_plain(lw, tcfg, *tx)
    # the CPU route of the wrapper is the plain version
    wrapped = KS.fused_decoder_step(lw, tcfg, *tx)
    for name, g, w, r in zip(("t", "h'", "c'", "z", "alpha"), got, wrapped, ref):
        r = np.asarray(r.astype(jnp.float32))
        assert g.shape == r.shape and g.dtype == w.dtype, name
        assert torch.equal(g, w), name
        scale = max(1.0, float(np.abs(r).max()))
        err = float(np.abs(g.float().numpy() - r).max())
        assert err <= rel * scale, f"{name}: {err} > {rel} * {scale}"


@pytest.mark.parametrize("k", [1, 3, 5])
def test_grouped_plain_step_is_the_step_on_copies(k):
    """Grouped rows give what k-fold copies of each image give, bit for bit."""
    jcfg, tcfg, jp, tp = make(36)
    e, h, c, a, att_enc = grouped_inputs(jp, jcfg, 5, k, 9, seed=k)
    lw = KS.step_weights(tp, tcfg)
    got = KS.fused_decoder_step(lw, tcfg, *map(T, (e, h, c, a, att_enc)))
    want = KS.fused_decoder_step(lw, tcfg, *map(T, (e, h, c)),
                                 *(T(np.repeat(x, k, axis=0)) for x in (a, att_enc)))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n,bi", [(7, 3), (5, 2), (4, 0), (2, 5)])
def test_uneven_rows_raise(n, bi):
    """N must be a whole number of rows for each image."""
    jcfg, tcfg, jp, tp = make(36)
    lw = KS.step_weights(tp, tcfg)
    rng = np.random.default_rng(0)
    x = lambda *s: T(rng.normal(size=s).astype(np.float32))
    args = (x(n, 10), x(n, 16), x(n, 16), x(bi, 5, 36), x(bi, 5, 8))
    for fn in (KS.fused_decoder_step, KS.fused_decoder_step_plain):
        with pytest.raises(ValueError, match="multiple of the images"):
            fn(lw, tcfg, *args)
    with pytest.raises(ValueError, match="multiple of the images"):
        KS.rows_per_image(n, bi)
    assert KS.rows_per_image(12, 4) == 3 and KS.rows_per_image(0, 0) == 1


@pytest.mark.parametrize("beamk", [1, 3, 20])
def test_beam_kernel_route_passes_each_image_once(monkeypatch, beamk):
    """beam_search(fused=True) hands the step (B, L, .) annotations and
    att_enc for its B k rows, with the result of the plain path."""
    jcfg, tcfg, jp, tp = make(36)
    a = T(np.random.default_rng(11).normal(size=(3, 6, 36)).astype(np.float32))
    seen = []
    step = TB.fused_decoder_step

    def checked(lw, cfg, prev_embed, h, c, annotations, att_enc):
        seen.append((prev_embed.shape[0], annotations.shape, att_enc.shape))
        return step(lw, cfg, prev_embed, h, c, annotations, att_enc)

    monkeypatch.setattr(TB, "fused_decoder_step", checked)
    kw = dict(beamk=beamk, max_gen_length=6, rescore_method="LN")
    got = TB.beam_search(tp, tcfg, a, fused=True, **kw)
    assert len(seen) == 7
    for n, ashape, eshape in seen:
        assert n == 3 * beamk and ashape == (3, 6, 36) and eshape == (3, 6, 8)
    ref = TB.beam_search(tp, tcfg, a, fused=False, **kw)
    np.testing.assert_array_equal(got.tokens.numpy(), ref.tokens.numpy())
    np.testing.assert_allclose(got.scores.numpy(), ref.scores.numpy(), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("L", [1, 49, 169, 196, 58112])
def test_route_keeps_the_step_kernels(L):
    """The grouped kernels take every L the route took before: each row's L
    scores within a block's shared memory (58,112 of them)."""
    cfg = SATConfig(encoder_dim=2048, attention_dim=128, decoder_dim=512,
                    embed_dim=256)
    assert decode_route(torch.device("cuda"), cfg, L) == STEP_ROUTE
    assert decode_route(torch.device("cuda"), cfg, L, greedy=True) == LOOP_ROUTE
    assert decode_route(torch.device("cuda"), cfg, L + 58112) != STEP_ROUTE
