"""The port's teacher-forced loss (sat_tpu_torch.models.sat and
ops.label_smoothing), its gradients, its dropout and the decoder's init,
against sat_tpu on the CPU at float32: n64 decoder widths (E 256, A 128,
H 512, V 97, D 1024, L 49), B = 2 images with R = 5 captions of T = 8."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sat_tpu.config import SATConfig as JaxConfig
from sat_tpu.models import decoder as JD
from sat_tpu.models import sat as JS
from sat_tpu.ops import label_smoothing as JLS
from sat_tpu_torch.config import SATConfig
from sat_tpu_torch.models import decoder as TD
from sat_tpu_torch.models import sat as TS
from sat_tpu_torch.models.jax_import import decoder_from_jax
from sat_tpu_torch.ops import label_smoothing as TLS
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

B, R, T, L, V = 2, 5, 8, 49, 97
METRICS = ("loss", "ce_loss", "att_loss", "accuracy")


def configs(layers=1, deep=True, tying=False, embed_norm=None, smoothing=0.1):
    stoi = {f"w{i}": i for i in range(1, V - 3)}
    stoi.update({"<UNK>": V - 3, "<START>": V - 2, "<END>": V - 1, "<PAD>": 0})
    kw = dict(vocab_size=V, vocab_stoi=stoi, embed_dim=256, encoder_dim=1024,
              attention_dim=128, decoder_dim=512, decoder_layers=layers,
              deep_output=deep, weight_tying=tying, embed_norm=embed_norm,
              label_smoothing=smoothing, att_gamma=1.0)
    return JaxConfig(**kw), SATConfig(**kw)


def params(jcfg, seed=0):
    """JAX's init, and the same weights as a trainable ParamTree."""
    jp = JD.init_decoder_params(jax.random.PRNGKey(seed), jcfg)
    tp = decoder_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    return jp, tp.requires_grad_(True)


def batch(seed=1):
    rng = np.random.default_rng(seed)
    annots = rng.normal(size=(B, L, 1024)).astype(np.float32)
    lens = rng.integers(2, T, size=(B, R)).astype(np.int32)
    lens[0, 0] = T - 1                        # one caption fills every step
    caps = np.zeros((B, R, T), np.int32)
    caps[..., 0] = V - 2
    for i in range(B):
        for r in range(R):
            n = lens[i, r]
            caps[i, r, 1:n] = rng.integers(1, V - 3, size=n - 1)
            caps[i, r, n] = V - 1
    return annots, caps, lens


def np_(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_metrics(got, ref, rtol=1e-5):
    for k in METRICS:
        np.testing.assert_allclose(np_(got[k]), np_(ref[k]), rtol=rtol,
                                   atol=1e-7, err_msg=k)


def grads_of(tp):
    return {n: p.grad.numpy() for n, p in tp.named_parameters()}


def flat_jax(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_jax(v, prefix + k + "."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_label_smoothing_and_accuracy(smoothing):
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(4, 6, V)).astype(np.float32) * 3
    targets = rng.integers(0, V, size=(4, 6))
    targets[0, :3] = logits[0, :3].argmax(-1)          # some hits
    mask = rng.uniform(size=(4, 6)) < 0.7
    ref = JLS.label_smoothing_loss(jnp.asarray(logits), jnp.asarray(targets),
                                   jnp.asarray(mask), smoothing)
    got = TLS.label_smoothing_loss(torch.from_numpy(logits),
                                   torch.from_numpy(targets),
                                   torch.from_numpy(mask), smoothing)
    np.testing.assert_allclose(np_(got), np_(ref), rtol=1e-5)
    acc = TLS.masked_token_accuracy(torch.from_numpy(logits),
                                    torch.from_numpy(targets),
                                    torch.from_numpy(mask))
    ref_acc = JLS.masked_token_accuracy(jnp.asarray(logits),
                                        jnp.asarray(targets), jnp.asarray(mask))
    np.testing.assert_allclose(np_(acc), np_(ref_acc), rtol=1e-5)
    assert float(acc) > 0
    # an all-false mask divides by max(sum, 1): zero, not NaN
    none = torch.zeros(4, 6, dtype=torch.bool)
    assert float(TLS.label_smoothing_loss(torch.from_numpy(logits),
                                          torch.from_numpy(targets), none)) == 0.0


@pytest.mark.parametrize("epsilon", [0.0, 1.0])
def test_train_forward_and_sat_loss(epsilon):
    jcfg, tcfg = configs()
    jp, tp = params(jcfg)
    annots, caps, lens = batch()
    flat_c, flat_l = caps.reshape(B * R, T), lens.reshape(B * R)
    rep = np.repeat(annots, R, axis=0)
    logits, targets, alphas = JS.train_forward(
        jp, jcfg, jnp.asarray(rep), jnp.asarray(flat_c), jnp.asarray(flat_l),
        jnp.float32(epsilon), None)
    tl, tt, ta = TS.train_forward(tp, tcfg, torch.from_numpy(rep),
                                  torch.from_numpy(flat_c),
                                  torch.from_numpy(flat_l), epsilon)
    np.testing.assert_array_equal(np_(tt), np_(targets))
    np.testing.assert_allclose(np_(tl), np_(logits), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np_(ta), np_(alphas), rtol=1e-4, atol=1e-6)
    assert (np_(ta)[np.arange(T - 1)[None] >= flat_l[:, None]] == 0).all()
    ref = JS.sat_loss(jcfg, logits, targets, jnp.asarray(flat_l), alphas)
    got = TS.sat_loss(tcfg, tl, tt, torch.from_numpy(flat_l), ta)
    assert_metrics(got, ref)


# (epsilon, label smoothing, decoder variant)
CASES = [
    (1.0, 0.1, {}), (0.0, 0.1, {}),
    (1.0, 0.0, {"tying": True}), (0.0, 0.0, {"tying": True}),
    (1.0, 0.1, {"deep": False}),
    (0.0, 0.1, {"embed_norm": 0.8}),
    (1.0, 0.1, {"embed_norm": 0.8, "tying": True}),
    (1.0, 0.1, {"layers": 2}), (0.0, 0.0, {"layers": 2}),
]


@pytest.mark.parametrize("epsilon,smoothing,variant", CASES)
def test_grouped_loss_and_grads(epsilon, smoothing, variant):
    """Loss terms within rtol 1e-5, and every decoder gradient against
    jax.value_and_grad within rtol 1e-4, atol 1e-6.  With ``embed_norm``,
    JAX's gradient of the zero <PAD> row is NaN (the norm's derivative at
    zero, reached when the tied table or a PAD input is capped); the port's
    is finite there, and that row is left out of the comparison."""
    jcfg, tcfg = configs(smoothing=smoothing, **variant)
    jp, tp = params(jcfg)
    annots, caps, lens = batch()

    def f(p):
        m = JS.train_forward_loss_grouped(
            p, jcfg, jnp.asarray(annots), jnp.asarray(caps), jnp.asarray(lens),
            jnp.float32(epsilon), None)
        return m["loss"], m

    (_, ref), jgrads = jax.value_and_grad(f, has_aux=True)(jp)
    got = TS.train_forward_loss_grouped(
        tp, tcfg, torch.from_numpy(annots), torch.from_numpy(caps),
        torch.from_numpy(lens), epsilon)
    assert_metrics(got, ref)
    got["loss"].backward()
    tg, jg = grads_of(tp), flat_jax(jgrads)
    assert tg.keys() == jg.keys()
    for name, g in jg.items():
        t = tg[name]
        if name == "embedding" and tcfg.embed_norm is not None:
            assert np.isnan(g[0]).all() == tcfg.weight_tying
            assert np.isfinite(g[1:]).all() and np.isfinite(t).all()
            g, t = g[1:], t[1:]
        np.testing.assert_allclose(t, g, rtol=1e-4, atol=1e-6, err_msg=name)
    assert np.abs(tg["lstm.layer_0.w_ih"]).max() > 1e-4   # the test has teeth


@pytest.mark.parametrize("epsilon", [0.0, 1.0])
def test_grouped_equals_flat(epsilon):
    """The grouped loss is train_forward + sat_loss on repeated annotations,
    and train_forward_loss (flat rows) is JAX's."""
    jcfg, tcfg = configs()
    jp, tp = params(jcfg)
    annots, caps, lens = batch(seed=3)
    a, c, l = map(torch.from_numpy, (annots, caps, lens))
    grouped = TS.train_forward_loss_grouped(tp, tcfg, a, c, l, epsilon)
    fc, fl, r = TS.flatten_caption_batch(c, l)
    rep = TS.repeat_annotations(a, r)
    flat = TS.sat_loss(tcfg, *TS.train_forward(tp, tcfg, rep, fc, fl, epsilon)[:2],
                       fl, TS.train_forward(tp, tcfg, rep, fc, fl, epsilon)[2])
    assert_metrics(grouped, flat)
    inline = TS.train_forward_loss(tp, tcfg, rep, fc, fl, epsilon)
    ref = JS.train_forward_loss(jp, jcfg, jnp.asarray(rep.numpy()),
                                jnp.asarray(fc.numpy()), jnp.asarray(fl.numpy()),
                                jnp.float32(epsilon), None)
    assert_metrics(inline, ref)


def test_dropout():
    x = torch.randn(400, 500, generator=torch.Generator().manual_seed(0)) + 2.0
    g = torch.Generator().manual_seed(1)
    assert TD._dropout(x, 0.0, g) is x
    assert TD._dropout(x, 0.5, None) is x
    y = TD._dropout(x, 0.5, g)
    zero = (y == 0).float().mean().item()
    assert abs(zero - 0.5) < 0.01
    kept = y != 0
    torch.testing.assert_close(y[kept], x[kept] * 2.0)
    assert abs(y.mean().item() / x.mean().item() - 1.0) < 0.01
    # separate draws: two calls on one generator give different masks
    assert not torch.equal(TD._dropout(x, 0.5, g) == 0, y == 0)


@pytest.mark.parametrize("deep,tying,layers", [(True, False, 1), (True, True, 2),
                                               (False, False, 1)])
def test_init_decoder_params(deep, tying, layers):
    """The JAX tree and shapes, the zero <PAD> row, beta's bias 1/H and the
    uniform bounds; the draws themselves differ (another generator)."""
    jcfg, tcfg = configs(deep=deep, tying=tying, layers=layers)
    jp = flat_jax(jax.tree_util.tree_map(np.asarray, JD.init_decoder_params(
        jax.random.PRNGKey(0), jcfg)))
    tp = TD.init_decoder_params(torch.Generator().manual_seed(0), tcfg)
    got = {n: p.detach().numpy() for n, p in tp.named_parameters()}
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in jp.items()}
    assert (got["embedding"][0] == 0).all()
    assert abs(got["embedding"][1:].std() - 1.0) < 0.02
    np.testing.assert_array_equal(got["beta.b"], np.full(1024, 1 / 512, np.float32))
    for name, w in got.items():
        if name in ("embedding", "beta.b"):
            continue
        if name.startswith("lstm"):
            fan_in = 512
        else:   # a bias takes its weight's fan-in
            fan_in = got[name[:-1] + "w"].shape[0]
        k = 1 / np.sqrt(fan_in)
        assert np.abs(w).max() <= k and np.abs(w).max() > 0.9 * k, name
        # U(-k, k) has standard deviation k / sqrt(3)
        if w.size > 1000:
            assert abs(w.std() / (k / np.sqrt(3)) - 1) < 0.05, name
    assert not any(p.requires_grad for p in tp.parameters())
