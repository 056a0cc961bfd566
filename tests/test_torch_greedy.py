"""The whole slice: checkpoint -> encode -> greedy_decode -> captions, port
against JAX on the CPU at float32, on both committed checkpoints."""

import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sat_tpu.data.compositional import render_scene
from sat_tpu.decode.api import unpack_beam_result as jax_unpack
from sat_tpu.decode.beam import greedy_decode as jax_greedy
from sat_tpu.train.checkpoints import load_model_from_checkpoint as jax_load
from sat_tpu_torch.decode.api import unpack_beam_result
from sat_tpu_torch.decode.beam import greedy_decode
from sat_tpu_torch.train.checkpoints import load_model_from_checkpoint
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")


def scenes(n, size, seed):
    """Images from the n64 checkpoint's training distribution."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        cells = rng.choice(9, size=int(rng.integers(1, 3)), replace=False)
        objs = [dict(cell=int(c), color=0, shape=int(rng.integers(0, 8)),
                     texture=int(rng.integers(0, 8)), size=int(rng.integers(0, 2)))
                for c in cells]
        out.append(render_scene(size, objs, rng))
    return np.stack(out).astype(np.float32) / 255.0


@pytest.fixture(scope="module", params=["golden_v1.ckpt", "best_n64_r4_serving.ckpt"])
def both(request):
    path = os.path.join(DATA, request.param)
    jm, jv, _ = jax_load(path)
    tm, _ = load_model_from_checkpoint(path, device="cpu")
    size = jm.cfg.input_size
    if size == 224:
        imgs = scenes(4, size, seed=0)
    else:
        imgs = np.random.default_rng(0).uniform(size=(4, size, size, 3)).astype(np.float32)
    S = 20
    jr = jax_greedy(jv["params"]["decoder"], jm.cfg,
                    jm.encode(jv, jnp.asarray(imgs), train=False),
                    max_gen_length=S)
    return jm, jv, tm, imgs, S, jr


def _words(model, caps):
    return [" ".join(model.vocab.itos(t) for t in c) for c in caps]


@pytest.mark.parametrize("fused", [None, True, "loop"])
def test_greedy_captions_match_jax(both, fused):
    jm, jv, tm, imgs, S, jr = both
    # the decoder alone, on JAX's annotations
    janns = np.array(jm.encode(jv, jnp.asarray(imgs), train=False))
    dec = greedy_decode(tm.decoder, tm.cfg, torch.from_numpy(janns),
                        max_gen_length=S, fused=fused)
    np.testing.assert_array_equal(dec.tokens.numpy(), np.asarray(jr.tokens))
    np.testing.assert_array_equal(dec.lengths.numpy(), np.asarray(jr.lengths))
    np.testing.assert_allclose(dec.scores.numpy(), np.asarray(jr.scores),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(dec.alphas.numpy(), np.asarray(jr.alphas),
                               rtol=0, atol=1e-5)

    # the whole slice: the port's encoder differs from JAX's folded one by up
    # to 1e-5 of the feature peak (~200 at n64, test_torch_encoder.py), and
    # that difference carries through ~15 decode steps into the scores
    tr = greedy_decode(tm.decoder, tm.cfg, tm.encode(torch.from_numpy(imgs)),
                       max_gen_length=S, fused=fused)
    np.testing.assert_array_equal(tr.tokens.numpy(), np.asarray(jr.tokens))
    np.testing.assert_array_equal(tr.lengths.numpy(), np.asarray(jr.lengths))
    np.testing.assert_allclose(tr.scores.numpy(), np.asarray(jr.scores), rtol=0,
                               atol=5e-4)
    np.testing.assert_allclose(tr.alphas.numpy(), np.asarray(jr.alphas), rtol=0,
                               atol=5e-5)
    tcaps, tscores, talphas, tppl = unpack_beam_result(tr, tm.grid_hw)
    jcaps, jscores, jalphas, jppl = jax_unpack(jr, jm.grid_hw)
    assert tcaps == jcaps
    assert _words(tm, tcaps) == [" ".join(jm.vocab.itos(t) for t in c) for c in jcaps]
    np.testing.assert_allclose(tscores, jscores, rtol=0, atol=5e-4)
    np.testing.assert_allclose(tppl, jppl, rtol=1e-4)
    for ta, ja in zip(talphas, jalphas):
        assert ta.shape == ja.shape
        np.testing.assert_allclose(ta, ja, rtol=0, atol=5e-5)


def test_n64_captions_finish(both):
    jm, _, tm, imgs, S, jr = both
    if jm.cfg.input_size != 224:
        return
    lengths = np.asarray(jr.lengths)[:, 0]
    assert (lengths < S).all()
    caps = _words(tm, unpack_beam_result(
        greedy_decode(tm.decoder, tm.cfg, tm.encode(torch.from_numpy(imgs)),
                      max_gen_length=S), tm.grid_hw)[0])
    assert all(c.startswith("a ") for c in caps)


@pytest.mark.parametrize("fused", [False, True, "loop"])
def test_early_exit_equals_fixed_length(both, fused):
    _, _, tm, imgs, S, _ = both
    annots = tm.encode(torch.from_numpy(imgs))
    a = greedy_decode(tm.decoder, tm.cfg, annots, max_gen_length=S, fused=fused)
    b = greedy_decode(tm.decoder, tm.cfg, annots, max_gen_length=S, fused=fused,
                      early_exit=True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_rescore_methods(both):
    jm, jv, tm, imgs, _, _ = both
    annots = tm.encode(torch.from_numpy(imgs))
    for method in ("LN", "wr", "BAR", "none"):
        tr = greedy_decode(tm.decoder, tm.cfg, annots, max_gen_length=6,
                           rescore_method=method, rescore_reward=0.3)
        jr = jax_greedy(jv["params"]["decoder"], jm.cfg,
                        jnp.asarray(annots.numpy()), max_gen_length=6,
                        rescore_method=method, rescore_reward=0.3)
        np.testing.assert_allclose(tr.scores.numpy(), np.asarray(jr.scores),
                                   rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="rescore_method"):
        greedy_decode(tm.decoder, tm.cfg, annots, max_gen_length=2,
                      rescore_method="ln2")


def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_model_from_checkpoint(os.path.join(DATA, "golden_v1.ckpt"))


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "import sat_tpu_torch\n"
        "for m in pkgutil.walk_packages(sat_tpu_torch.__path__, 'sat_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'msgpack', 'sat_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules if m.startswith('sat_tpu_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_no_jax_import_lines():
    pat = re.compile(r"^\s*(import|from) (jax|flax|msgpack|sat_tpu)\b")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, dirs, names in os.walk(os.path.join(ROOT, "sat_tpu_torch")):
        dirs[:] = [x for x in dirs if x != "build"]   # compiled kernels, not source
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    for f in files:
        with open(f) as fh:
            for i, line in enumerate(fh, 1):
                assert not pat.match(line), f"{f}:{i}: {line.strip()}"
