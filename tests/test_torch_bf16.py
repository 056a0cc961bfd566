"""The serving precision, bf16, on the CPU: both packages' n64 models with
every float leaf cast to bfloat16 (as sat_tpu/serve.py --precision 16 does),
encode + beam search (beamk 3, LN, early exit) and greedy decoding.

The bar is what bf16 decoding alone costs: the port's bf16 decoder on the
f32 encoder's annotations keeps the f32 best caption on 6 of 8 images
(beam and greedy).  Each decoder meets it against JAX's on the same bf16
annotations.  The bf16 encoders do not: each package's is far from its own
f32 encoder and from the other's, so the end-to-end bf16 captions agree
neither with f32 nor across the packages; test_bf16_encoders_far_apart pins
that gap (ROADMAP.md section 3)."""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sat_tpu.decode.api import unpack_beam_result as jax_unpack
from sat_tpu.decode.beam import beam_search as jax_beam
from sat_tpu.decode.beam import greedy_decode as jax_greedy
from sat_tpu.train.checkpoints import load_model_from_checkpoint as jax_load
from sat_tpu_torch.decode.api import unpack_beam_result
from sat_tpu_torch.decode.beam import beam_search, greedy_decode
from sat_tpu_torch.train.checkpoints import load_model_from_checkpoint
from test_torch_greedy import scenes
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

CKPT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "best_n64_r4_serving.ckpt")
N = 8
BAR = 0.75              # best-caption agreement that bf16 decoding alone keeps
BEAM = dict(beamk=3, max_gen_length=20, rescore_method="LN", early_exit=True)
GREEDY = dict(max_gen_length=20)
# bf16 keeps 8 bits: 2^-8 relative per rounding, some tens of roundings deep
ANNOT_RTOL = 5e-2


def _rel(x, ref):
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


def _agree(a, b):
    return float(np.mean([x == y for x, y in zip(a, b)]))


@pytest.fixture(scope="module")
def runs():
    jm, jv, _ = jax_load(CKPT)
    tm, _ = load_model_from_checkpoint(CKPT, device="cpu")
    jv16 = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.bfloat16)
        if hasattr(x, "dtype") and x.dtype == jnp.float32 else x, jv)
    tm16 = copy.deepcopy(tm).to(torch.bfloat16)
    imgs = scenes(N, jm.cfg.input_size, seed=0)

    ja = {32: jm.encode(jv, jnp.asarray(imgs), train=False),
          16: jm.encode(jv16, jnp.asarray(imgs, jnp.bfloat16), train=False)}
    ta = {32: tm.encode(torch.from_numpy(imgs)),
          16: tm16.encode(torch.from_numpy(imgs))}
    jdec = {32: jv["params"]["decoder"], 16: jv16["params"]["decoder"]}
    tdec = {32: tm, 16: tm16}

    def jcaps(fn, kw, bits, a):
        return jax_unpack(fn(jdec[bits], jm.cfg, a, **kw), jm.grid_hw)[0]

    def tcaps(fn, kw, bits, a):
        m = tdec[bits]
        return unpack_beam_result(fn(m.decoder, m.cfg, a, **kw), m.grid_hw)[0]

    caps = {}
    for mode, jfn, tfn, kw in (("beam", jax_beam, beam_search, BEAM),
                               ("greedy", jax_greedy, greedy_decode, GREEDY)):
        for bits in (32, 16):
            caps[mode, "jax", bits] = jcaps(jfn, kw, bits, ja[bits])
            caps[mode, "port", bits] = tcaps(tfn, kw, bits, ta[bits])
        # the bf16 decoders alone: on the f32 annotations, and on JAX's bf16 ones
        caps[mode, "port", "16 on 32"] = tcaps(
            tfn, kw, 16, ta[32].to(torch.bfloat16))
        shared = torch.from_numpy(np.array(ja[16].astype(jnp.float32)))
        caps[mode, "port", "16 on jax 16"] = tcaps(
            tfn, kw, 16, shared.to(torch.bfloat16))
    annots = {k: np.asarray(v.astype(jnp.float32)) for k, v in ja.items()}
    annots.update({("port", k): v.float().numpy() for k, v in ta.items()})
    return caps, annots


@pytest.mark.parametrize("mode", ["beam", "greedy"])
def test_bf16_decoder_alone_keeps_the_bar(runs, mode):
    """Where the bar comes from: the port's bf16 decoder on the f32
    encoder's annotations against the port's f32 captions."""
    caps, _ = runs
    got = _agree(caps[mode, "port", "16 on 32"], caps[mode, "port", 32])
    assert got >= BAR, got


@pytest.mark.parametrize("mode", ["beam", "greedy"])
def test_bf16_decoder_matches_jax(runs, mode):
    """Both bf16 decoders on the same bf16 annotations (JAX's)."""
    caps, _ = runs
    got = _agree(caps[mode, "port", "16 on jax 16"], caps[mode, "jax", 16])
    assert got >= BAR, got


def test_bf16_encoders_far_apart(runs):
    """Fault pinned, in both packages (ROADMAP.md section 3): each bf16
    encoder is over ANNOT_RTOL from its own f32 encoder and from the other
    package's bf16 encoder, and end to end the best bf16 captions miss the
    bar against f32 and across the packages.  Measured on 8 images: relative
    Frobenius error 0.54 (port) and 0.77 (JAX) against f32; best-caption
    agreement with beam search port/JAX 0/8, port/f32 3/8, JAX/f32 0/8."""
    caps, annots = runs
    gaps = {"port vs jax": _rel(annots["port", 16], annots[16]),
            "port vs f32": _rel(annots["port", 16], annots[32]),
            "jax vs f32": _rel(annots[16], annots[32])}
    assert min(gaps.values()) > ANNOT_RTOL, gaps
    # the port's bf16 encoder stays the nearer to f32
    assert gaps["port vs f32"] < gaps["jax vs f32"], gaps
    agree = {"port vs jax": _agree(caps["beam", "port", 16], caps["beam", "jax", 16]),
             "port vs f32": _agree(caps["beam", "port", 16], caps["beam", "port", 32]),
             "jax vs f32": _agree(caps["beam", "jax", 16], caps["beam", "jax", 32])}
    assert max(agree.values()) < BAR, agree
    # the f32 captions themselves agree across the packages
    assert caps["beam", "port", 32] == caps["beam", "jax", 32]
    assert caps["greedy", "port", 32] == caps["greedy", "jax", 32]
