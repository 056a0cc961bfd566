"""The port's evaluation CLI (sat_tpu_torch.evalx.evaluate) against
sat_tpu.evalx.evaluate on the CPU, decoding a 10-image val split at batch 4
(two full batches and a padded tail) in two settings: a tiny SATTPU1
checkpoint (shufflenet_v2_x0_5, 32 px, narrow decoder, random weights) on
a make_synthetic_dataset split, beamk 2 (it gives every image the same
caption), and the n64 serving checkpoint on its own 64-noun compositional
grammar at 224 px, beamk 3 and 20 words (ten different captions).  The
captions must be the same tokens, so BLEU-1..4 and GLEU agree within 1e-9; cosine similarity and
perplexity also read the embedding and the scores, and are held at the
train tolerance of tests/test_torch_fit.py (rtol 1e-4).  Also limit_batches
and the Lightning autodetect of main().  JAX's native decode pool is off,
so both packages read the same pixels."""

import json
import os

import numpy as np
import pytest
import torch

import sat_tpu.native
from sat_tpu.evalx import evaluate as JE
from sat_tpu.models import lightning_export as JX
from sat_tpu.data.dataset import CaptionDataset as JaxDataset
from sat_tpu.data.compositional import make_compositional_dataset
from sat_tpu.data.preprocess import make_synthetic_dataset
from sat_tpu.train.checkpoints import load_any_checkpoint as jax_load_any
from sat_tpu_torch.data.dataset import CaptionDataset
from sat_tpu_torch.evalx import evaluate as TE
from sat_tpu_torch.train.checkpoints import load_any_checkpoint
from test_torch_serve import write_tiny_checkpoint
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

CAPTION_METRICS = ("bleu", "gleu")
N64 = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                   "best_n64_r4_serving.ckpt")
SETTINGS = {"synthetic": dict(beamk=2, max_gen_length=6),
            "n64": dict(beamk=3, max_gen_length=20)}


def eval_setup(out, which):
    """(dataset json, SATTPU1 path, Lightning path) in ``out``."""
    if which == "n64":
        js = make_compositional_dataset(str(out / "ds"), n_train=4, n_val=10,
                                        n_test=2, image_size=224, n_nouns=64, seed=0)
        ck = N64
    else:
        js = make_synthetic_dataset(str(out / "ds"), n_train=4, n_val=10,
                                    n_test=2, image_size=32, max_cap_length=8)
        with open(js) as f:
            stoi = json.load(f)["vocab_stoi"]
        ck = str(out / "m.ckpt")
        write_tiny_checkpoint(ck, input_size=32, vocab_size=len(stoi),
                              vocab_stoi=stoi, json=js)
    ref = str(out / "ref.ckpt")
    JX.main(["--input", ck, "--output", ref])
    return js, ck, ref


def cli_args(js, which):
    kw = SETTINGS[which]
    return ["--json", js, "--split", "val", "--batch", "4", "--beamk",
            str(kw["beamk"]), "--max_gen_length", str(kw["max_gen_length"])]


@pytest.fixture(scope="module", params=sorted(SETTINGS))
def setup(request, tmp_path_factory):
    which = request.param
    js, ck, ref = eval_setup(tmp_path_factory.mktemp(which), which)
    kw = dict(SETTINGS[which], batch_size=4, rescore_method="LN", verbose=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sat_tpu.native, "shared_pool", lambda: None)
        jm, jv = jax_load_any(ck)
        ds = JaxDataset(js, "val")
        full = JE.evaluate(jm, jv, ds, return_captions=True, **kw)
        limited = JE.evaluate(jm, jv, ds, limit_batches=2, return_captions=True, **kw)
        lightning = JE.main(["--checkpoint", ref] + cli_args(js, which))
    return which, js, ck, ref, kw, {"full": full, "limited": limited, "main": lightning}


def assert_same_metrics(got, ref):
    assert got.keys() == ref.keys()
    for k in ref:
        if k.startswith(CAPTION_METRICS):
            assert abs(got[k] - ref[k]) <= 1e-9, k
        else:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("which", ["full", "limited"])
def test_evaluate_matches_jax(setup, which):
    _, js, ck, _, kw, jax_out = setup
    model = load_any_checkpoint(ck, device="cpu")
    limit = 2 if which == "limited" else None
    timings = {}
    metrics, caps = TE.evaluate(model, CaptionDataset(js, "val"), limit_batches=limit,
                                return_captions=True, timings=timings, **kw)
    ref_metrics, ref_caps = jax_out[which]
    assert len(caps) == (8 if limit else 10)
    assert [list(map(int, c)) for c in caps] == [list(map(int, c)) for c in ref_caps]
    assert_same_metrics(metrics, ref_metrics)
    assert set(timings) == {"data", "decode", "score"}
    assert all(v >= 0 for v in timings.values())


def test_main_reads_lightning_and_sattpu1(setup, capsys):
    which, js, ck, ref, kw, jax_out = setup
    argv = cli_args(js, which)
    from_lightning = TE.main(["--checkpoint", ref] + argv, device="cpu")
    from_sat = TE.main(["--checkpoint", ck] + argv, device="cpu")
    assert from_lightning == from_sat
    assert_same_metrics(from_lightning, jax_out["main"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f'{{"split": "val", "beamk": {kw["beamk"]}, "bleu1": ')


def test_empty_and_no_card(setup):
    _, js, ck, _, kw, _ = setup
    model = load_any_checkpoint(ck, device="cpu")
    assert TE.evaluate(model, CaptionDataset(js, "val"), limit_batches=0, **kw) == {}
    assert TE.evaluate(model, CaptionDataset(js, "val"), limit_batches=0,
                       return_captions=True, **kw) == ({}, [])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TE.main(["--checkpoint", ck, "--json", js, "--split", "val"])
