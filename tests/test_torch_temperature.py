"""The port's temperature scaling and embedding projector
(sat_tpu_torch.evalx.temperature, .projector) against sat_tpu.evalx's on the
CPU, with the tiny synthetic setup of tests/test_torch_evaluate.py (random
weights, 32 px, a 10-image val split): the packed teacher-forced logits of
collect_logits within 1e-5 and its targets equal, fit_temperature on the
same logits within 1e-6 of JAX's T, and the projector's files byte for byte,
through TensorBoard and through the TSV pair written where
torch.utils.tensorboard does not import."""

import os
import sys

import numpy as np
import pytest
import torch

import sat_tpu.native
from sat_tpu.data.dataset import CaptionDataset as JaxDataset
from sat_tpu.evalx import projector as JP
from sat_tpu.evalx import temperature as JT
from sat_tpu.train.checkpoints import load_any_checkpoint as jax_load_any
from sat_tpu_torch.data.dataset import CaptionDataset
from sat_tpu_torch.evalx import projector as TP
from sat_tpu_torch.evalx import temperature as TT
from sat_tpu_torch.train.checkpoints import load_any_checkpoint
from test_torch_evaluate import eval_setup
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    js, ck, _ = eval_setup(tmp_path_factory.mktemp("temp"), "synthetic")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sat_tpu.native, "shared_pool", lambda: None)
        jm, jv = jax_load_any(ck)
        logits, targets = JT.collect_logits(jm, jv, JaxDataset(js, "val"),
                                            batch_size=4, max_batches=2)
    return js, ck, (jm, jv), (logits, targets)


def test_collect_logits_matches_jax(setup):
    js, ck, _, (ref_logits, ref_targets) = setup
    model = load_any_checkpoint(ck, device="cpu")
    logits, targets = TT.collect_logits(model, CaptionDataset(js, "val"),
                                        batch_size=4, max_batches=2)
    assert logits.dtype == np.float32 and logits.shape == ref_logits.shape
    assert logits.shape[0] > 8 * 5          # packed: every valid position of 40 refs
    np.testing.assert_array_equal(targets, ref_targets)
    np.testing.assert_allclose(logits, ref_logits, rtol=0, atol=1e-5)


@pytest.mark.parametrize("steps,init", [(70, 1.5), (10, 0.7)])
def test_fit_temperature_matches_jax(setup, steps, init):
    _, _, _, (logits, targets) = setup
    want = JT.fit_temperature(logits, targets, steps=steps, init=init)
    got = TT.fit_temperature(logits, targets, steps=steps, init=init)
    assert abs(got - want) <= 1e-6, (got, want)
    assert abs(got - init) > 1e-3              # it moved
    assert TT.fit_temperature(torch.from_numpy(logits), targets, steps=steps,
                              init=init) == got


def test_temperature_main(setup, capsys):
    js, ck, _, (logits, targets) = setup
    t = TT.main(["--checkpoint", ck, "--json", js, "--batch_size", "4",
                 "--max_batches", "2", "--steps", "5"], device="cpu")
    assert abs(t - JT.fit_temperature(logits, targets, steps=5)) <= 1e-6
    assert capsys.readouterr().out.strip().endswith(f"temperature = {t:.4f}")


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            if not n.startswith("events.out.tfevents"):   # time-stamped
                with open(os.path.join(d, n), "rb") as f:
                    out[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return out


@pytest.mark.parametrize("tensorboard", [True, False])
def test_projector_matches_jax(setup, tmp_path, monkeypatch, tensorboard):
    _, ck, (jm, jv), _ = setup
    if not tensorboard:
        monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    JP.export_embeddings(jm, jv, str(tmp_path / "jax"))
    out = TP.main(["--checkpoint", ck, "--logdir", str(tmp_path / "port")],
                  device="cpu")
    assert out == str(tmp_path / "port")
    got, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert got == want
    names = {os.path.basename(k) for k in got}
    assert names >= ({"tensors.tsv", "metadata.tsv"} if tensorboard
                     else {"embeddings.tsv", "metadata.tsv"})
