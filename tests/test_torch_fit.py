"""The port's Trainer with a dataset, fit and the training CLI
(sat_tpu_torch.train.loop, .train.__main__, .config) against
sat_tpu.train.loop and sat_tpu.config on the CPU.

Two epochs of fit: 32 px, narrow decoder, B 8, SGD without momentum,
teacher forcing always, no augmentation, no dropout, the encoder frozen (its
finetuned float32 update is far from float64 in JAX itself, ROADMAP.md §3),
the bucket sampler, validation by beam search at beamk 2.  The port starts
from JAX's initial weights; JAX runs on a one-device mesh.  The train
metrics and weights are held at tests/test_torch_train_step.py's
tolerances; the validation captions are the same tokens, so BLEU and GLEU
agree within 1e-9."""

import os

import jax
import numpy as np
import pytest
import torch

from sat_tpu import config as jax_config
from sat_tpu.data.preprocess import make_synthetic_dataset
from sat_tpu.train import checkpoints as jax_ckpt
from sat_tpu.train import logging as jax_logging
from sat_tpu.train.loop import Trainer as JaxTrainer
from sat_tpu_torch import config
from sat_tpu_torch.models.jax_import import model_from_jax_tree
from sat_tpu_torch.train import checkpoints
from sat_tpu_torch.train import logging as port_logging
from sat_tpu_torch.train.__main__ import main
from sat_tpu_torch.train.loop import Trainer, val_decode
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

# metrics that the captions alone decide; cosine similarity and perplexity
# also read the trained embedding and scores, held like the train metrics
CAPTION_METRICS = ("bleu", "gleu")
CKPT = os.path.join(os.path.dirname(__file__), "data", "best_n64_r4_serving.ckpt")


@pytest.fixture(scope="module")
def synth_json(tmp_path_factory):
    return make_synthetic_dataset(str(tmp_path_factory.mktemp("fit_ds")),
                                  n_train=16, n_val=8, n_test=2, image_size=32,
                                  max_cap_length=8)


def fit_kw(synth_json, **kw):
    d = dict(json=synth_json, encoder_arch="shufflenet_v2_x0_5", input_size=32,
             encoder_dim=32, embed_dim=16, attention_dim=16, decoder_dim=32,
             deep_output=True, batch=8, epochs=2, mesh_shape=(1,), seed=0,
             decoder_tf="always", dropout=0.0, embedding_dropout=0.0,
             label_smoothing=0.1, opt="sgd", momentum=0.0, decoder_lr=0.05,
             embedding_lr=0.05, grad_clip="norm", clip_value=1.0, aug_scale=1.0,
             aug_hflip=0.0, aug_noise_std=0.0, bucket_sampler=True,
             val_interval=1, val_beamk=2, val_max_len=6, log_every=1,
             scheduler="plateau", plateau_patience=0,
             early_stop_monitor="bleu4", early_stop_patience=1)
    d.update(kw)
    return d


def test_constructor_matches_jax(synth_json, tmp_path):
    kw = fit_kw(synth_json, embed_dim=12)
    jt = JaxTrainer(jax_config.SATConfig(**kw), log_root=str(tmp_path / "jax"))
    tt = Trainer(config.SATConfig(**kw), log_root=str(tmp_path / "port"), device="cpu")
    assert tt.cfg.to_dict() == jt.cfg.to_dict()
    assert tt.cfg.vocab_size == len(tt.cfg.vocab_stoi) and tt.cfg.max_cap_length == 8
    assert len(tt.train_loader) == len(jt.train_loader) == 2
    assert len(tt.val_loader) == len(jt.val_loader) == 1
    assert os.path.basename(tt.logdir) == "version_0"
    assert tt.logdir.startswith(str(tmp_path / "port"))


def recorder(monkeypatch, cls):
    calls = []
    real = cls.scalar

    def scalar(self, tag, value, step):
        calls.append((tag, float(value), int(step)))
        real(self, tag, value, step)
    monkeypatch.setattr(cls, "scalar", scalar)
    return calls


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + k + "."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_two_epochs_of_fit_match_jax(synth_json, tmp_path, monkeypatch):
    jlog = recorder(monkeypatch, jax_logging.MetricsLogger)
    tlog = recorder(monkeypatch, port_logging.MetricsLogger)
    kw = fit_kw(synth_json)
    jt = JaxTrainer(jax_config.SATConfig(**kw), log_root=str(tmp_path / "jax"))
    tt = Trainer(config.SATConfig(**kw), log_root=str(tmp_path / "port"), device="cpu")
    tt.model.load_state_dict(model_from_jax_tree(
        tt.cfg, jax.device_get(jt.variables)).state_dict())
    jval, tval = jt.fit(), tt.fit()

    assert [(t, s) for t, _, s in tlog] == [(t, s) for t, _, s in jlog]
    for (tag, g, _), (_, r, _) in zip(tlog, jlog):
        if tag.startswith("images_per_sec"):
            continue
        if tag.startswith(CAPTION_METRICS):
            assert abs(g - r) <= 1e-9, tag
        else:
            np.testing.assert_allclose(g, r, rtol=1e-4, err_msg=tag)
    assert any(t == "images_per_sec/train" for t, _, _ in tlog)
    assert tval.keys() == jval.keys()
    assert all(abs(tval[k] - jval[k]) <= 1e-9 for k in jval if k.startswith(CAPTION_METRICS))

    # the trained models' validation captions are the same tokens
    batch = next(iter(tt.val_loader))
    res = val_decode(tt.model, tt.cfg, batch["images"])
    jres = jt._jit_val_decode(jt.variables, jax.numpy.asarray(batch["images"]))
    np.testing.assert_array_equal(res.tokens.numpy(), np.asarray(jres.tokens))
    np.testing.assert_array_equal(res.lengths.numpy(), np.asarray(jres.lengths))

    files = lambda d: sorted(f for f in os.listdir(d) if f.endswith(".ckpt"))
    assert files(tt.logdir) == files(jt.logdir)
    assert "last.ckpt" in files(tt.logdir) and len(files(tt.logdir)) == 2
    assert tt.scheduler.state_dict() == jt.scheduler.state_dict()
    assert tt.scheduler.factor != 1.0          # the plateau hook reduced the LR
    assert (tt.early_stop_best, tt.early_stop_count, tt.should_stop) == \
        (jt.early_stop_best, jt.early_stop_count, jt.should_stop)
    assert tt.global_step == jt.global_step == 4

    _, ref = jax_ckpt.load_checkpoint(os.path.join(jt.logdir, "last.ckpt"))
    _, got = checkpoints.load_checkpoint(os.path.join(tt.logdir, "last.ckpt"))
    assert "opt_state" in ref and "opt_state" in got
    ref, got = flat(ref), flat(got)
    assert got.keys() == ref.keys()
    for k in ref:
        if k.startswith(("params.", "state.")):
            np.testing.assert_allclose(got[k], ref[k], rtol=5e-5, atol=5e-6, err_msg=k)
        elif ref[k].dtype.kind in "USO":
            assert got[k] == ref[k], k
        else:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert int(got["step"]) == 4 and int(got["epoch"]) == 1
    timings = tt.epoch_timings
    assert [t["epoch"] for t in timings] == [0, 1]
    assert set(timings[0]["val"]) == {"data", "decode_fetch", "score", "ckpt"}
    assert timings[0]["train"]["images"] == 16


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

BOOL_FLAGS = ["--benchmark", "--fast_rng", "--bucket_sampler", "--cache_images",
              "--device_resident_data", "--pretrained", "--frozen_encoder_eval",
              "--nesterov", "--weight_tying", "--deep_output", "--native_decode",
              "--no_native_decode", "--folded_encoder", "--no_folded_encoder",
              "--packed_stem", "--no_packed_stem", "--no_val_early_exit"]


def _same_cli(argv):
    assert config.config_from_args(argv).to_dict() == \
        jax_config.config_from_args(argv).to_dict()


@pytest.mark.parametrize("flag", BOOL_FLAGS)
def test_cli_bool_flags_match_jax(flag):
    _same_cli([flag])


def test_cli_defaults_and_n64_header_match_jax():
    _same_cli([])
    header = checkpoints.read_checkpoint_config(CKPT)
    argv = config.args_from_config(header)
    assert "--deep_output" in argv and argv[argv.index("--batch") + 1] == "64"
    _same_cli(argv)
    got = config.config_from_args(argv).to_dict()
    for k, v in header.to_dict().items():
        if k not in ("vocab_stoi", "vocab_size", "train_loader_len", "max_cap_length"):
            assert got[k] == v, k


def test_cli_runs_one_epoch(synth_json, tmp_path):
    argv = ["--json", synth_json, "--batch", "8", "--epochs", "1",
            "--input_size", "32", "--encoder_dim", "32", "--embed_dim", "16",
            "--attention_dim", "16", "--decoder_dim", "32", "--val_interval", "1",
            "--val_beamk", "1", "--val_max_len", "4", "--deep_output",
            "--log_root", str(tmp_path)]
    metrics = main(argv, device="cpu")
    assert np.isfinite(metrics["bleu1"]) and "perplexity" in metrics
    last = os.path.join(tmp_path, "default", "version_0", "last.ckpt")
    cfg, tree = checkpoints.load_checkpoint(last)
    assert int(tree["step"]) == 2 and cfg.batch == 8
    # --resume continues the run: one more epoch, into a new version dir
    main(["--resume", last, "--epochs", "2", "--log_root", str(tmp_path)], device="cpu")
    cfg2, tree2 = checkpoints.load_checkpoint(
        os.path.join(tmp_path, "default", "version_1", "last.ckpt"))
    assert int(tree2["step"]) == 4 and int(tree2["epoch"]) == 1
    assert cfg2.resume == last and cfg2.epochs == 2


def test_no_card_raises(synth_json, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = config.SATConfig(**dict(fit_kw(synth_json), mesh_shape=(-1,)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, log_root=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--json", synth_json, "--log_root", str(tmp_path)])


def test_profile_dir_is_not_ported(synth_json, tmp_path, monkeypatch):
    """profile_dir, ported since this test was named: fit writes one
    torch.profiler trace, of the first epoch's training; the profiler is
    off in validation and in the second epoch, as JAX's maybe_profile
    window is."""
    import json

    on = []

    def spy(name):
        real = getattr(Trainer, name)

        def wrapped(self, *a, **k):
            on.append((name, torch.autograd._profiler_enabled()))
            return real(self, *a, **k)
        monkeypatch.setattr(Trainer, name, wrapped)

    spy("train_epoch")
    spy("validate")
    prof = tmp_path / "prof"
    cfg = config.SATConfig(**fit_kw(synth_json, profile_dir=str(prof),
                                    early_stop_monitor=None))
    Trainer(cfg, log_root=str(tmp_path), device="cpu").fit()
    assert on == [("train_epoch", True), ("validate", False),
                  ("train_epoch", False), ("validate", False)]
    files = list(prof.glob("*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.load(open(files[0]))["traceEvents"]}
    assert {"aten::convolution", "aten::embedding_backward"} <= names


def test_maybe_profile(tmp_path):
    """No directory, no trace and no profiler; with one, a trace file of
    the block's operations; an error in the block goes through."""
    import json

    from sat_tpu_torch.utils.timing import maybe_profile
    with maybe_profile(None):
        assert not torch.autograd._profiler_enabled()
    with maybe_profile(str(tmp_path / "p"), "cpu"):
        assert torch.autograd._profiler_enabled()
        torch.ones(4).cumsum(0)
    (trace,) = (tmp_path / "p").glob("*.pt.trace.json")
    assert "aten::cumsum" in {e.get("name") for e in json.load(open(trace))["traceEvents"]}
    with pytest.raises(ZeroDivisionError):
        with maybe_profile(str(tmp_path / "q"), "cpu"):
            1 / 0


def test_cli_takes_the_trainer_settings(synth_json, tmp_path):
    """The five settings the port once refused, together through the CLI:
    bf16, microbatch 4 of 8, accumulate 2, staged data in chunks of 2 and a
    profile of the first epoch; the checkpoint keeps them and optax's
    MultiSteps layout."""
    prof = tmp_path / "prof"
    argv = ["--json", synth_json, "--batch", "8", "--epochs", "1", "--input_size", "32",
            "--encoder_dim", "32", "--embed_dim", "16", "--attention_dim", "16",
            "--decoder_dim", "32", "--val_interval", "1", "--val_beamk", "1",
            "--val_max_len", "4", "--precision", "16", "--microbatch", "4",
            "--accumulate", "2", "--device_resident_data", "--steps_per_dispatch", "2",
            "--profile_dir", str(prof), "--log_root", str(tmp_path)]
    metrics = main(argv, device="cpu")
    assert np.isfinite(metrics["bleu1"])
    cfg, tree = checkpoints.load_checkpoint(
        os.path.join(tmp_path, "default", "version_0", "last.ckpt"))
    assert (cfg.precision, cfg.microbatch, cfg.accumulate, cfg.device_resident_data,
            cfg.steps_per_dispatch) == (16, 4, 2, True, 2)
    assert int(tree["step"]) == 2 and int(tree["opt_state"]["gradient_step"]) == 1
    assert len(list(prof.glob("*.pt.trace.json"))) == 1
