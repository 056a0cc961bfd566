"""microbatch and accumulate in the port (sat_tpu_torch.train.loop.Trainer,
.train.optim.MultiSteps, .train.opt_state) against sat_tpu on the CPU.

* microbatch: the chunked step against JAX's chunked step, and with
  frozen_encoder_eval (where chunking changes nothing) against the port's
  full step, at tests/test_microbatch.py's tolerances (2e-5 on the metrics;
  rtol 5e-5 and atol 5e-6 on the weights); epsilon 1 and no dropout, since
  a chunk's draws are the port's own; a microbatch that does not divide the
  batch raises.
* accumulate 2 over four steps (Adam, the norm clip, the eval-mode frozen
  encoder) against JAX's optax.MultiSteps: the weights and opt_state
  (JAX's layout, every value)
  at the same tolerances, after the third step (mid-accumulation: a
  partial acc_grads, mini_step 1) and after the fourth.
* Resume mid-accumulation both ways: JAX's Trainer resumes the port's file
  written after step 3, the port resumes JAX's; each reads the other's
  five MultiSteps keys exactly and ends step 4 on the other's run."""

import jax
import numpy as np
import pytest
from flax import serialization

from sat_tpu import config as jax_config
from sat_tpu.data.preprocess import make_synthetic_dataset
from sat_tpu.train import checkpoints as jax_ckpt
from sat_tpu.train.loop import Trainer as JaxTrainer
from sat_tpu_torch import config
from sat_tpu_torch.models.jax_import import model_from_jax_tree, model_to_jax_tree
from sat_tpu_torch.train import checkpoints
from sat_tpu_torch.train.loop import Trainer
from sat_tpu_torch.train.opt_state import flatten, layout, optax_state_dict
from test_torch_train_step import make_batch
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

MULTI_KEYS = {"mini_step", "gradient_step", "inner_opt_state", "acc_grads", "skip_state"}
RTOL, ATOL = 5e-5, 5e-6


@pytest.fixture(scope="module")
def synth_json(tmp_path_factory):
    return make_synthetic_dataset(str(tmp_path_factory.mktemp("acc_ds")), n_train=16,
                                  n_val=4, image_size=32, max_cap_length=6)


def kw(js, **extra):
    """32 px, narrow widths, B 4 (4 steps per epoch); deterministic steps."""
    d = dict(json=js, batch=4, epochs=1, input_size=32, encoder_arch="shufflenet_v2_x0_5",
             encoder_dim=16, embed_dim=8, attention_dim=8, decoder_dim=16,
             deep_output=True, mesh_shape=(1,), seed=0, decoder_tf="always",
             dropout=0.0, embedding_dropout=0.0, label_smoothing=0.1, aug_scale=1.0,
             aug_hflip=0.0, aug_noise_std=0.0, val_interval=100, log_every=1)
    d.update(extra)
    return d


def close(got, want, what):
    g, w = flatten(got), flatten(want)
    assert g.keys() == w.keys(), what
    for k in w:
        if isinstance(w[k], dict):          # optax's empty nodes
            assert g[k] == w[k] == {}, f"{what} {k}"
            continue
        np.testing.assert_allclose(np.asarray(g[k]), np.asarray(w[k]), rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what} {k}")


def pair(js, tmp, **extra):
    """A JAX Trainer and a port Trainer from JAX's initial weights."""
    jt = JaxTrainer(jax_config.SATConfig(**kw(js, **extra)), log_root=str(tmp / "jax"))
    tt = Trainer(config.SATConfig(**kw(js, **extra)), log_root=str(tmp / "port"), device="cpu")
    tt.model.load_state_dict(model_from_jax_tree(
        tt.cfg, jax.device_get(jt.variables)).state_dict())
    return jt, tt


# ---------------------------------------------------------------------------
# microbatch
# ---------------------------------------------------------------------------

def test_microbatch_matches_jax(tmp_path):
    """Two steps of microbatch 4 at B 8 (SGD, train-mode BatchNorm per
    chunk, the encoder frozen) in both packages, at 64 px: a chunk's late
    BatchNorms then see 16 values per channel, as the full step of
    tests/test_torch_train_step.py does (at 32 px they would see 4, and
    amplify float32 rounding past the tolerance in both packages)."""
    js = make_synthetic_dataset(str(tmp_path / "ds"), n_train=16, n_val=4, image_size=64,
                                max_cap_length=6)
    jt, tt = pair(js, tmp_path, opt="sgd", momentum=0.0, decoder_lr=0.05,
                  embedding_lr=0.05, microbatch=4, batch=8, input_size=64)
    for t in (jt, tt):
        t.current_epoch = 0
    m_jax, m_port = jt.train_epoch(max_batches=2), tt.train_epoch(max_batches=2)
    for k in ("loss", "ce_loss", "att_loss", "accuracy"):
        np.testing.assert_allclose(m_port[k], m_jax[k], rtol=2e-5, err_msg=k)
    tree = model_to_jax_tree(tt.model)
    close(tree["params"], jax.device_get(jt.variables["params"]), "params")
    close(tree["state"], jax.device_get(jt.variables["state"]), "batch stats")


@pytest.mark.parametrize("finetune_after", [0, 1])
def test_microbatch_matches_the_full_step(finetune_after):
    """With frozen_encoder_eval and the encoder frozen, chunking changes
    nothing: microbatch 2 at B 8 against the port's full step, three SGD
    steps (Adam's first update, g / sqrt(g^2), would turn summation-order
    noise on near-zero gradients into whole-LR differences, as
    tests/test_microbatch.py notes); with the encoder finetuned from step 1
    (train-mode BatchNorm per chunk) the chunked steps train and keep
    finite metrics."""
    from test_torch_train_step import SMALL, vocab
    cfg = config.SATConfig(**dict(SMALL, **vocab(), input_size=32, train_loader_len=4,
                                  batch=8, decoder_tf="always", dropout=0.0,
                                  embedding_dropout=0.0, aug_scale=1.0, aug_hflip=0.0,
                                  aug_noise_std=0.0, opt="sgd", momentum=0.0,
                                  decoder_lr=0.05, embedding_lr=0.05, frozen_encoder_eval=True,
                                  encoder_finetune_after=finetune_after))
    batch = make_batch(8, cfg.vocab_size, seed=6)
    batch["images"] = batch["images"][:, :32, :32]
    full, chunked = (Trainer(cfg.replace(microbatch=mb), device="cpu") for mb in (0, 2))
    chunked.model.load_state_dict(full.model.state_dict())
    for _ in range(3):
        a, b = full.train_step(batch), chunked.train_step(batch)
        assert all(np.isfinite(float(v)) for v in b.values())
        if not finetune_after:
            for k in a:
                np.testing.assert_allclose(float(b[k]), float(a[k]), rtol=2e-5, err_msg=k)
    if not finetune_after:
        close(model_to_jax_tree(chunked.model), model_to_jax_tree(full.model), "weights")


@pytest.mark.parametrize("bad", [3, 8, 16])
def test_invalid_microbatch_raises(bad):
    from test_torch_train_step import SMALL, vocab
    cfg = config.SATConfig(**dict(SMALL, **vocab(), train_loader_len=4, batch=8,
                                  microbatch=bad))
    with pytest.raises(ValueError, match="microbatch"):
        Trainer(cfg, device="cpu")


# ---------------------------------------------------------------------------
# accumulate
# ---------------------------------------------------------------------------

# frozen_encoder_eval: the train-mode BatchNorms of a 32 px batch of 4 see 4
# values per channel late in the encoder and amplify float32 rounding in
# both packages, which Adam's first update then turns into whole-LR steps
ACC = dict(opt="adam", decoder_lr=3e-3, embedding_lr=1e-2, clip_value=0.5,
           grad_clip="norm", accumulate=2, frozen_encoder_eval=True)


@pytest.fixture(scope="module")
def three_steps(synth_json, tmp_path_factory):
    """JAX and the port after 3 steps of accumulate 2 from the same weights,
    and the checkpoint each wrote there."""
    tmp = tmp_path_factory.mktemp("acc")
    jt, tt = pair(synth_json, tmp, **ACC)
    files = {}
    for name, t, save in (("jax", jt, jax_ckpt.save_checkpoint),
                          ("port", tt, checkpoints.save_checkpoint)):
        t.current_epoch = 0
        t.train_epoch(max_batches=3)
        files[name] = str(tmp / f"{name}.ckpt")
        save(files[name], t.cfg, t._checkpoint_tree())
    return jt, tt, files, tmp


def port_opt_state(tt):
    return optax_state_dict(tt.cfg, tt.model, tt.optimizer, tt._n_updates(), tt.multisteps)


def fourth_step(t):
    """Step 4, the last batch of epoch 0."""
    t._resume_skip_batches = 3
    t.current_epoch = 0
    t.train_epoch()
    assert t.global_step == 4


def test_accumulate_matches_multisteps(three_steps):
    """After step 3: the weights moved once (at step 2), acc_grads holds
    step 3's gradient, Adam's count is 1; after step 4 the second update
    used the mean of steps 3 and 4, count 2.  Both times the port's
    opt_state has JAX's layout and values."""
    jt, tt, _, _ = three_steps
    for after in (3, 4):
        if after == 4:
            for t in (jt, tt):
                fourth_step(t)
        want = serialization.to_state_dict(jax.device_get(jt.opt_state))
        got = port_opt_state(tt)
        assert set(got) == set(want) == MULTI_KEYS
        assert layout(got) == layout(want)
        assert (int(got["mini_step"]), int(got["gradient_step"])) == (after % 2, after // 2)
        counts = {int(v) for k, v in flatten(got).items() if k.endswith("count")}
        assert counts == {after // 2}
        close(got, want, f"opt_state after step {after}")
        close(model_to_jax_tree(tt.model)["params"],
              jax.device_get(jt.variables["params"]), f"params after step {after}")
    assert tt.optimizer.state[next(tt.model.decoder.parameters())]["step"] == 2


def test_weights_hold_between_updates(synth_json, tmp_path):
    """accumulate 2: the weights move at steps 2 and 4 only; the BatchNorm
    statistics at every step."""
    tt = Trainer(config.SATConfig(**kw(synth_json, **dict(ACC, frozen_encoder_eval=False))),
                 log_root=str(tmp_path), device="cpu")
    batch = make_batch(4, tt.cfg.vocab_size, seed=8)
    batch["images"] = batch["images"][:, :32, :32]
    snap = lambda: [p.detach().clone() for p in tt.model.parameters()]
    stats = lambda: tt.model.encoder.backbone.bn5.running_mean.clone()
    w, s = snap(), stats()
    moved = []
    for _ in range(4):
        tt.train_step(batch)
        w2, s2 = snap(), stats()
        moved.append(any(not (a == b).all() for a, b in zip(w, w2)))
        assert not (s == s2).all()
        w, s = w2, s2
    assert moved == [False, True, False, True]
    assert tt.multisteps.gradient_step == 2 and tt.global_step == 4


def test_jax_resumes_a_port_file_mid_accumulation(three_steps):
    jt, tt, files, tmp = three_steps
    _, raw = checkpoints.load_checkpoint(files["port"])
    assert set(raw["opt_state"]) == MULTI_KEYS and int(raw["opt_state"]["mini_step"]) == 1
    jr = JaxTrainer(jax_config.SATConfig(**kw(tt.cfg.json, **dict(ACC, resume=files["port"]))),
                    log_root=str(tmp / "jax_r"))
    assert (jr.global_step, jr.current_epoch, jr._resume_skip_batches) == (3, 0, 3)
    got = flatten(serialization.to_state_dict(jax.device_get(jr.opt_state)))
    want = flatten(raw["opt_state"])
    assert got.keys() == want.keys()
    assert all(np.array_equal(np.asarray(v), np.asarray(want[k])) for k, v in got.items())
    jr.train_epoch()
    if tt.global_step == 3:
        fourth_step(tt)
    close(jax.device_get(jr.variables["params"]), model_to_jax_tree(tt.model)["params"],
          "params")
    close(serialization.to_state_dict(jax.device_get(jr.opt_state)), port_opt_state(tt),
          "opt_state")


def test_port_resumes_a_jax_file_mid_accumulation(three_steps):
    jt, tt, files, tmp = three_steps
    _, raw = jax_ckpt.load_checkpoint(files["jax"])
    tr = Trainer(config.SATConfig(**kw(tt.cfg.json, **dict(ACC, resume=files["jax"]))),
                 log_root=str(tmp / "port_r"), device="cpu")
    assert (tr.global_step, tr.current_epoch, tr._resume_skip_batches) == (3, 0, 3)
    assert (tr.multisteps.mini_step, tr.multisteps.gradient_step) == (1, 1)
    got, want = flatten(port_opt_state(tr)), flatten(jax.device_get(raw["opt_state"]))
    assert got.keys() == want.keys()
    assert all(np.array_equal(v, np.asarray(want[k])) for k, v in got.items())
    tr.train_epoch()
    if jt.global_step == 3:
        fourth_step(jt)
    close(model_to_jax_tree(tr.model)["params"], jax.device_get(jt.variables["params"]),
          "params")
    close(port_opt_state(tr), serialization.to_state_dict(jax.device_get(jt.opt_state)),
          "opt_state")
