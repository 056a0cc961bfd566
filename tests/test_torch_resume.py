"""Resume in the port (sat_tpu_torch.train.opt_state, Trainer(cfg.resume),
the --resume CLI) against sat_tpu.train on the CPU.

* opt_state layout: for each optimizer setting, the tree the port writes
  has the keys, shapes and dtypes of flax's to_state_dict(tx.init(params))
  of JAX's transformation, on a tiny SATModel and on the n64 serving
  checkpoint's model; after the same float64 gradient steps its values
  equal JAX's state within 1e-10 (the tolerance of test_torch_optim.py),
  and JAX's state loaded into the port continues as JAX does.
* Files: the port's checkpoint reads back bit for bit; a JAX checkpoint
  resumed by the port and a port checkpoint resumed by JAX's Trainer read
  the other's state exactly and continue as the uninterrupted run does,
  within tests/test_torch_fit.py's tolerances.
* Self-resume bit for bit, as tests/test_resume.py holds JAX's (bucket
  sampler, prefetch workers, a mid-epoch file); the LR schedule, the top-k
  registry, the CLI, and the ValueError for a file without opt_state or
  with an optax.MultiSteps state."""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from sat_tpu import config as jax_config
from sat_tpu.data.preprocess import make_synthetic_dataset
from sat_tpu.train import checkpoints as jax_ckpt
from sat_tpu.train import optim as JO
from sat_tpu.train.loop import Trainer as JaxTrainer
from sat_tpu_torch import config
from sat_tpu_torch.models.decoder import ParamTree
from sat_tpu_torch.models.jax_import import (jax_leaf_map, model_from_jax_tree,
                                             model_to_jax_tree, nest_leaves, to_jax_layout)
from sat_tpu_torch.models.model import SATModel
from sat_tpu_torch.train import checkpoints
from sat_tpu_torch.train import optim as TO
from sat_tpu_torch.train.__main__ import main
from sat_tpu_torch.train.loop import Trainer
from sat_tpu_torch.train.opt_state import layout, load_optax_state, optax_state_dict
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

N64 = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                   "best_n64_r4_serving.ckpt")
ADAM = dict(opt="adam", decoder_lr=1e-2, embedding_lr=3e-2, encoder_lr=5e-3)
CASES = {
    "adam": dict(ADAM),
    "adam_wd_clip_norm": dict(ADAM, weight_decay=0.05, clip_value=3.0, grad_clip="norm"),
    "adamw_wd": dict(ADAM, opt="adamw", weight_decay=0.05),
    "sgd_momentum_wd_clip_value": dict(opt="sgd", momentum=0.9, weight_decay=0.05,
                                       clip_value=0.5, grad_clip="value"),
    "sgd_nesterov": dict(opt="sgd", momentum=0.8, nesterov=True),
    "sgd_plain": dict(opt="sgd", momentum=0.0),
    "adam_encoder_finetune": dict(ADAM, encoder_finetune_after=2, weight_decay=0.05),
    "adamw_encoder_finetune": dict(ADAM, opt="adamw", encoder_finetune_after=2),
    "adam_embedding_frozen": dict(ADAM, embedding_lr=0.0),
    "adam_tied_embedding": dict(ADAM, weight_tying=True, deep_output=True),
}
LRS = {"decoder": 1e-2, "embedding": 3e-2, "encoder": 5e-3}


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def dtypes(tree):
    return {k: v.dtype for k, v in flat(tree).items()}


# ---------------------------------------------------------------------------
# The opt_state tree
# ---------------------------------------------------------------------------

def tiny_model(**kw):
    stoi = {f"w{i}": i for i in range(1, 9)}
    stoi.update({"<PAD>": 0, "<UNK>": 9, "<START>": 10, "<END>": 11})
    kw = dict(dict(deep_output=True), **kw)
    cfg = config.SATConfig(encoder_arch="shufflenet_v2_x0_5", input_size=32,
                           encoder_dim=16, embed_dim=8, attention_dim=8,
                           decoder_dim=16, vocab_size=12, vocab_stoi=stoi, **kw)
    return SATModel.create(cfg, torch.Generator().manual_seed(0))


@pytest.mark.parametrize("case", list(CASES))
def test_layout_matches_optax_init(case):
    model = tiny_model(**CASES[case])
    cfg = model.cfg
    opt, _ = TO.build_optimizer(cfg, model.named_parameters())
    got = optax_state_dict(cfg, model, opt, 0)
    params = model_to_jax_tree(model)["params"]
    tx, _ = JO.build_optimizer(jax_config.SATConfig(**cfg.to_dict()), params)
    want = serialization.to_state_dict(tx.init(params))
    assert layout(got) == layout(want)
    assert dtypes(got) == dtypes(want)
    assert all(not v.any() for v in flat(got).values())


def test_n64_layout():
    """The n64 header's optimizer (Adam, norm clip 5, encoder frozen): 1,872
    leaves in all, 41 of them arrays, every label counting."""
    cfg, tree = checkpoints.load_checkpoint(N64)
    cfg = cfg.replace(precision=32, device_resident_data=False)
    model = model_from_jax_tree(cfg, tree)
    opt, _ = TO.build_optimizer(cfg, model.named_parameters())
    got = optax_state_dict(cfg, model, opt, 7)
    params = jax.tree_util.tree_map(np.asarray, tree["params"])
    tx, _ = JO.build_optimizer(jax_config.SATConfig(**cfg.to_dict()), params)
    want = serialization.to_state_dict(tx.init(params))
    lay = layout(got)
    assert lay == layout(want) and dtypes(got) == dtypes(want)
    assert len(lay) == 1872 and sum(v != {} for v in lay.values()) == 41
    counts = {k: int(v) for k, v in flat(got).items() if k.endswith("/count")}
    assert len(counts) == 5 and set(counts.values()) == {7}
    assert got["1"]["inner_states"]["frozen"] == {"inner_state": {}}


class Tiny(torch.nn.Module):
    """A conv and a BatchNorm as the encoder (the conv takes the HWIO
    transpose), three decoder leaves; float64."""

    def __init__(self, rng):
        super().__init__()
        self.encoder = torch.nn.Module()
        self.encoder.conv = torch.nn.Conv2d(3, 4, 3, bias=True)
        self.encoder.bn = torch.nn.BatchNorm2d(4)
        self.decoder = ParamTree({"embedding": rng.normal(size=(7, 5)),
                                  "att": {"w": rng.normal(size=(5, 3)),
                                          "b": rng.normal(size=3)}})
        self.double()
        with torch.no_grad():
            for p in self.encoder.parameters():
                p.copy_(torch.from_numpy(rng.normal(size=tuple(p.shape))))
        self.requires_grad_(True)


def _jax_step(tx, labels, state, params, grads, lrs):
    upd, state = tx.update(grads, state, params)
    upd = JO.apply_group_lrs(upd, labels, {k: jnp.asarray(v, jnp.float64)
                                           for k, v in lrs.items()})
    return optax.apply_updates(params, upd), state


def _port_step(cfg, model, opt, grads, lrs, frozen):
    for n, p in model.named_parameters():
        p.grad = None if frozen and n.startswith("encoder") else grads[n].clone()
    TO.clip_gradients(cfg, model.parameters())
    TO.apply_group_lrs(opt, lrs)
    TO.step(opt)


@pytest.mark.parametrize("case", [c for c in CASES if c != "adam_tied_embedding"])
def test_values_match_jax_in_float64(case):
    """Four steps in both (the encoder frozen for the first two where it
    finetunes); the port's tree equals JAX's state; then JAX's state is
    loaded into a fresh port optimizer and both take two more steps."""
    cfg = config.SATConfig(**CASES[case])
    jcfg = jax_config.SATConfig(**CASES[case])
    rng = np.random.default_rng(4)
    model = Tiny(rng)
    leaf_map = jax_leaf_map(model)
    opt, _ = TO.build_optimizer(cfg, model.named_parameters())
    enc_on = cfg.encoder_finetune_after > 0 and cfg.encoder_lr > 0
    seq = [{n: torch.from_numpy(rng.normal(size=tuple(p.shape)) * 3)
            for n, p in model.named_parameters()} for _ in range(6)]

    def to_jax(named):
        return jax.tree_util.tree_map(jnp.asarray, nest_leaves(
            {leaf_map[n][0]: to_jax_layout(t, leaf_map[n][1]) for n, t in named.items()}))

    with jax.enable_x64(True):
        params = to_jax(dict(model.named_parameters()))
        tx, labels = JO.build_optimizer(jcfg, params)
        state = tx.init(params)
        for i, g in enumerate(seq):
            frozen = not (enc_on and i >= cfg.encoder_finetune_after)
            lrs = dict(LRS, encoder=0.0) if frozen else LRS
            jg = {n: (0 * t if frozen and n.startswith("encoder") else t) for n, t in g.items()}
            params, state = _jax_step(tx, labels, state, params, to_jax(jg), lrs)
            if i < 4:
                _port_step(cfg, model, opt, g, lrs, frozen)
            if i == 3:
                want = serialization.to_state_dict(state)
                got = optax_state_dict(cfg, model, opt, 4)
                assert layout(got) == layout(want) and dtypes(got) == dtypes(want)
                w = flat(want)
                for k, v in flat(got).items():
                    np.testing.assert_allclose(v, w[k], rtol=1e-10, atol=1e-12, err_msg=k)
                # JAX's state into a fresh optimizer over the same weights
                opt, _ = TO.build_optimizer(cfg, model.named_parameters())
                load_optax_state(cfg, model, opt, jax.device_get(want))
            if i >= 4:
                _port_step(cfg, model, opt, g, lrs, frozen)
        ref = flat(jax.device_get(params))
    for n, p in model.named_parameters():
        path, perm = leaf_map[n]
        np.testing.assert_allclose(to_jax_layout(p, perm), ref["/".join(path)],
                                   rtol=1e-10, atol=1e-12, err_msg=n)


def test_multisteps_and_foreign_trees_raise():
    model = tiny_model(**ADAM)
    cfg = model.cfg
    opt, _ = TO.build_optimizer(cfg, model.named_parameters())
    params = model_to_jax_tree(model)["params"]
    tx, _ = JO.build_optimizer(jax_config.SATConfig(**cfg.to_dict()), params)
    multi = serialization.to_state_dict(
        optax.MultiSteps(tx, every_k_schedule=2).init(params))
    with pytest.raises(ValueError, match="MultiSteps"):
        load_optax_state(cfg, model, opt, multi)
    sgd = serialization.to_state_dict(JO.build_optimizer(
        jax_config.SATConfig(**dict(cfg.to_dict(), opt="sgd")), params)[0].init(params))
    with pytest.raises(ValueError, match="not the layout"):
        load_optax_state(cfg, model, opt, sgd)


# ---------------------------------------------------------------------------
# Trainer(cfg.resume)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def synth_json(tmp_path_factory):
    return make_synthetic_dataset(str(tmp_path_factory.mktemp("resume_ds")),
                                  n_train=16, n_val=8, image_size=32, max_cap_length=6)


def base_kw(js, **kw):
    """tests/test_resume.py's settings: every source of randomness on."""
    d = dict(json=js, batch=8, epochs=3, input_size=32,
             encoder_arch="shufflenet_v2_x0_5", encoder_dim=16, embed_dim=8,
             attention_dim=8, decoder_dim=16, decoder_tf="linear",
             decoder_tf_min=0.3, val_interval=100, seed=3, aug_scale=0.8,
             aug_hflip=0.5, aug_noise_std=0.01, scheduler="cosine",
             cosine_iterations=2, lr_warmup_steps=2, mesh_shape=(1,))
    d.update(kw)
    return d


def port_trainer(tmp_path, name, **kw):
    return Trainer(config.SATConfig(**kw), log_root=str(tmp_path / name), device="cpu")


def optimizer_tensors(trainer):
    return [(k, v) for p in trainer.model.parameters()
            for k, v in sorted(trainer.optimizer.state.get(p, {}).items())]


def assert_same_training_state(a, b):
    assert a.global_step == b.global_step
    sa, sb = a.model.state_dict(), b.model.state_dict()
    for k in sa:
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(sa[k], sb[k]), k
    ta, tb = optimizer_tensors(a), optimizer_tensors(b)
    assert [k for k, _ in ta] == [k for k, _ in tb] and ta
    for (k, x), (_, y) in zip(ta, tb):
        assert torch.equal(x, y), k


@pytest.mark.parametrize("bucket,workers,mid_epoch", [
    (False, 0, False), (True, 2, False), (False, 0, True)])
def test_self_resume_is_bit_exact(synth_json, tmp_path, bucket, workers, mid_epoch):
    kw = base_kw(synth_json, bucket_sampler=bucket, workers=workers)
    straight = port_trainer(tmp_path, "straight", **kw)
    straight.fit()
    half = port_trainer(tmp_path, "half", **kw)
    half.current_epoch = 0
    half.train_epoch()
    half.current_epoch = 1
    half.train_epoch(max_batches=1 if mid_epoch else None)
    ckpt = str(tmp_path / "interrupt.ckpt")
    checkpoints.save_checkpoint(ckpt, half.cfg, half._checkpoint_tree())
    resumed = port_trainer(tmp_path, "resumed", **dict(kw, resume=ckpt))
    assert resumed.current_epoch == (1 if mid_epoch else 2)
    assert resumed._resume_skip_batches == (1 if mid_epoch else 0)
    assert_same_training_state(resumed, half)
    resumed.fit()
    assert_same_training_state(resumed, straight)


def test_restart_file_round_trip_and_schedule(synth_json, tmp_path):
    """A restart-{step}.ckpt of a cosine warm restart: its tree reads back
    bit for bit (weights, optimizer state, counters, the schedule's state),
    and the resumed run ends on the straight run, schedule included."""
    kw = base_kw(synth_json, epochs=4, seed=5, lr_warmup_steps=0)
    straight = port_trainer(tmp_path, "straight", **kw)
    straight.fit()
    restarts = sorted(glob.glob(os.path.join(straight.logdir, "restart-*.ckpt")))
    assert restarts
    ckpt = restarts[0]
    _, raw = checkpoints.load_checkpoint(ckpt)
    step = int(raw["step"])
    assert ckpt.endswith(f"restart-{step}.ckpt") and 0 < step < straight.global_step
    resumed = port_trainer(tmp_path, "resumed", **dict(kw, resume=ckpt))
    again = resumed._checkpoint_tree()
    a, b = flat(again), flat(jax.tree_util.tree_map(np.asarray, raw))
    assert a.keys() == b.keys()
    # a file written at an epoch's last batch resumes at the next epoch
    assert int(a.pop("epoch")) == int(b.pop("epoch")) + (step % 2 == 0)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    resumed.fit()
    assert_same_training_state(resumed, straight)
    assert resumed.scheduler.state_dict() == straight.scheduler.state_dict()


def test_top_k_registry_and_early_stop_survive(synth_json, tmp_path):
    kw = base_kw(synth_json, epochs=1, val_interval=1, val_beamk=1, val_max_len=3,
                 early_stop_monitor="bleu4", early_stop_patience=3)
    first = port_trainer(tmp_path, "first", **kw)
    first.fit()
    last = os.path.join(first.logdir, "last.ckpt")
    resumed = port_trainer(tmp_path, "second", **dict(kw, epochs=2, resume=last))
    assert resumed.ckpt.best == first.ckpt.best and resumed.ckpt.best
    assert os.path.dirname(resumed.ckpt.best[0][1]) == first.logdir
    assert (resumed.early_stop_best, resumed.early_stop_count) == \
        (first.early_stop_best, first.early_stop_count)
    assert resumed.current_epoch == 1 and resumed._resume_skip_batches == 0


def test_files_without_opt_state_raise(synth_json, tmp_path):
    kw = base_kw(synth_json)
    with pytest.raises(ValueError, match="opt_state"):
        port_trainer(tmp_path, "a", **dict(kw, resume=N64))
    t = port_trainer(tmp_path, "b", **kw)
    tree = t._checkpoint_tree()
    tree.pop("opt_state")
    old = str(tmp_path / "old.ckpt")
    checkpoints.save_checkpoint(old, t.cfg, tree)
    with pytest.raises(ValueError, match="opt_state"):
        port_trainer(tmp_path, "c", **dict(kw, resume=old))


def test_cli_resume_takes_the_header(synth_json, tmp_path):
    """--resume: the model and optimizer settings from the header, the
    listed run settings from the command line."""
    kw = base_kw(synth_json, epochs=1)
    first = port_trainer(tmp_path, "first", **kw)
    first.fit()
    last = os.path.join(first.logdir, "last.ckpt")
    main(["--resume", last, "--epochs", "2", "--name", "more", "--decoder_dim", "64",
          "--val_interval", "100", "--log_root", str(tmp_path / "cli")], device="cpu")
    cfg, tree = checkpoints.load_checkpoint(
        str(tmp_path / "cli" / "more" / "version_0" / "last.ckpt"))
    assert cfg.decoder_dim == 16 and cfg.epochs == 2 and cfg.name == "more"
    assert int(tree["step"]) == 4 and int(tree["epoch"]) == 1


# ---------------------------------------------------------------------------
# Across the packages
# ---------------------------------------------------------------------------

CROSS = dict(opt="adam", decoder_lr=3e-3, embedding_lr=1e-2, decoder_tf="always",
             dropout=0.0, embedding_dropout=0.0, aug_scale=1.0, aug_hflip=0.0,
             aug_noise_std=0.0, scheduler="cosine", lr_warmup_steps=0,
             clip_value=1.0, grad_clip="norm", epochs=2)


@pytest.fixture(scope="module")
def one_epoch_each(synth_json, tmp_path_factory):
    """A JAX and a port Trainer from JAX's initial weights after one epoch,
    and the checkpoint each wrote."""
    tmp = tmp_path_factory.mktemp("cross")
    kw = base_kw(synth_json, **CROSS)
    jt = JaxTrainer(jax_config.SATConfig(**kw), log_root=str(tmp / "jax"))
    tt = Trainer(config.SATConfig(**kw), log_root=str(tmp / "port"), device="cpu")
    tt.model.load_state_dict(model_from_jax_tree(
        tt.cfg, jax.device_get(jt.variables)).state_dict())
    files = {}
    for name, t, save in (("jax", jt, jax_ckpt.save_checkpoint),
                          ("port", tt, checkpoints.save_checkpoint)):
        t.current_epoch = 0
        t.train_epoch()
        files[name] = str(tmp / f"{name}.ckpt")
        save(files[name], t.cfg, t._checkpoint_tree())
    return kw, jt, tt, files, tmp


def close(got, want, what, rtol=5e-5, atol=5e-6):
    """tests/test_torch_fit.py's tolerance for trained weights."""
    g, w = flat(got), flat(want)
    assert g.keys() == w.keys(), what
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=atol, err_msg=f"{what} {k}")


def test_port_resumes_a_jax_checkpoint(one_epoch_each):
    kw, jt, _, files, tmp = one_epoch_each
    _, raw = jax_ckpt.load_checkpoint(files["jax"])
    tr = Trainer(config.SATConfig(**dict(kw, resume=files["jax"])),
                 log_root=str(tmp / "port_r"), device="cpu")
    assert (tr.global_step, tr.current_epoch) == (2, 1)
    got = optax_state_dict(tr.cfg, tr.model, tr.optimizer, tr.global_step)
    want = jax.device_get(raw["opt_state"])
    assert layout(got) == layout(want)
    w = flat(want)
    assert all(np.array_equal(v, w[k]) for k, v in flat(got).items())
    tr.fit()
    jt.current_epoch = 1
    jt.train_epoch()
    assert tr.global_step == jt.global_step == 4
    close(model_to_jax_tree(tr.model)["params"], jax.device_get(jt.variables["params"]),
          "params")
    close(optax_state_dict(tr.cfg, tr.model, tr.optimizer, 4),
          serialization.to_state_dict(jax.device_get(jt.opt_state)), "opt_state")


def test_jax_resumes_a_port_checkpoint(one_epoch_each):
    kw, _, tt, files, tmp = one_epoch_each
    jr = JaxTrainer(jax_config.SATConfig(**dict(kw, resume=files["port"])),
                    log_root=str(tmp / "jax_r"))
    assert (jr.global_step, jr.current_epoch) == (2, 1)
    got = flat(serialization.to_state_dict(jax.device_get(jr.opt_state)))
    want = flat(optax_state_dict(tt.cfg, tt.model, tt.optimizer, tt.global_step))
    assert got.keys() == want.keys()
    assert all(np.array_equal(v, want[k]) for k, v in got.items())
    jr.fit()
    tt.current_epoch = 1
    tt.train_epoch()
    assert jr.global_step == tt.global_step == 4
    close(jax.device_get(jr.variables["params"]), model_to_jax_tree(tt.model)["params"],
          "params")
    close(serialization.to_state_dict(jax.device_get(jr.opt_state)),
          optax_state_dict(tt.cfg, tt.model, tt.optimizer, 4), "opt_state")
