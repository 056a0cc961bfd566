"""The port's train-mode encoder and Trainer (sat_tpu_torch.models.model,
.models.backbones, .train.loop) against sat_tpu on the CPU: one train-mode
encoder pass against SATModel.encode(train=True), and three Trainer steps
against JAX's Trainer._jit_train_step (SGD without momentum, epsilon 1, no
augmentation, no dropout, shufflenet_v2_x0_5 at 64 px), with the encoder
frozen and with it finetuned from step 1.  The port runs at float32; where
JAX's float32 result is itself too far from exact for the tolerance, JAX
also runs in float64 and the port is held to that (see each test)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from sat_tpu.config import SATConfig as JaxConfig
from sat_tpu.decode.beam import greedy_decode as jax_greedy
from sat_tpu.models.model import SATModel as JaxModel
from sat_tpu.train.loop import Trainer as JaxTrainer
from sat_tpu_torch.config import SATConfig
from sat_tpu_torch.decode.beam import greedy_decode
from sat_tpu_torch.models.jax_import import model_from_jax_tree, model_to_jax_tree
from sat_tpu_torch.models.model import SATModel
from sat_tpu_torch.train.loop import Trainer
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

S, R, T = 64, 5, 8
SMALL = dict(encoder_arch="shufflenet_v2_x0_5", input_size=S, encoder_dim=32,
             embed_dim=16, attention_dim=16, decoder_dim=32, deep_output=True)


def vocab(v=24):
    stoi = {f"w{i}": i for i in range(1, v - 3)}
    stoi.update({"<UNK>": v - 3, "<START>": v - 2, "<END>": v - 1, "<PAD>": 0})
    return dict(vocab_size=v, vocab_stoi=stoi)


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + k + "."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def assert_trees(got, ref, rtol, atol):
    got, ref = flat(got), flat(ref)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=rtol, atol=atol, err_msg=k)


def make_batch(b, v, seed):
    rng = np.random.default_rng(seed)
    lens = rng.integers(3, T, (b, R)).astype(np.int32)
    caps = np.zeros((b, R, T), np.int32)
    caps[..., 0] = v - 2
    for i in range(b):
        for r in range(R):
            n = int(lens[i, r])
            caps[i, r, 1:n] = rng.integers(1, v - 3, n - 1)
            caps[i, r, n] = v - 1
    images = rng.integers(0, 256, (b, S, S, 3)).astype(np.uint8)
    return {"images": images, "captions": caps, "lengths": lens}


def as_float(tree, dtype):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, dtype) if np.asarray(a).dtype.kind == "f"
        else np.asarray(a), jax.device_get(tree))


@pytest.fixture(scope="module")
def synth_json(tmp_path_factory):
    from sat_tpu.data.preprocess import make_synthetic_dataset
    out = tmp_path_factory.mktemp("ds_train_step")
    return make_synthetic_dataset(str(out), n_train=4, n_val=2, n_test=2,
                                  image_size=S, max_cap_length=T - 2)


def trainer_kw(synth_json, finetune_after):
    return dict(SMALL, json=synth_json, batch=4, epochs=1, mesh_shape=(1,),
                decoder_tf="always", dropout=0.0, embedding_dropout=0.0,
                label_smoothing=0.1, att_gamma=1.0, opt="sgd", momentum=0.0,
                decoder_lr=0.05, embedding_lr=0.05, encoder_lr=0.05,
                grad_clip="norm", clip_value=1.0, aug_scale=1.0, aug_hflip=0.0,
                aug_noise_std=0.0, encoder_finetune_after=finetune_after, seed=0)


@pytest.fixture(scope="module")
def frozen_jax(synth_json, tmp_path_factory):
    """JAX's trainer with the encoder frozen, and its initial variables."""
    jt = JaxTrainer(JaxConfig(**trainer_kw(synth_json, 0)),
                    log_root=str(tmp_path_factory.mktemp("logs")))
    return jt, as_float(jt.variables, np.float32)


def test_train_mode_encoder_matches_jax(frozen_jax):
    """Output and new batch statistics at B = 2 and 64 px, where the last
    stage's map is 2 x 2: nn.BatchNorm2d's unbiased running variance is 8/7
    of flax's there, and the last check shows that it misses.

    Both packages run the pass in float64 too, where they agree to 1e-9: at
    float32 a BatchNorm over the 8 samples of a late stage amplifies rounding,
    and each package lies up to 2e-4 of the output's scale from the float64
    result (the port the nearer), so float32 is held to 5e-4 of it."""
    jt, tree = frozen_jax
    cfg = SATConfig.from_dict(jt.cfg.to_dict())
    encode = jax.jit(lambda v, x: jt.model.encode(v, x, train=True))
    imgs = np.random.default_rng(1).uniform(size=(2, S, S, 3))
    tm = model_from_jax_tree(cfg, tree)
    ref, _ = encode(tree, jnp.asarray(imgs, jnp.float32))
    got = tm.encode(torch.from_numpy(imgs).float(), train=True)
    assert tm.encoder.training and got.requires_grad
    scale = float(np.abs(np.asarray(ref)).max())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=0,
                               atol=5e-4 * scale)

    with jax.enable_x64(True):
        ref, new_bs = encode(as_float(tree, np.float64),
                             jnp.asarray(imgs, jnp.float64))
        ref, new_bs = np.asarray(ref), jax.tree_util.tree_map(np.asarray, new_bs)
    tm = model_from_jax_tree(cfg, tree).double()
    got = tm.encode(torch.from_numpy(imgs), train=True).detach().numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-9 * scale)
    assert_trees(model_to_jax_tree(tm)["state"]["batch_stats"], new_bs,
                 rtol=1e-9, atol=1e-12)

    torch_bn = model_from_jax_tree(cfg, tree).double()
    for m in torch_bn.encoder.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.__class__ = nn.BatchNorm2d        # torch's own train-mode update
    torch_bn.encoder.train()(torch.from_numpy(imgs))
    var = torch_bn.encoder.backbone.bn5.running_var.detach().numpy()
    assert not np.allclose(var, new_bs["backbone"]["bn5"]["var"], rtol=1e-3)


def jax_steps(jt, batch, n, finetune_after=None):
    """n steps of JAX's trainer, with its own per-step LR, encoder gate,
    epsilon and rng (Trainer.train_epoch's loop body); ``finetune_after``
    in place of the config's ``encoder_finetune_after`` for the gate."""
    cfg = jt.cfg
    fa = cfg.encoder_finetune_after if finetune_after is None else finetune_after
    enc_on = fa > 0 and cfg.encoder_lr > 0
    dbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    out = []
    for step in range(n):
        lrs = jt.scheduler.current_lrs(step)
        train_encoder = enc_on and step >= fa
        if not train_encoder:
            lrs = dict(lrs, encoder=0.0)
        jt.variables, jt.opt_state, m = jt._jit_train_step(
            jt.variables, jt.opt_state, dbatch,
            {k: jnp.asarray(v, jnp.float32) for k, v in lrs.items()},
            jnp.float32(1.0), jax.random.fold_in(jt._step_rng_base, step),
            train_encoder=train_encoder)
        jt.scheduler.on_train_batch_end(step)
        out.append(jax.device_get(m))
    return out


@pytest.mark.parametrize("finetune_after", [0, 1])
def test_train_steps_match_jax(synth_json, frozen_jax, tmp_path,
                               finetune_after):
    """Three steps: metrics, every parameter and the batch statistics within
    rtol 5e-5 and atol 5e-6; then the trained models' greedy tokens.

    With the encoder finetuned, JAX's step runs in float64: JAX's own
    (jitted) float32 step misses its float64 step in the encoder's update by
    far more than these tolerances, where the port's float32 step meets
    them."""
    if finetune_after:
        jt = JaxTrainer(JaxConfig(**trainer_kw(synth_json, finetune_after)),
                        log_root=str(tmp_path / "logs"))
    else:
        jt = frozen_jax[0]
    cfg = SATConfig.from_dict(jt.cfg.to_dict()).replace(json=None)
    tt = Trainer(cfg, device="cpu")     # on the batches given here
    tt.model.load_state_dict(model_from_jax_tree(
        cfg, jax.device_get(jt.variables)).state_dict())
    batch = make_batch(4, cfg.vocab_size, seed=2)
    init = flat(as_float(jt.variables["params"]["encoder"], np.float32))

    x64 = finetune_after > 0
    with jax.enable_x64(x64):
        if x64:
            jt.variables = as_float(jt.variables, np.float64)
            jt.opt_state = as_float(jt.opt_state, np.float64)
        ref = jax_steps(jt, batch, 3)
        jvars = as_float(jt.variables, np.float64 if x64 else np.float32)
    got = [tt.train_step(batch) for _ in range(3)]
    for r, g in zip(ref, got):
        for k in ("loss", "ce_loss", "att_loss", "accuracy"):
            np.testing.assert_allclose(float(g[k]), float(r[k]), rtol=1e-5, err_msg=k)
    tvars = model_to_jax_tree(tt.model)
    assert_trees(tvars["params"], jvars["params"], rtol=5e-5, atol=5e-6)
    assert_trees(tvars["state"], jvars["state"], rtol=5e-5, atol=5e-6)
    conv1 = "backbone.conv1.kernel"
    moved = not np.array_equal(flat(tvars["params"]["encoder"])[conv1],
                               init[conv1])
    assert moved == (finetune_after > 0)
    assert tt.global_step == 3

    imgs = batch["images"].astype(np.float32) / 255.0
    jvars = as_float(jvars, np.float32)
    jres = jax_greedy(jvars["params"]["decoder"], jt.model.cfg,
                      jt.model.encode(jvars, jnp.asarray(imgs)), max_gen_length=6)
    tres = greedy_decode(tt.model.decoder, cfg,
                         tt.model.encode(torch.from_numpy(imgs)), max_gen_length=6,
                         fused=False)
    np.testing.assert_array_equal(tres.tokens.numpy(), np.asarray(jres.tokens))


def port_trainer(**kw):
    cfg = SATConfig(**dict(SMALL, **vocab(), batch=2, train_loader_len=4,
                           decoder_tf="always", aug_noise_std=0.0, **kw))
    return Trainer(cfg, device="cpu")


def test_step_after_caption_trains():
    """model.caption leaves the encoder in eval mode and builds no autograd
    graph; the next train step runs the encoder in train mode again."""
    tt = port_trainer()
    batch = make_batch(2, tt.cfg.vocab_size, seed=4)
    imgs = torch.from_numpy(batch["images"]).float() / 255.0
    tt.train_step(batch)
    stats = tt.model.encoder.backbone.bn5.running_mean.clone()
    caps = tt.model.caption(imgs, beamk=2, max_gen_length=5, fused=False)[0]
    assert len(caps) == 2 and not tt.model.encoder.training
    assert all(p.grad is None for p in tt.model.parameters())
    assert torch.equal(stats, tt.model.encoder.backbone.bn5.running_mean)
    assert not tt.model.encode(imgs).requires_grad
    tt.train_step(batch)
    assert tt.model.encoder.training
    assert not torch.equal(stats, tt.model.encoder.backbone.bn5.running_mean)


def test_train_epoch_and_generator():
    """train_epoch averages its steps and advances the epoch; each step's
    draws depend on (seed, global_step) alone."""
    tt = port_trainer(aug_scale=0.9, dropout=0.3)
    batch = make_batch(2, tt.cfg.vocab_size, seed=5)
    a = tt.step_generator().initial_seed()
    means = tt.train_epoch(iter([batch] * 5), max_batches=3)
    assert tt.global_step == 3 and tt.current_epoch == 1
    assert set(means) == {"loss", "ce_loss", "att_loss", "accuracy", "epsilon_tf"}
    assert all(np.isfinite(v) for v in means.values())
    tt.global_step = 0
    assert tt.step_generator().initial_seed() == a
    tt.global_step = 1
    assert tt.step_generator().initial_seed() != a


def test_create_reads_the_pretrained_embedding(tmp_path):
    """cfg.pretrained_embedding (a .npy of the (V, E) matrix) replaces the
    drawn embedding in both packages' SATModel.create; the rest of the tree
    has JAX's keys and shapes, and a matrix of another shape raises."""
    kw = dict(SMALL, **vocab())
    emb = np.random.default_rng(6).standard_normal(
        (kw["vocab_size"], kw["embed_dim"])).astype(np.float32)
    path = str(tmp_path / "emb.npy")
    np.save(path, emb)
    _, jv = JaxModel.create(JaxConfig(**kw, pretrained_embedding=path),
                            jax.random.PRNGKey(0))
    tm = SATModel.create(SATConfig(**kw, pretrained_embedding=path),
                         torch.Generator().manual_seed(0))
    got = model_to_jax_tree(tm)
    ref = jax.device_get(jv)
    np.testing.assert_array_equal(got["params"]["decoder"]["embedding"], emb)
    np.testing.assert_array_equal(ref["params"]["decoder"]["embedding"], emb)
    shapes = lambda t: {k: v.shape for k, v in flat(t).items()}
    assert shapes(got["params"]) == shapes(ref["params"])
    assert shapes(got["state"]) == shapes(ref["state"])
    np.save(path, emb[:, :-1])
    with pytest.raises(ValueError, match="pretrained embedding shape"):
        SATModel.create(SATConfig(**kw, pretrained_embedding=path),
                        torch.Generator().manual_seed(0))


def test_trainer_needs_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = SATConfig(**dict(SMALL, **vocab(), train_loader_len=4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg)
