"""The port's optimizer groups, clip, group LRs and schedules
(sat_tpu_torch.train.optim, .schedules, .tf_schedule) against sat_tpu's
build_optimizer + apply_group_lrs + LRScheduler, driven with the same
synthetic float64 gradient sequences; parameters agree within 1e-10."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sat_tpu.config import SATConfig as JaxConfig
from sat_tpu.train import optim as JO
from sat_tpu.train import schedules as JSch
from sat_tpu.train import tf_schedule as JTF
from sat_tpu_torch.config import SATConfig
from sat_tpu_torch.train import optim as TO
from sat_tpu_torch.train import schedules as TSch
from sat_tpu_torch.train import tf_schedule as TTF
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

SPE, EPOCHS = 3, 3            # steps per epoch, epochs: 9 updates
SHAPES = {
    "encoder.backbone.conv1.kernel": (3, 3, 3, 4),
    "encoder.backbone.bn1.scale": (4,),
    "encoder.backbone.bn1.bias": (4,),
    "decoder.embedding": (7, 5),
    "decoder.att_dec.w": (5, 3),
    "decoder.beta.w": (5, 4),
    "decoder.beta.b": (4,),
    "decoder.lstm.layer_0.b_ih": (8,),
}


def nest(flat):
    tree = {}
    for name, v in flat.items():
        node = tree
        *path, leaf = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, prefix + k + "."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def grad_sequence(seed=0):
    """Per step, a gradient per leaf; the embedding's is large, so it weighs
    in the clip norm."""
    rng = np.random.default_rng(seed)
    return [{n: rng.normal(size=s) * (20.0 if n.endswith("embedding") else 1.0)
             for n, s in SHAPES.items()} for _ in range(SPE * EPOCHS)]


PLATEAU = [0.30, 0.20, 0.25]   # validation values at the ends of the epochs


def run_jax(kw, grads, init):
    cfg = JaxConfig(epochs=EPOCHS, **kw)
    enc_on = cfg.encoder_finetune_after > 0 and cfg.encoder_lr > 0
    with jax.enable_x64(True):
        params = jax.tree_util.tree_map(jnp.asarray, nest(init))
        tx, labels = JO.build_optimizer(cfg, params)
        state = tx.init(params)
        sched = JSch.LRScheduler(cfg, steps_per_epoch=SPE)
        trail = []
        for step, g in enumerate(grads):
            lrs = sched.current_lrs(step)
            if not (enc_on and step >= cfg.encoder_finetune_after):
                lrs = dict(lrs, encoder=0.0)
                g = {n: (0 * v if n.startswith("encoder") else v)
                     for n, v in g.items()}
            upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, nest(g)),
                                   state, params)
            upd = JO.apply_group_lrs(upd, labels, {k: jnp.asarray(v, jnp.float64)
                                                   for k, v in lrs.items()})
            params = optax.apply_updates(params, upd)
            sched.on_train_batch_end(step)
            if (step + 1) % SPE == 0:
                epoch = step // SPE
                sched.on_train_epoch_end(epoch)
                sched.on_validation_end(PLATEAU[epoch], step)
            trail.append((lrs, flatten(params)))
        return trail, flatten(labels)


def run_port(kw, grads, init):
    cfg = SATConfig(epochs=EPOCHS, **kw)
    enc_on = cfg.encoder_finetune_after > 0 and cfg.encoder_lr > 0
    params = {n: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for n, v in init.items()}
    opt, labels = TO.build_optimizer(cfg, params.items())
    sched = TSch.LRScheduler(cfg, steps_per_epoch=SPE)
    trail = []
    for step, g in enumerate(grads):
        lrs = sched.current_lrs(step)
        frozen = not (enc_on and step >= cfg.encoder_finetune_after)
        if frozen:
            lrs = dict(lrs, encoder=0.0)
        for n, p in params.items():
            # a frozen encoder has no gradient at all, as after a no_grad pass
            p.grad = None if frozen and n.startswith("encoder") \
                else torch.from_numpy(g[n].copy())
        TO.clip_gradients(cfg, params.values())
        TO.apply_group_lrs(opt, lrs)
        TO.step(opt)
        sched.on_train_batch_end(step)
        if (step + 1) % SPE == 0:
            epoch = step // SPE
            sched.on_train_epoch_end(epoch)
            sched.on_validation_end(PLATEAU[epoch], step)
        trail.append((lrs, {n: p.detach().numpy().copy()
                            for n, p in params.items()}))
    return trail, labels


ADAM = dict(opt="adam", decoder_lr=1e-2, embedding_lr=3e-2, encoder_lr=5e-3)
CASES = {
    "sgd_momentum_wd_clip_value": dict(opt="sgd", momentum=0.9,
                                       weight_decay=0.05, clip_value=0.5,
                                       grad_clip="value"),
    "sgd_nesterov_wd_clip_norm": dict(opt="sgd", momentum=0.8, nesterov=True,
                                      weight_decay=0.05, clip_value=3.0,
                                      grad_clip="norm"),
    "sgd_plain": dict(opt="sgd", momentum=0.0, nesterov=True),
    "adam_wd_clip_norm": dict(ADAM, weight_decay=0.05, clip_value=3.0,
                              grad_clip="norm"),
    "adamw_wd_warmup": dict(ADAM, opt="adamw", weight_decay=0.05,
                            lr_warmup_steps=4),
    # the encoder joins its group's updates at step 3; Adam's step count and
    # moments must have run over the frozen steps, as optax's do
    "adam_encoder_unfreezes_at_3": dict(ADAM, encoder_finetune_after=3,
                                        weight_decay=0.05),
    "adamw_encoder_unfreezes_at_3": dict(ADAM, opt="adamw",
                                         encoder_finetune_after=3),
    # a frozen embedding (embedding_lr 0) still counts in the clip norm
    "frozen_embedding_in_clip_norm": dict(ADAM, embedding_lr=0.0,
                                          clip_value=2.0, grad_clip="norm"),
    "tied_embedding": dict(ADAM, weight_tying=True, deep_output=True,
                           weight_decay=0.05),
    "step": dict(ADAM, scheduler="step", milestones=(1, 2), lr_gamma=0.5),
    "exp": dict(ADAM, scheduler="exp", lr_gamma=0.7),
    "plateau": dict(ADAM, scheduler="plateau", plateau_patience=0,
                    lr_gamma=0.5, min_lr=1e-3),
    "cosine": dict(ADAM, scheduler="cosine", cosine_iterations=4,
                   cosine_multi=2, min_lr=1e-4, lr_warmup_steps=1),
    "one_cycle": dict(ADAM, scheduler="one_cycle", one_cycle_pct=0.3),
}


@pytest.mark.parametrize("case", list(CASES))
def test_optimizer_matches_jax(case):
    kw = CASES[case]
    grads = grad_sequence()
    init = {n: np.random.default_rng(9).normal(size=s) for n, s in SHAPES.items()}
    jtrail, jlabels = run_jax(kw, grads, init)
    ttrail, tlabels = run_port(kw, grads, init)
    assert tlabels == jlabels
    for step, ((jl, jp), (tl, tp)) in enumerate(zip(jtrail, ttrail)):
        assert tl == pytest.approx(jl, rel=1e-12, abs=1e-15), step
        for n in SHAPES:
            np.testing.assert_allclose(tp[n], jp[n], rtol=1e-10, atol=1e-10,
                                       err_msg=f"{n} after step {step}")
    moved = {n for n in SHAPES if not np.array_equal(ttrail[-1][1][n], init[n])}
    trained = {n for n, lab in tlabels.items() if lab != TO.FROZEN}
    assert moved == trained


def test_encoder_unfreeze_changes_adam():
    """The check above has teeth: Adam that skipped the frozen steps (a
    step count of 1 at the first encoder update) lands elsewhere."""
    kw = CASES["adam_encoder_unfreezes_at_3"]
    grads = grad_sequence()
    init = {n: np.random.default_rng(9).normal(size=s) for n, s in SHAPES.items()}
    jtrail, _ = run_jax(kw, grads, init)
    cfg = SATConfig(epochs=EPOCHS, **kw)
    params = {n: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for n, v in init.items()}
    opt, _ = TO.build_optimizer(cfg, params.items())
    for step, g in enumerate(grads[:4]):
        for n, p in params.items():
            p.grad = None if step < 3 and n.startswith("encoder") \
                else torch.from_numpy(g[n].copy())
        TO.apply_group_lrs(opt, {"decoder": 1e-2, "embedding": 3e-2,
                                 "encoder": 0.0 if step < 3 else 5e-3})
        opt.step()                       # torch.optim alone skips None grads
    name = "encoder.backbone.conv1.kernel"
    assert np.abs(params[name].detach().numpy() - jtrail[3][1][name]).max() > 1e-4


def test_frozen_embedding_counts_in_clip():
    """Leaving the frozen embedding out of the norm changes the clip."""
    kw = CASES["frozen_embedding_in_clip_norm"]
    cfg = SATConfig(**kw)
    g = grad_sequence()[0]
    grads = {n: torch.from_numpy(v.copy()) for n, v in g.items()}
    everything = [torch.nn.Parameter(torch.zeros_like(v)) for v in grads.values()]
    for p, v in zip(everything, grads.values()):
        p.grad = v.clone()
    TO.clip_gradients(cfg, everything)
    total = np.sqrt(sum((v ** 2).sum() for v in g.values()))
    scale = cfg.clip_value / (total + 1e-6)
    for p, v in zip(everything, g.values()):
        np.testing.assert_allclose(p.grad.numpy(), v * scale, rtol=1e-12)


@pytest.mark.parametrize("mode", [None, "always", "linear", "inv_sigmoid", "exp"])
def test_teacher_forcing_epsilon(mode):
    kw = dict(decoder_tf=mode, decoder_tf_min=0.75, epochs=80)
    for epoch in (0, 1, 7, 40, 79, 80):
        assert TTF.teacher_forcing_epsilon(SATConfig(**kw), epoch) == \
            JTF.teacher_forcing_epsilon(JaxConfig(**kw), epoch)


def test_cosine_t0_adjust_and_groups():
    assert TSch.GROUPS == JSch.GROUPS
    for it, multi in ((10, 1), (7, 2), (1000, 1), (3, 3)):
        kw = dict(cosine_iterations=it, cosine_multi=multi, epochs=5,
                  lr_warmup_steps=2)
        assert TSch.cosine_t0_adjust(SATConfig(**kw), 11) == \
            JSch.cosine_t0_adjust(JaxConfig(**kw), 11)
