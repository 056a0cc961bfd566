"""precision 16 in the port (sat_tpu_torch.data.transforms, .models.backbones
.BatchNorm, .train.loop.Trainer) against sat_tpu on the CPU: the bf16
augment, the train-mode bf16 encoder stage by stage, and three bf16
Trainer.train_steps against JAX's bf16 Trainer._jit_train_step (SGD, epsilon
1, no augmentation, no dropout, SMALL of tests/test_torch_train_step.py),
with the encoder frozen, then finetuned from step 1.

bf16 keeps 8 bits, and at these widths (random weights, 4 images of 64 px,
late maps of 2 x 2) the train-mode encoder loses most of it in both
packages: its annotations are 0.41 (port) and 0.40 (JAX) from float32, so
neither package's bf16 step is near the other's or near float32 to
float32's tolerances.  The bar for the weights is the one stated for the
port: its bf16 update is no farther from JAX's float32 update than twice
JAX's own bf16 update is, and no nearer than half of it (a port step that
ran at float32 is 3e-5 from it), over the decoder's leaves, the encoder's
and all.  Measured (relative Frobenius gap of the three steps' updates):
frozen 0.175 (port) against 0.160 (JAX); finetuned 1.26 against 1.23, where
the bf16 encoder gradient is mostly rounding in both (decoder 0.158 against
0.140, encoder 1.33 against 1.30).  The losses are held within
0.02 of JAX's float32 losses (measured: at most 0.0007 (port) and 0.0029
(JAX) frozen; finetuned 0.0101 and 0.0029, at the step after the first
encoder update, which moves the loss by what that rounding does)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sat_tpu.config import SATConfig as JaxConfig
from sat_tpu.ops.image_ops import separable_resample_mxu
from sat_tpu.train.loop import Trainer as JaxTrainer
from sat_tpu_torch.config import SATConfig
from sat_tpu_torch.data import transforms as TT
from sat_tpu_torch.models.jax_import import model_from_jax_tree, model_to_jax_tree
from sat_tpu_torch.train.loop import Trainer, cast_weights
from test_torch_train_step import as_float, flat, jax_steps, make_batch, trainer_kw
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

S = 64
STAGES = ("stage2_3", "stage3_7", "stage4_3", "bn5")


@pytest.fixture(scope="module")
def synth_json(tmp_path_factory):
    from sat_tpu.data.preprocess import make_synthetic_dataset
    out = tmp_path_factory.mktemp("ds_precision")
    return make_synthetic_dataset(str(out), n_train=4, n_val=2, n_test=2,
                                  image_size=S, max_cap_length=6)


@pytest.fixture(scope="module")
def jax_trainers(synth_json, tmp_path_factory):
    """JAX's float32 and bf16 trainers from one draw of weights, the encoder
    trained from step 1, and those weights; each test resets them."""
    kw = trainer_kw(synth_json, 1)
    j32 = JaxTrainer(JaxConfig(**kw), log_root=str(tmp_path_factory.mktemp("jax32")))
    j16 = JaxTrainer(JaxConfig(**dict(kw, precision=16)),
                     log_root=str(tmp_path_factory.mktemp("jax16")))
    init = as_float(j32.variables, np.float32)
    for jt in (j32, j16):      # host copies: the step donates its inputs
        jt.at_start = (jax.device_get(jt.opt_state), copy.deepcopy(jt.scheduler))
    return j32, j16, init


def test_bf16_resample_matches_jax():
    """separable_resample on bf16 pixels against separable_resample_mxu with
    compute_dtype bf16 on the same coordinates: both round the weights and
    each product's float32 sum to bf16, so they differ at most where a sum
    taken in another order rounds one bf16 step apart (2^-8 of values
    below 1)."""
    rng = np.random.default_rng(3)
    x = (rng.integers(0, 256, (3, S, S, 3)) / 255.0).astype(np.float32)
    py = rng.uniform(-2, S + 1, (3, S)).astype(np.float32)
    px = rng.uniform(-2, S + 1, (3, S)).astype(np.float32)
    ref = separable_resample_mxu(jnp.asarray(x, jnp.bfloat16), jnp.asarray(py),
                                 jnp.asarray(px), compute_dtype=jnp.bfloat16)
    got = TT.separable_resample(torch.from_numpy(x).bfloat16(), torch.from_numpy(py),
                                torch.from_numpy(px))
    assert got.dtype == torch.bfloat16
    diff = np.abs(got.float().numpy() - np.asarray(ref.astype(jnp.float32)))
    assert diff.max() <= 2 ** -8, diff.max()
    assert (diff == 0).mean() > 0.95


def test_bf16_augment():
    """At precision 16 the augment returns bf16: the uint8 load is JAX's
    images.astype(bf16) / 255 bit for bit; the crop and the noise run in
    bf16 and stay in [0, 1] plus the noise's range."""
    rng = np.random.default_rng(4)
    imgs = rng.integers(0, 256, (4, S, S, 3)).astype(np.uint8)
    off = dict(input_size=S, aug_scale=1.0, aug_hflip=0.0, aug_noise_std=0.0)
    x = TT.build_train_augment(SATConfig(**off, precision=16))(
        torch.Generator().manual_seed(0), torch.from_numpy(imgs))
    ref = jnp.asarray(imgs).astype(jnp.bfloat16) / jnp.asarray(255.0, jnp.bfloat16)
    assert x.dtype == torch.bfloat16
    np.testing.assert_array_equal(x.float().numpy(), np.asarray(ref.astype(jnp.float32)))
    aug = TT.build_train_augment(SATConfig(input_size=S, aug_scale=0.5, aug_hflip=0.5,
                                           aug_noise_std=0.01, precision=16))
    y = aug(torch.Generator().manual_seed(1), torch.from_numpy(imgs))
    assert y.dtype == torch.bfloat16 and y.shape == x.shape
    assert -0.1 < float(y.min()) and float(y.max()) < 1.1


def _stage_outputs_port(model, imgs, dtype):
    """The train-mode encoder's outputs at STAGES (NHWC) and its annotations,
    with the weights cast to dtype and the BatchNorm statistics float32."""
    out = {}
    bb = model.encoder.backbone
    hooks = [getattr(bb, n).register_forward_hook(
        lambda m, a, y, n=n: out.__setitem__(n, y.permute(0, 2, 3, 1).float().detach()))
        for n in STAGES]
    try:
        with torch.no_grad(), cast_weights(model, dtype):
            out["annotations"] = model.encode(
                torch.from_numpy(imgs).to(dtype), train=True).float()
    finally:
        for h in hooks:
            h.remove()
    return {k: v.numpy() for k, v in out.items()}


def _stage_outputs_jax(jt, tree, imgs, dtype):
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), tree["params"]["encoder"])
    stats = jax.tree_util.tree_map(jnp.asarray, tree["state"]["batch_stats"])
    annots, mut = jt.model.encoder_train.apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(imgs, dtype),
        mutable=["batch_stats", "intermediates"], capture_intermediates=True)
    inter = mut["intermediates"]["backbone"]
    out = {n: inter[n]["__call__"][0] for n in STAGES}
    out["annotations"] = annots
    return {k: np.asarray(v.astype(jnp.float32)) for k, v in out.items()}


def _rel(x, ref):
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


def test_bf16_train_mode_encoder_by_stage(jax_trainers):
    """Where the train-mode bf16 encoder loses precision, in both packages
    (the BatchNorm statistics float32, as in bf16 training), on 4 images
    of 64 px with the trainer's random weights: each stage's relative gap
    to the package's own float32 pass, and port to JAX at bf16.  It grows
    stage by stage as the eval-mode gap of test_torch_bf16.py does (0.54 /
    0.77 there, at n64).  Measured, port / JAX: stage 2 0.023 / 0.025,
    stage 3 0.143 / 0.142, stage 4 0.324 / 0.336, bn5 0.415 / 0.429,
    annotations 0.412 / 0.398; port to JAX 0.029 to 0.487.  Held: at each
    stage the port no farther from its float32 than twice JAX is from
    JAX's."""
    jt, _, tree = jax_trainers
    cfg = SATConfig.from_dict(jt.cfg.to_dict())
    imgs = np.random.default_rng(5).uniform(size=(4, S, S, 3)).astype(np.float32)
    port = {dt: _stage_outputs_port(model_from_jax_tree(cfg, tree), imgs, dt)
            for dt in (torch.float32, torch.bfloat16)}
    ref = {dt: _stage_outputs_jax(jt, tree, imgs, dt) for dt in (jnp.float32, jnp.bfloat16)}
    gaps = {k: (_rel(port[torch.bfloat16][k], port[torch.float32][k]),
                _rel(ref[jnp.bfloat16][k], ref[jnp.float32][k]),
                _rel(port[torch.bfloat16][k], ref[jnp.bfloat16][k]))
            for k in STAGES + ("annotations",)}
    print("bf16 gap by stage (port vs f32, JAX vs f32, port vs JAX):", gaps)
    # at float32 the stages agree across the packages
    for k in STAGES + ("annotations",):
        assert _rel(port[torch.float32][k], ref[jnp.float32][k]) < 1e-4, k
    for k, (p, j, _) in gaps.items():
        assert p <= 2 * j, (k, gaps[k])


def _update_gap(got, ref, init, keys):
    """Relative Frobenius gap of the updates got - init to ref - init over
    the leaves ``keys``."""
    d_got = np.concatenate([(got[k] - init[k]).ravel() for k in keys]).astype(np.float64)
    d_ref = np.concatenate([(ref[k] - init[k]).ravel() for k in keys]).astype(np.float64)
    return float(np.linalg.norm(d_got - d_ref) / np.linalg.norm(d_ref))


@pytest.mark.parametrize("finetune_after", [0, 1])
def test_bf16_train_steps_against_jax(jax_trainers, finetune_after):
    """Three steps from the same weights: JAX at float32 and at bf16, the
    port at bf16.  The port's updates are between half and twice as far
    from JAX's float32 updates as JAX's bf16 ones are, its losses within
    0.02 of JAX's float32 losses (module docstring's numbers); its weights
    and BatchNorm statistics stay float32.  finetune_after 0 runs JAX's
    trainers (built to finetune from step 1) with the encoder frozen
    throughout, as a trainer with finetune_after 0 runs."""
    j32, j16, init = jax_trainers
    runs = {}
    for name, jt in (("jax32", j32), ("jax16", j16)):
        opt_state, scheduler = jt.at_start
        jt.variables, jt.opt_state = jax.tree_util.tree_map(jnp.asarray, (init, opt_state))
        jt.scheduler = copy.deepcopy(scheduler)
        batch = make_batch(4, jt.cfg.vocab_size, seed=2)
        losses = [float(m["loss"]) for m in jax_steps(jt, batch, 3, finetune_after)]
        runs[name] = (flat(as_float(jt.variables["params"], np.float32)), losses)
    cfg = SATConfig.from_dict(j16.cfg.to_dict()).replace(
        json=None, encoder_finetune_after=finetune_after)
    tt = Trainer(cfg, device="cpu")
    tt.model.load_state_dict(model_from_jax_tree(cfg, init).state_dict())
    losses = [float(tt.train_step(batch)["loss"]) for _ in range(3)]
    runs["port16"] = (flat(model_to_jax_tree(tt.model)["params"]), losses)
    assert all(p.dtype == torch.float32 for p in tt.model.parameters())
    assert all(b.dtype == torch.float32 for b in tt.model.buffers()
               if b.is_floating_point())

    p0 = flat(init["params"])
    ref, ref_loss = runs["jax32"]
    groups = {"all": sorted(ref), "decoder": [k for k in ref if k.startswith("decoder")]}
    if finetune_after:
        groups["encoder"] = [k for k in ref if k.startswith("encoder")]
    gap = {(g, k): _update_gap(runs[k][0], ref, p0, keys)
           for g, keys in groups.items() for k in ("port16", "jax16")}
    loss_gap = {k: max(abs(a - b) for a, b in zip(runs[k][1], ref_loss))
                for k in ("port16", "jax16")}
    print(f"finetune_after={finetune_after}: update gap {gap}, loss gap {loss_gap}")
    for g in groups:
        # a float32 step (no cast) has a gap of about 0: the lower bound
        assert 0.5 * gap[g, "jax16"] <= gap[g, "port16"] <= 2 * gap[g, "jax16"], (g, gap)
    assert loss_gap["port16"] <= 0.02 and loss_gap["jax16"] <= 0.02, loss_gap
    enc = "encoder.backbone.conv1.kernel"
    moved = not np.array_equal(runs["port16"][0][enc], p0[enc])
    assert moved == (finetune_after > 0)
