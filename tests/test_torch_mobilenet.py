"""The inverted-residual encoders of the port (mobilenet_v2,
mobilenet_v3_large, mobilenet_v3_small, mnasnet0_5/0_75/1_0/1_3 in
sat_tpu_torch.models.backbones, .encoder, .torch_import, .lightning_export,
.lightning_import) against sat_tpu's on the CPU, and one finetuning train
step of a tiny mobilenet_v3_small model against JAX's jitted step.

Weights are seeded numpy trees in flax's layout
(``test_torch_resnet.random_tree``: BatchNorm scales, biases and running
statistics drawn too, so that every leaf's mapping shows).  The
torchvision-keyed state_dicts come from JAX's exporter on those trees and
from the torchvision-layout modules of tests/test_torch_replay.py, whose
MobileNetV3 blocks carry the squeeze-excite as ``fc1`` / ``fc2``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sat_tpu.config import SATConfig as JaxConfig
from sat_tpu.models import backbones as JB
from sat_tpu.models import lightning_export as JE
from sat_tpu.models import torch_import as JT
from sat_tpu.models.encoder import SATEncoder as JaxEncoder
from sat_tpu.models.encoder import probe_encoder as jax_probe
from sat_tpu.train.loop import Trainer as JaxTrainer
from sat_tpu_torch.config import SATConfig
from sat_tpu_torch.models import backbones as TB
from sat_tpu_torch.models import lightning_export as TE
from sat_tpu_torch.models import lightning_import as TI
from sat_tpu_torch.models import torch_import as TT
from sat_tpu_torch.models.encoder import encoder_from_config, probe_encoder
from sat_tpu_torch.models.jax_import import (encoder_to_jax, load_encoder_weights,
                                             model_from_jax_tree, model_to_jax_tree)
from sat_tpu_torch.models.model import SATModel
from sat_tpu_torch.train.checkpoints import load_any_checkpoint
from sat_tpu_torch.train.loop import Trainer
from test_torch_encoder import _tol
from test_torch_replay import TV_BUILDERS, randomize
from test_torch_resnet import assert_trees_equal, lightning_tree, random_tree
from test_torch_serve import tiny_cfg
from test_torch_train_step import as_float, assert_trees, make_batch
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

S = 64
ARCHS = ("mobilenet_v2", "mobilenet_v3_large", "mobilenet_v3_small", "mnasnet0_5",
         "mnasnet0_75", "mnasnet1_0", "mnasnet1_3")
# one table each; the other MNASNet widths differ from mnasnet0_5 in width only
FAST = ARCHS[:4]
SLOW = ARCHS[4:]


def assert_f32_close(got, ref, ref64):
    """The port's float32 ``got`` within ``_tol`` of JAX's float64 output
    ``ref64``, or within twice the gap of JAX's float32 ``ref`` to it where
    that is larger."""
    np.testing.assert_allclose(got, ref64, rtol=0, atol=max(
        _tol(ref64), 2 * float(np.abs(ref - ref64).max())))


def check_encoder(arch):
    """The encoder at B = 2 and 64 px against JAX's, eval and train mode.

    Eval: in float64 in both packages within 1e-9 of the output's scale;
    at float32 the port within ``_tol`` of JAX's float64 output, or within
    twice JAX's own float32 error (its float32 output's gap to its float64
    one) where that is larger: with random BatchNorm statistics through 11
    to 17 blocks each package lies up to ~1.5e-5 of the scale from the
    float64 output (mobilenet_v2: port 8.8e-5, JAX 9.0e-5 at a scale of 6),
    above ``_tol``'s 1e-5, and the two float32 outputs up to the sum of
    their errors from each other.  Train mode (batch
    statistics, and the running statistics after the pass) in float64
    within 1e-9, as tests/test_torch_resnet.py holds the ResNets."""
    params, stats = random_tree(arch, seed=1)
    enc = load_encoder_weights(encoder_from_config(SATConfig(encoder_arch=arch,
                                                             input_size=S)),
                               params, stats)
    jmod = JaxEncoder(arch=arch, train=True)
    imgs = np.random.default_rng(2).uniform(size=(2, S, S, 3))
    variables = {"params": params, "batch_stats": stats}
    jeval = jax.jit(jmod.copy(train=False).apply)
    ref = np.asarray(jeval(variables, jnp.asarray(imgs, jnp.float32)))
    got = enc.eval()(torch.from_numpy(imgs).float()).detach().numpy()
    assert got.shape == ref.shape == (2, 4, enc.backbone.out_channels)
    with jax.enable_x64(True):
        ref64 = np.asarray(jeval(as_float(variables, np.float64),
                                 jnp.asarray(imgs, jnp.float64)))
        train_ref, new = jax.jit(lambda v, x: jmod.apply(v, x, mutable=["batch_stats"]))(
            as_float(variables, np.float64), jnp.asarray(imgs, jnp.float64))
        train_ref, new = np.asarray(train_ref), jax.tree_util.tree_map(np.asarray, new)
    assert_f32_close(got, ref, ref64)
    enc = enc.double()
    scale = float(np.abs(ref64).max())
    np.testing.assert_allclose(enc(torch.from_numpy(imgs)).detach().numpy(), ref64,
                               rtol=0, atol=1e-9 * scale)

    got = enc.train()(torch.from_numpy(imgs)).detach().numpy()
    scale = float(np.abs(train_ref).max())
    np.testing.assert_allclose(got, train_ref, rtol=0, atol=1e-9 * scale)
    assert_trees(encoder_to_jax(enc)[1], new["batch_stats"], rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("arch", FAST)
def test_encoder_matches_jax(arch):
    check_encoder(arch)


@pytest.mark.slow
def test_wider_mnasnets_match_jax():
    for arch in SLOW:
        check_encoder(arch)


def test_registry():
    """The seven archs are BACKBONES entries, with JAX's submodule names:
    the expand conv only where the width changes (block 0 of both
    MobileNetV3 tables has none), squeeze-excite only where the table
    marks it."""
    assert set(ARCHS) <= set(TB.BACKBONES) and len(TB.BACKBONES) == 26
    small = TB.BACKBONES["mobilenet_v3_small"]()
    assert not hasattr(small.block0, "expand") and hasattr(small.block0, "se_fc1")
    assert hasattr(small.block1, "expand") and not hasattr(small.block1, "se_fc1")
    assert small.block0.se_fc1.bias is not None and small.out_channels == 576
    assert not hasattr(TB.BACKBONES["mobilenet_v3_large"]().block0, "expand")
    assert not hasattr(TB.BACKBONES["mobilenet_v2"]().block0, "expand")
    assert len(TB.BACKBONES["mnasnet1_0"]().block_names) == sum(TT.MNASNET_STACKS)


@pytest.mark.parametrize("name", ["hswish", "hsigmoid"])
def test_bf16_activations_match_jax(name):
    """On a seeded bf16 tensor, bit for bit with JAX's jitted function
    (XLA rounds each bf16 operation on the CPU; computing in float32 and
    rounding once differs in ~20 % of values), and in float32."""
    x = np.random.default_rng(3).normal(0, 4, size=4096).astype(np.float32)
    fn = jax.jit(getattr(JB, name))
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)):
        ref = np.asarray(fn(jnp.asarray(x, jdt)).astype(jnp.float32))
        got = getattr(TB, name)(torch.from_numpy(x).to(tdt))
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.float().numpy(), ref)


@pytest.mark.parametrize("arch,size,esize,want", [
    ("mobilenet_v3_small", 224, None, (576, (7, 7))),   # the slice's configuration
    ("mnasnet1_0", 224, 14, (1280, (14, 14))),          # 7 x 7 upsampled
    ("mobilenet_v2", 64, 3, (1280, (3, 3))),            # 2 x 2 upsampled
    ("mobilenet_v3_large", 224, 4, (960, (4, 4))),      # 7 x 7 pooled
])
def test_probe_matches_jax(arch, size, esize, want):
    kw = dict(encoder_arch=arch, input_size=size, encoder_size=esize)
    assert probe_encoder(SATConfig(**kw)) == jax_probe(JaxConfig(**kw)) == want


@pytest.mark.parametrize("arch", ARCHS)
def test_converters_and_lightning_match_jax(arch):
    """torchvision state_dict -> flax tree (convert_backbone) and back
    (export_backbone) leaf for leaf as JAX's, the round trip exact; a
    torchvision-layout module's state_dict converts as JAX converts it; the
    port's Lightning export is JAX's key for key and value for value, and
    its import of JAX's file is the tree it came from."""
    cfg, tree = lightning_tree(arch)
    params = tree["params"]["encoder"]["backbone"]
    stats = tree["state"]["batch_stats"]["backbone"]
    sd = JE.export_backbone(arch, params, stats)
    got = TE.export_backbone(arch, params, stats)
    assert list(got) == list(sd)
    assert_trees_equal(got, sd)
    sd["classifier.0.weight"] = np.ones((10, 4), np.float32)    # dropped
    got, want = TT.convert_backbone(arch, dict(sd)), JT.convert_backbone(arch, dict(sd))
    assert_trees_equal({"params": got[0], "stats": got[1]},
                       {"params": want[0], "stats": want[1]})
    assert_trees_equal({"params": got[0], "stats": got[1]},
                       {"params": params, "stats": stats})

    tv = TV_BUILDERS[arch]()
    randomize(tv, seed=len(arch))
    tv_sd = {k: v.numpy() for k, v in tv.state_dict().items()}
    got, want = TT.convert_backbone(arch, dict(tv_sd)), JT.convert_backbone(arch, dict(tv_sd))
    assert_trees_equal({"params": got[0], "stats": got[1]},
                       {"params": want[0], "stats": want[1]})
    back = TE.export_backbone(arch, *got)
    assert {k for k in back if not k.endswith("num_batches_tracked")} == \
        {k for k in tv_sd if not k.endswith("num_batches_tracked")}

    jcfg = JaxConfig(**cfg.to_dict())
    want = JE.build_lightning_checkpoint(jcfg, tree)
    got = TE.build_lightning_checkpoint(cfg, tree)
    assert got["hyper_parameters"] == want["hyper_parameters"]
    assert list(got["state_dict"]) == list(want["state_dict"])
    assert_trees_equal(got["state_dict"], want["state_dict"])
    got_cfg, got_tree = TI.reference_tree(want)
    assert got_cfg.to_dict() == cfg.to_dict()
    assert_trees_equal(got_tree, tree)


@pytest.mark.parametrize("arch", ["mobilenet_v2", "mobilenet_v3_small"])
def test_lightning_file_reads_back(arch, tmp_path):
    """A Lightning file of JAX's exporter through load_any_checkpoint: the
    model's tree is the one written, with JAX's grid, and the file the port
    writes of that model is JAX's, key for key and value for value."""
    cfg, tree = lightning_tree(arch, seed=5)
    path = str(tmp_path / "ref.ckpt")
    ckpt = JE.build_lightning_checkpoint(JaxConfig(**cfg.to_dict()), tree)
    ckpt["state_dict"] = {k: torch.from_numpy(np.array(v))
                          for k, v in ckpt["state_dict"].items()}
    torch.save(ckpt, path)
    model = load_any_checkpoint(path, device="cpu")
    back = model_to_jax_tree(model)
    assert_trees_equal(back, tree)
    assert model.grid_hw == jax_probe(JaxConfig(**cfg.to_dict()))[1] == (2, 2)
    again = TE.build_lightning_checkpoint(model.cfg, back)
    assert list(again["state_dict"]) == list(ckpt["state_dict"])
    assert_trees_equal(again["state_dict"],
                       {k: v.numpy() for k, v in ckpt["state_dict"].items()})


@pytest.mark.parametrize("arch", ["mobilenet_v3_small", "mnasnet1_0"])
def test_import_pretrained_matches_jax(arch, tmp_path):
    """A torchvision state_dict saved as .npz through import_pretrained and
    SATModel.create(pretrained_weights=...) is JAX's import bit for bit."""
    params, stats = (t["backbone"] for t in random_tree(arch, seed=7))
    path = str(tmp_path / "w.npz")
    np.savez(path, **JE.export_backbone(arch, params, stats))
    cfg = SATConfig(**tiny_cfg(arch, encoder_dim=None).to_dict())
    model = SATModel.create(cfg, torch.Generator().manual_seed(0))
    got = TT.import_pretrained(arch, path, model_to_jax_tree(model))
    want = JT.import_pretrained(arch, path, model_to_jax_tree(model))
    assert_trees_equal(got, want)
    assert_trees_equal(got["params"]["encoder"]["backbone"], params)
    created = SATModel.create(cfg.replace(pretrained=True, pretrained_weights=path),
                              torch.Generator().manual_seed(0))
    tree = model_to_jax_tree(created)
    assert_trees_equal(tree["params"]["encoder"], {"backbone": params})
    assert_trees_equal(tree["state"]["batch_stats"], {"backbone": stats})


@pytest.fixture(scope="module")
def slice_json(tmp_path_factory):
    from sat_tpu.data.preprocess import make_synthetic_dataset
    out = tmp_path_factory.mktemp("ds_mobilenet")
    return make_synthetic_dataset(str(out), n_train=4, n_val=2, n_test=2,
                                  image_size=S, max_cap_length=6)


def test_mobilenet_v3_small_slice_finetune_matches_jax(slice_json, tmp_path, monkeypatch):
    """A tiny mobilenet_v3_small model (the native 2 x 2 map, D 576, no
    proj) with the encoder finetuned from step 1: Trainer.train_step at step
    1 on the CPU against JAX's jitted step there (its LRs, its draws, the
    encoder trained), autograd through the depthwise convolutions,
    squeeze-excite and hard-swish.  JAX's step runs in float64, as
    tests/test_torch_train_step.py holds its finetune case (JAX's own
    float32 encoder update is far from its float64 one); metrics within
    1e-5, every parameter and the BatchNorm statistics within rtol 5e-5 /
    atol 5e-6, and the encoder moved."""
    kw = dict(encoder_arch="mobilenet_v3_small", input_size=S, encoder_dim=None,
              embed_dim=16, attention_dim=16, decoder_dim=32, deep_output=True,
              json=slice_json, batch=4, epochs=1, mesh_shape=(1,),
              decoder_tf="always", dropout=0.0, embedding_dropout=0.0,
              label_smoothing=0.1, opt="sgd", momentum=0.0, decoder_lr=0.05,
              embedding_lr=0.05, encoder_lr=0.05, encoder_finetune_after=1,
              grad_clip="norm", clip_value=1.0, aug_scale=1.0, aug_hflip=0.0,
              aug_noise_std=0.0, seed=0)
    # JAX's encoder init runs op by op, compiling each of its ~370
    # operations (about 45 s); jitted, it is one program
    init = JaxEncoder.init
    monkeypatch.setattr(JaxEncoder, "init", lambda self, rng, *a, **k: jax.jit(
        lambda r, *x: init(self, r, *x, **k))(rng, *a))
    jt = JaxTrainer(JaxConfig(**kw), log_root=str(tmp_path / "logs"))
    cfg = SATConfig.from_dict(jt.cfg.to_dict()).replace(json=None)
    assert cfg.encoder_dim == 576
    tt = Trainer(cfg, device="cpu")
    tt.model.load_state_dict(model_from_jax_tree(
        cfg, as_float(jt.variables, np.float32)).state_dict())
    tt.global_step = 1
    batch = make_batch(4, cfg.vocab_size, seed=8)
    with jax.enable_x64(True):
        jvars, _, ref = jt._jit_train_step(
            as_float(jt.variables, np.float64), as_float(jt.opt_state, np.float64),
            {k: jnp.asarray(v) for k, v in batch.items()},
            {k: jnp.asarray(v, jnp.float64) for k, v in jt.scheduler.current_lrs(1).items()},
            jnp.float64(1.0), jax.random.fold_in(jt._step_rng_base, 1), train_encoder=True)
        jvars, ref = as_float(jvars, np.float64), jax.device_get(ref)
    got = tt.train_step(batch)
    for k in ("loss", "ce_loss", "att_loss", "accuracy"):
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-5, err_msg=k)
    tvars = model_to_jax_tree(tt.model)
    assert_trees(tvars["params"], jvars["params"], rtol=5e-5, atol=5e-6)
    assert_trees(tvars["state"], jvars["state"], rtol=5e-5, atol=5e-6)
    kernel = lambda t: t["params"]["encoder"]["backbone"]["block3"]["se_fc1"]["kernel"]
    assert not np.array_equal(kernel(tvars), kernel(as_float(jt.variables, np.float32)))
