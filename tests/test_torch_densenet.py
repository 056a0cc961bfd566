"""The SqueezeNet and DenseNet encoders of the port (squeezenet1_0/1_1,
densenet121/169/201/161 in sat_tpu_torch.models.backbones, .encoder,
.torch_import, .lightning_export, .lightning_import) against sat_tpu's on
the CPU, the probe of all 26 archs, and one train step each of a tiny
squeezenet1_1 model (encoder finetuned) and a tiny densenet121 model
(frozen encoder, train-mode BatchNorm) against JAX's jitted step.

Weights are seeded numpy trees in flax's layout
(``test_torch_resnet.random_tree``).  SqueezeNet has no BatchNorm: its
``batch_stats`` tree is empty, which every consumer (the importer, the
checkpoint writer and reader, the Lightning exporter and importer, the
Trainer) takes as JAX's do."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from sat_tpu.config import SATConfig as JaxConfig
from sat_tpu.models import lightning_export as JE
from sat_tpu.models import lightning_import as JI
from sat_tpu.models import torch_import as JT
from sat_tpu.models.encoder import SATEncoder as JaxEncoder
from sat_tpu.models.encoder import probe_encoder as jax_probe
from sat_tpu.train import checkpoints as jax_ckpt
from sat_tpu.train.loop import Trainer as JaxTrainer
from sat_tpu_torch.config import ENCODER_ARCHS, SATConfig
from sat_tpu_torch.models import backbones as TB
from sat_tpu_torch.models import lightning_export as TE
from sat_tpu_torch.models import lightning_import as TI
from sat_tpu_torch.models import torch_import as TT
from sat_tpu_torch.models.encoder import encoder_from_config, probe_encoder
from sat_tpu_torch.models.jax_import import (encoder_to_jax, load_encoder_weights,
                                             model_from_jax_tree, model_to_jax_tree)
from sat_tpu_torch.models.model import SATModel
from sat_tpu_torch.train import checkpoints
from sat_tpu_torch.train.checkpoints import load_any_checkpoint
from sat_tpu_torch.train.loop import Trainer
from test_encoders import EXPECTED
from test_torch_encoder import _tol
from test_torch_mobilenet import assert_f32_close
from test_torch_replay import TV_BUILDERS, randomize
from test_torch_resnet import assert_trees_equal, lightning_tree, random_tree
from test_torch_serve import tiny_cfg
from test_torch_train_step import as_float, assert_trees, make_batch
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

S = 64
ARCHS = ("squeezenet1_0", "squeezenet1_1", "densenet121", "densenet169",
         "densenet201", "densenet161")
SLOW = ARCHS[3:]


def check_encoder(arch, size):
    """The encoder at B = 2 and ``size`` px against JAX's, eval and train
    mode, as tests/test_torch_mobilenet.py::check_encoder holds its archs:
    in float64 within 1e-9 of the output's scale; at float32 within
    ``_tol`` of JAX's float64 output, or within twice JAX's own float32
    error where that is larger; train mode (batch statistics, and the
    running statistics after the pass) in float64 within 1e-9."""
    params, stats = random_tree(arch, seed=1)
    enc = load_encoder_weights(encoder_from_config(SATConfig(encoder_arch=arch,
                                                             input_size=size)),
                               params, stats)
    jmod = JaxEncoder(arch=arch, train=True)
    imgs = np.random.default_rng(2).uniform(size=(2, size, size, 3))
    variables = {"params": params, "batch_stats": stats}
    jeval = jax.jit(jmod.copy(train=False).apply)
    ref = np.asarray(jeval(variables, jnp.asarray(imgs, jnp.float32)))
    got = enc.eval()(torch.from_numpy(imgs).float()).detach().numpy()
    dim, (h, w) = jax_probe(JaxConfig(encoder_arch=arch, input_size=size))
    assert got.shape == ref.shape == (2, h * w, dim) == (2, h * w, enc.backbone.out_channels)
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
    assert_trees(encoder_to_jax(enc)[1], new.get("batch_stats", {}), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("arch,size", [
    ("squeezenet1_0", 64),   # the second pool's 14 -> 7 keeps a partial window
    ("squeezenet1_1", 64),   # every pool's windows are whole (31 -> 15 -> 7 -> 3)
    ("squeezenet1_0", 72),   # partial windows at 16 -> 8 and 8 -> 4
    ("densenet121", 64),
    ("densenet121", 72),     # the second transition's 2 x 2 pool drops a row of 9
])
def test_encoder_matches_jax(arch, size):
    check_encoder(arch, size)


@pytest.mark.slow
def test_deep_densenets_match_jax():
    for arch in SLOW:
        check_encoder(arch, S)


def test_registry():
    """All 26 archs of ENCODER_ARCHS build; the new ones with JAX's
    submodule names, SqueezeNet without BatchNorm, DenseNet's widths."""
    assert set(TB.BACKBONES) == set(ENCODER_ARCHS) and len(TB.BACKBONES) == 26
    sq = TB.BACKBONES["squeezenet1_1"]()
    assert [n for n, _ in sq.named_children()] == ["conv1"] + [f"fire{i}" for i in range(2, 10)]
    assert not any(isinstance(m, torch.nn.BatchNorm2d) for m in sq.modules())
    assert sq.conv1.bias is not None and sq.fire2.expand3x3.padding == (1, 1)
    dn = TB.BACKBONES["densenet121"]()
    names = [n for n, _ in dn.named_children()]
    assert names[:3] == ["conv0", "norm0", "dense1_0"] and names[-1] == "norm5"
    assert "trans3_conv" in names and "trans4_conv" not in names
    assert dn.dense1_0.conv1.out_channels == 128 and dn.dense1_0.conv2.out_channels == 32
    assert TB.BACKBONES["densenet161"]().conv0.out_channels == 96


@pytest.mark.parametrize("arch", ENCODER_ARCHS)
def test_probe_matches_table(arch):
    """probe_encoder at 224 px: tests/test_encoders.py's table of the
    torchvision encoders' widths and grids."""
    dim, grid = EXPECTED[arch]
    assert probe_encoder(SATConfig(encoder_arch=arch, input_size=224)) == (dim, (grid, grid))


@pytest.mark.parametrize("arch", ARCHS)
def test_converters_and_lightning_match_jax(arch):
    """torchvision state_dict -> flax tree (convert_backbone) and back
    (export_backbone) leaf for leaf as JAX's, the round trip exact; a
    torchvision-layout module's state_dict converts as JAX converts it; the
    port's Lightning export is JAX's key for key and value for value, and
    its import of JAX's file is JAX's tree and the tree it came from."""
    cfg, tree = lightning_tree(arch)
    params = tree["params"]["encoder"]["backbone"]
    stats = tree["state"]["batch_stats"].get("backbone")
    assert (stats is None) == arch.startswith("squeezenet")
    sd = JE.export_backbone(arch, params, stats)
    got = TE.export_backbone(arch, params, stats)
    assert list(got) == list(sd)
    assert_trees_equal(got, sd)
    sd["classifier.1.weight"] = np.ones((10, 4), np.float32)    # dropped
    got, want = TT.convert_backbone(arch, dict(sd)), JT.convert_backbone(arch, dict(sd))
    assert_trees_equal({"params": got[0], "stats": got[1]},
                       {"params": want[0], "stats": want[1]})
    assert_trees_equal({"params": got[0], "stats": got[1]},
                       {"params": params, "stats": stats or {}})

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
    jsd = {k: np.asarray(v) for k, v in want["state_dict"].items()}
    enc_sd, _, dec_sd = JI.split_reference_state_dict(jsd, arch)
    jparams, jstats = JT.convert_backbone(arch, enc_sd)
    assert_trees_equal(got_tree, {
        "params": {"encoder": {"backbone": jparams},
                   "decoder": JI.convert_decoder(dec_sd, jcfg)},
        "state": {"batch_stats": {"backbone": jstats} if jstats else {}}})
    assert_trees_equal(got_tree, tree)


@pytest.mark.parametrize("arch", ["squeezenet1_1", "densenet121"])
def test_lightning_file_reads_back(arch, tmp_path):
    """A Lightning file of JAX's exporter through load_any_checkpoint: the
    model's tree is the one written, it encodes as JAX's model of the
    file, and the file the port writes of it is JAX's."""
    cfg, tree = lightning_tree(arch, seed=5)
    path = str(tmp_path / "ref.ckpt")
    ckpt = JE.build_lightning_checkpoint(JaxConfig(**cfg.to_dict()), tree)
    ckpt["state_dict"] = {k: torch.from_numpy(np.array(v))
                          for k, v in ckpt["state_dict"].items()}
    torch.save(ckpt, path)
    model = load_any_checkpoint(path, device="cpu")
    back = model_to_jax_tree(model)
    assert_trees_equal(back, tree)
    jcfg, jvars, grid = JI.load_reference_checkpoint(path)
    assert tuple(grid) == model.grid_hw == ((3, 3) if arch.startswith("squeeze") else (2, 2))
    imgs = np.random.default_rng(6).uniform(size=(2, S, S, 3)).astype(np.float32)
    from sat_tpu.models.model import SATModel as JaxModel
    ref = np.asarray(JaxModel(jcfg, grid).encode(jvars, jnp.asarray(imgs)))
    got = model.encode(torch.from_numpy(imgs)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=_tol(ref))
    again = TE.build_lightning_checkpoint(model.cfg, back)
    assert list(again["state_dict"]) == list(ckpt["state_dict"])
    assert_trees_equal(again["state_dict"],
                       {k: v.numpy() for k, v in ckpt["state_dict"].items()})


@pytest.mark.parametrize("arch", ["squeezenet1_1", "densenet121"])
def test_import_pretrained_matches_jax(arch, tmp_path):
    """A torchvision state_dict saved as .npz through import_pretrained and
    SATModel.create(pretrained_weights=...) is JAX's import bit for bit;
    for squeezenet1_1 the model's batch_stats tree stays empty."""
    params, stats = random_tree(arch, seed=7)
    params, stats = params["backbone"], stats.get("backbone")
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
    assert_trees_equal(tree["state"]["batch_stats"], {"backbone": stats} if stats else {})


def test_create_pretrained_squeezenet(tmp_path):
    """SATModel.create(pretrained=True, pretrained_weights=...) of a
    BatchNorm-free squeezenet1_1 takes the file's weights (it raised
    KeyError where the importer merged an empty statistics tree)."""
    params = random_tree("squeezenet1_1", seed=9)[0]["backbone"]
    path = str(tmp_path / "sq.pt")
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in
                JE.export_backbone("squeezenet1_1", params, None).items()}, path)
    cfg = SATConfig(**tiny_cfg("squeezenet1_1", encoder_dim=None).to_dict()).replace(
        pretrained=True, pretrained_weights=path)
    model = SATModel.create(cfg, torch.Generator().manual_seed(0))
    tree = model_to_jax_tree(model)
    assert tree["state"] == {"batch_stats": {}}
    assert_trees_equal(tree["params"]["encoder"], {"backbone": params})


@pytest.fixture(scope="module")
def slice_json(tmp_path_factory):
    from sat_tpu.data.preprocess import make_synthetic_dataset
    out = tmp_path_factory.mktemp("ds_densenet")
    return make_synthetic_dataset(str(out), n_train=4, n_val=2, n_test=2,
                                  image_size=S, max_cap_length=6)


def slice_kw(arch, slice_json, **kw):
    return dict(dict(encoder_arch=arch, input_size=S, encoder_dim=None,
                     embed_dim=16, attention_dim=16, decoder_dim=32, deep_output=True,
                     json=slice_json, batch=4, epochs=1, mesh_shape=(1,),
                     decoder_tf="always", dropout=0.0, embedding_dropout=0.0,
                     label_smoothing=0.1, opt="sgd", momentum=0.0, decoder_lr=0.05,
                     embedding_lr=0.05, grad_clip="norm", clip_value=1.0, aug_scale=1.0,
                     aug_hflip=0.0, aug_noise_std=0.0, seed=0), **kw)


def jit_jax_init(monkeypatch):
    """JAX's encoder init runs op by op, compiling each operation; jitted,
    it is one program."""
    init = JaxEncoder.init
    monkeypatch.setattr(JaxEncoder, "init", lambda self, rng, *a, **k: jax.jit(
        lambda r, *x: init(self, r, *x, **k))(rng, *a))


def test_squeezenet1_1_slice_finetune_matches_jax(slice_json, tmp_path, monkeypatch):
    """A tiny squeezenet1_1 model (the native 3 x 3 map, D 512, no proj, no
    BatchNorm) with the encoder finetuned from step 1: Trainer.train_step
    at step 1 against JAX's jitted step run in float64, as
    tests/test_torch_mobilenet.py holds its finetune case: metrics within
    1e-5, every parameter within rtol 5e-5 / atol 5e-6, the encoder moved,
    and the empty batch_stats through the checkpoint: the port's tree has
    the layout of JAX's Trainer's (opt_state included), its file is JAX's
    writer's byte for byte, reads back bit for bit, and goes through the
    Lightning file and back."""
    jit_jax_init(monkeypatch)
    kw = slice_kw("squeezenet1_1", slice_json, encoder_lr=0.05, encoder_finetune_after=1)
    jt = JaxTrainer(JaxConfig(**kw), log_root=str(tmp_path / "logs"))
    cfg = SATConfig.from_dict(jt.cfg.to_dict()).replace(json=None)
    assert cfg.encoder_dim == 512
    tt = Trainer(cfg.replace(json=slice_json), log_root=str(tmp_path / "port"), device="cpu")
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
    assert tvars["state"] == {"batch_stats": {}} and jvars["state"] == {"batch_stats": {}}
    assert_trees(tvars["params"], jvars["params"], rtol=5e-5, atol=5e-6)
    kernel = lambda t: t["params"]["encoder"]["backbone"]["fire5"]["expand3x3"]["kernel"]
    assert not np.array_equal(kernel(tvars), kernel(as_float(jt.variables, np.float32)))

    tree = tt._checkpoint_tree()
    shapes = lambda t: jax.tree_util.tree_map(lambda a: np.shape(a), jax.device_get(t))
    assert shapes(tree) == shapes(serialization.to_state_dict(jt._checkpoint_tree()))
    port, jax_file = str(tmp_path / "port.ckpt"), str(tmp_path / "jax.ckpt")
    checkpoints.save_checkpoint(port, tt.cfg, tree)
    jax_ckpt.save_checkpoint(jax_file, JaxConfig(**tt.cfg.to_dict()), tree)
    with open(port, "rb") as a, open(jax_file, "rb") as b:
        assert a.read() == b.read()
    back = load_any_checkpoint(port, device="cpu")
    sd, back_sd = tt.model.state_dict(), back.state_dict()
    assert sd.keys() == back_sd.keys() and all(torch.equal(sd[k], back_sd[k]) for k in sd)
    lt = str(tmp_path / "lightning.ckpt")
    TE.main(["--input", port, "--output", lt])
    from_lt = load_any_checkpoint(lt, device="cpu").state_dict()
    assert all(torch.equal(sd[k], from_lt[k]) for k in sd)


def test_densenet121_slice_train_step_matches_jax(slice_json, tmp_path, monkeypatch):
    """A tiny densenet121 model (the native 2 x 2 map, D 1024, no proj)
    with a frozen encoder in train mode: one Trainer.train_step against
    JAX's jitted step, metrics within 1e-5, every parameter and the
    BatchNorm statistics of the 121-layer encoder within rtol 5e-5 / atol
    5e-6, as tests/test_torch_resnet.py holds the resnet18 step."""
    jit_jax_init(monkeypatch)
    jt = JaxTrainer(JaxConfig(**slice_kw("densenet121", slice_json)),
                    log_root=str(tmp_path / "logs"))
    cfg = SATConfig.from_dict(jt.cfg.to_dict()).replace(json=None)
    assert cfg.encoder_dim == 1024 and not cfg.frozen_encoder_eval
    tt = Trainer(cfg, device="cpu")
    tt.model.load_state_dict(model_from_jax_tree(
        cfg, as_float(jt.variables, np.float32)).state_dict())
    batch = make_batch(4, cfg.vocab_size, seed=8)
    lrs = jt.scheduler.current_lrs(0)
    jt.variables, _, ref = jt._jit_train_step(
        jt.variables, jt.opt_state, {k: jnp.asarray(v) for k, v in batch.items()},
        {k: jnp.asarray(v, jnp.float32) for k, v in dict(lrs, encoder=0.0).items()},
        jnp.float32(1.0), jax.random.fold_in(jt._step_rng_base, 0), train_encoder=False)
    got = tt.train_step(batch)
    for k in ("loss", "ce_loss", "att_loss", "accuracy"):
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-5, err_msg=k)
    tvars, jvars = model_to_jax_tree(tt.model), as_float(jt.variables, np.float32)
    assert_trees(tvars["params"], jvars["params"], rtol=5e-5, atol=5e-6)
    assert_trees(tvars["state"], jvars["state"], rtol=5e-5, atol=5e-6)
