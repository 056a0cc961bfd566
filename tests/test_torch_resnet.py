"""The ResNet-family encoders of the port (sat_tpu_torch.models.backbones,
.encoder, .torch_import, .lightning_export, .lightning_import) against
sat_tpu's on the CPU, and one train step of a tiny resnet18 model with the
colour jitter and the optical warps against JAX's jitted step.

Weights are seeded numpy trees in flax's layout (``random_tree``), with
BatchNorm scales, biases and running statistics drawn too, so that every
leaf's mapping shows.  The torchvision-keyed state_dicts come from JAX's
exporter on those trees (and, for resnet18, agree with the keys written
out by hand in tests/test_torch_import.py::torchvision_keys)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sat_tpu.config import SATConfig as JaxConfig
from sat_tpu.models import lightning_export as JE
from sat_tpu.models import lightning_import as JI
from sat_tpu.models import torch_import as JT
from sat_tpu.models.encoder import SATEncoder as JaxEncoder
from sat_tpu.models.encoder import probe_encoder as jax_probe
from sat_tpu.train.loop import Trainer as JaxTrainer
from sat_tpu_torch.config import ENCODER_ARCHS, SATConfig
from sat_tpu_torch.data import transforms as TA
from sat_tpu_torch.models import lightning_export as TE
from sat_tpu_torch.models import lightning_import as TI
from sat_tpu_torch.models import torch_import as TT
from sat_tpu_torch.models.backbones import BACKBONES, RESNET_ARCHS
from sat_tpu_torch.models.decoder import init_decoder_params
from sat_tpu_torch.models.encoder import SATEncoder, encoder_from_config, probe_encoder
from sat_tpu_torch.models.jax_import import (_encoder_leaf_map, decoder_to_jax,
                                             encoder_to_jax, load_encoder_weights,
                                             model_from_jax_tree, model_to_jax_tree,
                                             nest_leaves)
from sat_tpu_torch.models.model import SATModel
from sat_tpu_torch.train.checkpoints import load_any_checkpoint
from sat_tpu_torch.train.loop import Trainer
from test_torch_augment import jax_draws
from test_torch_encoder import _tol
from test_torch_import import torchvision_keys
from test_torch_lightning import leaves
from test_torch_serve import tiny_cfg
from test_torch_train_step import as_float, assert_trees, make_batch
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

S = 64
# one each for the basic block, the bottleneck, groups and the base width
FAST = ("resnet18", "resnet50", "resnext50_32x4d", "wide_resnet50_2")
SLOW = tuple(a for a in RESNET_ARCHS if a not in FAST)
# names outside the zoo, torchvision's and near misses of the zoo's
UNPORTED = ("vgg16", "efficientnet_b0", "mobilenet_v1", "densenet", "alexnet",
            "resnet200")


def assert_trees_equal(got, ref):
    """Bit for bit, leaf for leaf, with the same types and shapes (the
    trees of the deepest tables hold 10^8 values)."""
    got, ref = dict(leaves(got)), dict(leaves(ref))
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        assert np.array_equal(got[k], ref[k]), k


def random_tree(arch, seed=0):
    """(params, batch_stats) of the ``arch`` encoder (no proj) in flax's
    layout, ``{"backbone": ...}`` each, seeded: conv kernels uniform of
    variance 2 / fan_in, BatchNorm scale U(0.5, 1.5), bias and running mean
    U(-0.2, 0.2), running variance U(0.5, 2)."""
    with torch.device("meta"):
        enc = encoder_from_config(SATConfig(encoder_arch=arch, input_size=S))
    rng = np.random.default_rng(seed)
    named = dict(enc.named_parameters())
    params = {}
    for name, (path, perm) in sorted(_encoder_leaf_map(enc).items()):
        t = named[name]
        shape = tuple(t.permute(*perm).shape) if perm else tuple(t.shape)
        v = rng.random(shape, np.float32)
        if path[-1] == "kernel":
            v = (v - 0.5) * np.float32(2 * np.sqrt(6 / np.prod(shape[:3])))
        elif path[-1] == "scale":
            v += 0.5
        else:
            v = (v - 0.5) * 0.4
        params[path] = v
    stats = {}
    for path, mod in sorted(enc.named_modules()):
        if isinstance(mod, torch.nn.BatchNorm2d):
            pre, n = tuple(path.split(".")), mod.num_features
            stats[pre + ("mean",)] = (rng.random(n, np.float32) - 0.5) * 0.4
            stats[pre + ("var",)] = rng.uniform(0.5, 2.0, n).astype(np.float32)
    return nest_leaves(params), nest_leaves(stats)


def check_encoder(arch):
    """Eval mode at float32 within ``_tol``; train mode (batch statistics,
    and the running statistics after the pass) in float64 in both packages
    within 1e-9 of the output's scale: at float32 a BatchNorm over the 8
    samples of the last stage's 2 x 2 map at B = 2 amplifies rounding, and
    JAX's own float32 pass lies ~7e-4 of the scale from its float64 one."""
    params, stats = random_tree(arch, seed=1)
    enc = load_encoder_weights(encoder_from_config(SATConfig(encoder_arch=arch,
                                                             input_size=S)),
                               params, stats)
    jmod = JaxEncoder(arch=arch, train=True)
    imgs = np.random.default_rng(2).uniform(size=(2, S, S, 3))
    variables = {"params": params, "batch_stats": stats}
    ref = np.asarray(jax.jit(jmod.copy(train=False).apply)(
        variables, jnp.asarray(imgs, jnp.float32)))
    got = enc.eval()(torch.from_numpy(imgs).float()).detach().numpy()
    assert got.shape == ref.shape == (2, 4, enc.backbone.out_channels)
    np.testing.assert_allclose(got, ref, rtol=0, atol=_tol(ref))

    with jax.enable_x64(True):
        ref, new = jax.jit(lambda v, x: jmod.apply(v, x, mutable=["batch_stats"]))(
            as_float(variables, np.float64), jnp.asarray(imgs, jnp.float64))
        ref, new = np.asarray(ref), jax.tree_util.tree_map(np.asarray, new)
    enc = enc.double().train()
    got = enc(torch.from_numpy(imgs)).detach().numpy()
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-9 * scale)
    assert_trees(encoder_to_jax(enc)[1], new["batch_stats"], rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("arch", FAST)
def test_encoder_matches_jax(arch):
    check_encoder(arch)


@pytest.mark.slow
def test_deep_encoders_match_jax():
    for arch in SLOW:
        check_encoder(arch)


@pytest.mark.parametrize("arch,size,esize,want", [
    ("resnet50", 224, 14, (2048, (14, 14))),     # the 7 x 7 map upsampled
    ("resnet18", 64, 3, (512, (3, 3))),          # 2 x 2 upsampled
    ("wide_resnet50_2", 224, 4, (2048, (4, 4))),  # 7 x 7 pooled
])
def test_probe_matches_jax(arch, size, esize, want):
    kw = dict(encoder_arch=arch, input_size=size, encoder_size=esize)
    assert probe_encoder(SATConfig(**kw)) == jax_probe(JaxConfig(**kw)) == want


def lightning_tree(arch, seed=4):
    """A whole model's tree: a random ``arch`` backbone and a narrow
    decoder at its width."""
    params, stats = random_tree(arch, seed)
    cfg = SATConfig(**tiny_cfg(arch, encoder_dim=None).to_dict())
    cfg = cfg.replace(encoder_dim=probe_encoder(cfg)[0])
    dec = decoder_to_jax(init_decoder_params(torch.Generator().manual_seed(seed), cfg))
    return cfg, {"params": {"encoder": params, "decoder": dec},
                 "state": {"batch_stats": stats}}


@pytest.mark.parametrize("arch", RESNET_ARCHS)
def test_converters_and_lightning_match_jax(arch):
    """torchvision state_dict -> flax tree (convert_backbone) and back
    (export_backbone) leaf for leaf as JAX's, the round trip exact; the
    port's Lightning export is JAX's key for key and value for value, and
    its import of JAX's file is JAX's tree and the tree it came from."""
    cfg, tree = lightning_tree(arch)
    params = tree["params"]["encoder"]["backbone"]
    stats = tree["state"]["batch_stats"]["backbone"]
    sd = JE.export_backbone(arch, params, stats)
    if arch == "resnet18":
        hand = {k for k, _ in torchvision_keys(arch)}
        assert {k for k in sd if not k.endswith("num_batches_tracked")} == hand
    got = TE.export_backbone(arch, params, stats)
    assert list(got) == list(sd)
    assert_trees_equal(got, sd)
    sd["fc.weight"] = np.ones((10, 4), np.float32)     # the head the converters drop
    sd["fc.bias"] = np.zeros(10, np.float32)
    got, want = TT.convert_backbone(arch, dict(sd)), JT.convert_backbone(arch, dict(sd))
    assert_trees_equal({"params": got[0], "stats": got[1]},
                       {"params": want[0], "stats": want[1]})
    assert_trees_equal({"params": got[0], "stats": got[1]},
                       {"params": params, "stats": stats})

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
        "state": {"batch_stats": {"backbone": jstats}}})
    assert_trees_equal(got_tree, tree)


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_lightning_file_reads_back(arch, tmp_path):
    """A Lightning file of JAX's exporter through load_any_checkpoint:
    the model's tree is the one written, and it encodes as JAX's model."""
    cfg, tree = lightning_tree(arch, seed=5)
    path = str(tmp_path / "ref.ckpt")
    ckpt = JE.build_lightning_checkpoint(JaxConfig(**cfg.to_dict()), tree)
    ckpt["state_dict"] = {k: torch.from_numpy(np.array(v))
                          for k, v in ckpt["state_dict"].items()}
    torch.save(ckpt, path)
    model = load_any_checkpoint(path, device="cpu")
    assert_trees_equal(model_to_jax_tree(model), tree)
    jcfg, jvars, grid = JI.load_reference_checkpoint(path)
    assert tuple(grid) == model.grid_hw == (2, 2)
    imgs = np.random.default_rng(6).uniform(size=(2, S, S, 3)).astype(np.float32)
    from sat_tpu.models.model import SATModel as JaxModel
    ref = np.asarray(JaxModel(jcfg, grid).encode(jvars, jnp.asarray(imgs)))
    got = model.encode(torch.from_numpy(imgs)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=_tol(ref))


@pytest.mark.parametrize("arch", ["resnet18", "resnext50_32x4d"])
def test_import_pretrained_matches_jax(arch, tmp_path):
    """A saved torchvision state_dict through import_pretrained and
    SATModel.create(pretrained_weights=...) is JAX's import bit for bit."""
    params, stats = (t["backbone"] for t in random_tree(arch, seed=7))
    path = str(tmp_path / "w.pt")
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in
                JE.export_backbone(arch, params, stats).items()}, path)
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


@pytest.mark.parametrize("arch", UNPORTED)
def test_unported_encoders_raise(arch):
    """An encoder outside the zoo stops wherever a user meets it: the
    encoder, the converter and the exporter, with JAX's ValueErrors."""
    assert arch not in ENCODER_ARCHS and len(BACKBONES) == len(ENCODER_ARCHS) == 26
    for match, call in (("Encoder not supported", lambda: SATEncoder(arch)),
                        ("no converter", lambda: TT.convert_backbone(arch, {})),
                        ("no converter", lambda: JT.convert_backbone(arch, {})),
                        ("no exporter", lambda: TE.export_backbone(arch, {}, {})),
                        ("no exporter", lambda: JE.export_backbone(arch, {}, {}))):
        with pytest.raises(ValueError, match=match):
            call()


@pytest.fixture(scope="module")
def slice_json(tmp_path_factory):
    from sat_tpu.data.preprocess import make_synthetic_dataset
    out = tmp_path_factory.mktemp("ds_resnet")
    return make_synthetic_dataset(str(out), n_train=4, n_val=2, n_test=2,
                                  image_size=S, max_cap_length=6)


def test_resnet18_slice_train_step_matches_jax(slice_json, tmp_path, monkeypatch):
    """A tiny resnet18 model (encoder_size 3: the 2 x 2 map upsampled) with
    crop, flip, colour jitter, the optical warps and noise on: one
    Trainer.train_step on the CPU against JAX's jitted step, the port's
    augment fed JAX's draws for that step's key.  Metrics within 1e-5,
    every parameter and the BatchNorm statistics within rtol 5e-5 / atol
    5e-6, as tests/test_torch_train_step.py holds the shufflenet step."""
    kw = dict(encoder_arch="resnet18", input_size=S, encoder_size=3,
              embed_dim=16, attention_dim=16, decoder_dim=32, deep_output=True,
              json=slice_json, batch=4, epochs=1, mesh_shape=(1,),
              decoder_tf="always", dropout=0.0, embedding_dropout=0.0,
              label_smoothing=0.1, opt="sgd", momentum=0.0, decoder_lr=0.05,
              embedding_lr=0.05, grad_clip="norm", clip_value=1.0,
              aug_scale=0.8, aug_hflip=0.5, aug_color_jitter=0.4,
              aug_optical_strength=0.5, aug_noise_std=0.01, fast_rng=False, seed=0)
    jt = JaxTrainer(JaxConfig(**kw), log_root=str(tmp_path / "logs"))
    tree = as_float(jt.variables, np.float32)
    cfg = SATConfig.from_dict(jt.cfg.to_dict()).replace(json=None)
    tt = Trainer(cfg, device="cpu")
    tt.model.load_state_dict(model_from_jax_tree(cfg, tree).state_dict())
    batch = make_batch(4, cfg.vocab_size, seed=8)

    rng = jax.random.fold_in(jt._step_rng_base, 0)
    draws = jax_draws(jax.random.split(rng)[0], 4, cfg)
    assert {"perspective", "brightness", "flip", "area", "noise"} <= set(draws)
    monkeypatch.setattr(TA, "_draws", lambda g, b, hw, c, dev: draws)
    lrs = jt.scheduler.current_lrs(0)
    jt.variables, _, ref = jt._jit_train_step(
        jt.variables, jt.opt_state, {k: jnp.asarray(v) for k, v in batch.items()},
        {k: jnp.asarray(v, jnp.float32) for k, v in dict(lrs, encoder=0.0).items()},
        jnp.float32(1.0), rng, train_encoder=False)
    got = tt.train_step(batch)
    for k in ("loss", "ce_loss", "att_loss", "accuracy"):
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-5, err_msg=k)
    tvars, jvars = model_to_jax_tree(tt.model), as_float(jt.variables, np.float32)
    assert_trees(tvars["params"], jvars["params"], rtol=5e-5, atol=5e-6)
    assert_trees(tvars["state"], jvars["state"], rtol=5e-5, atol=5e-6)
