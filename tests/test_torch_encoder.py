"""The port's eval encoder against SATModel.encode(train=False) and the image
ops against sat_tpu.ops.image_ops, on the CPU at float32."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sat_tpu.config import SATConfig as JaxConfig
from sat_tpu.models.encoder import build_encoder
from sat_tpu.models.encoder import probe_encoder as jax_probe
from sat_tpu.ops import image_ops as jops
from sat_tpu.train.checkpoints import load_model_from_checkpoint as jax_load
from sat_tpu_torch.config import SATConfig
from sat_tpu_torch.models.encoder import encoder_from_config, probe_encoder
from sat_tpu_torch.models.jax_import import load_encoder_weights
from sat_tpu_torch.ops import image_ops as tops
from sat_tpu_torch.train.checkpoints import load_model_from_checkpoint
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

DATA = os.path.join(os.path.dirname(__file__), "data")


def _tol(ref):
    # float32 summation order, and the JAX path's normalise folded into conv1
    # (models/shufflenet_folded.py): the error scales with the feature
    # magnitude, which reaches ~200 in the trained n64 encoder
    return 1e-5 * max(1.0, float(np.abs(ref).max()))


@pytest.mark.parametrize("name", ["golden_v1.ckpt", "best_n64_r4_serving.ckpt"])
def test_encode_matches_jax(name):
    path = os.path.join(DATA, name)
    jm, jv, _ = jax_load(path)
    tm, _ = load_model_from_checkpoint(path, device="cpu")
    size = jm.cfg.input_size
    imgs = np.random.default_rng(1).uniform(size=(2, size, size, 3)).astype(np.float32)
    ref = np.asarray(jm.encode(jv, jnp.asarray(imgs), train=False))
    got = tm.encode(torch.from_numpy(imgs)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=_tol(ref))
    assert tm.grid_hw == tuple(jm.grid_hw)


@pytest.mark.parametrize("arch,size,dim,esize", [
    ("shufflenet_v2_x0_5", 64, 40, 3),     # proj + bilinear upsample 2 -> 3
    ("shufflenet_v2_x1_0", 96, None, 2),   # adaptive pool 3 -> 2
])
def test_encoder_proj_and_resize(arch, size, dim, esize):
    jcfg = JaxConfig(encoder_arch=arch, input_size=size, encoder_dim=dim,
                     encoder_size=esize)
    module, variables, jcfg, grid = build_encoder(jcfg, jax.random.PRNGKey(0))
    cfg = SATConfig(encoder_arch=arch, input_size=size, encoder_dim=dim,
                    encoder_size=esize)
    assert probe_encoder(cfg) == jax_probe(jcfg)
    enc = load_encoder_weights(encoder_from_config(cfg),
                               jax.tree_util.tree_map(np.asarray, variables["params"]),
                               jax.tree_util.tree_map(np.asarray, variables["batch_stats"]))
    imgs = np.random.default_rng(2).uniform(size=(2, size, size, 3)).astype(np.float32)
    ref = np.asarray(module.apply(variables, jnp.asarray(imgs)))
    got = enc.eval()(torch.from_numpy(imgs)).detach().numpy()
    assert got.shape == ref.shape == (2, esize * esize, jcfg.encoder_dim)
    np.testing.assert_allclose(got, ref, rtol=0, atol=_tol(ref))


@pytest.mark.parametrize("hw,out", [((7, 7), (3, 3)), ((5, 7), (2, 3)),
                                    ((6, 4), (3, 2)), ((9, 10), (4, 4))])
def test_adaptive_avg_pool2d(hw, out):
    x = np.random.default_rng(3).normal(size=(2,) + hw + (5,)).astype(np.float32)
    ref = np.asarray(jops.adaptive_avg_pool2d(jnp.asarray(x), out))
    got = tops.adaptive_avg_pool2d(torch.from_numpy(x), out).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("hw,out", [((2, 2), (3, 3)), ((3, 5), (7, 8)),
                                    ((1, 1), (4, 4))])
def test_bilinear_resize_upsample(hw, out):
    x = np.random.default_rng(4).normal(size=(2,) + hw + (3,)).astype(np.float32)
    ref = np.asarray(jops.bilinear_resize(jnp.asarray(x), out))
    got = tops.bilinear_resize(torch.from_numpy(x), out).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_normalize_image():
    x = np.random.default_rng(5).uniform(size=(2, 4, 4, 3)).astype(np.float32)
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    ref = np.asarray(jops.normalize_image(jnp.asarray(x), mean, std))
    got = tops.normalize_image(torch.from_numpy(x), mean, std).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
