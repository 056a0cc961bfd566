"""The port's torchvision weight import (sat_tpu_torch.models.torch_import)
against sat_tpu.models.torch_import on the CPU, for the four
shufflenet_v2_* tables: seeded random state_dicts with torchvision's key
layout (tests/test_torch_import.py::torchvision_keys, whose shufflenet keys
all four tables share; the shapes are each table's), plus a classifier head
and num_batches_tracked entries that the converters drop.  The converted
trees, the merged model trees and SATModel.create with pretrained_weights
must be JAX's bit for bit."""

import jax
import numpy as np
import pytest
import torch

from sat_tpu.config import SATConfig as JaxConfig
from sat_tpu.models import torch_import as JT
from sat_tpu.models.model import SATModel as JaxModel
from sat_tpu_torch.config import SATConfig
from sat_tpu_torch.models import torch_import as TT
from sat_tpu_torch.models.encoder import encoder_from_config
from sat_tpu_torch.models.jax_import import encoder_to_jax, model_to_jax_tree
from sat_tpu_torch.models.model import SATModel
from test_torch_import import torchvision_keys
from test_torch_lightning import assert_trees_equal
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARCHS = TT.SHUFFLENET_ARCHS


def _find(tree, name):
    for p in name.split("/"):
        tree = tree[p]
    return tree


def random_state_dict(arch, seed=3):
    """torchvision's keys for ``arch`` with seeded values of its shapes."""
    params, stats = encoder_to_jax(encoder_from_config(SATConfig(encoder_arch=arch)))
    rng = np.random.default_rng(seed)
    sd = {}
    for tkey, fname in torchvision_keys("shufflenet_v2_x0_5"):
        if fname.startswith("stats:"):
            shape = _find(stats["backbone"], fname[6:]).shape
        else:
            shape = _find(params["backbone"], fname).shape
            if fname.endswith("kernel"):
                shape = (shape[3], shape[2], shape[0], shape[1])
        sd[tkey] = rng.normal(size=shape).astype(np.float32)
        if tkey.endswith("running_var"):
            sd[tkey] = np.abs(sd[tkey]) + 0.5
            sd[tkey[:-len("running_var")] + "num_batches_tracked"] = np.array(7)
    sd["fc.weight"] = rng.normal(size=(10, 4)).astype(np.float32)
    sd["fc.bias"] = np.zeros(10, np.float32)
    return sd


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_matches_jax(arch):
    sd = random_state_dict(arch)
    got, want = TT.convert_backbone(arch, dict(sd)), JT.convert_backbone(arch, dict(sd))
    assert_trees_equal({"params": got[0], "stats": got[1]},
                       {"params": want[0], "stats": want[1]})
    direct = TT.convert_shufflenet({k: v for k, v in sd.items()
                                    if not k.startswith("fc.")})
    assert_trees_equal({"params": direct[0], "stats": direct[1]},
                       {"params": want[0], "stats": want[1]})
    # every torchvision leaf lands in the tree, transposed OIHW -> HWIO
    assert np.array_equal(got[0]["conv1"]["kernel"],
                          sd["conv1.0.weight"].transpose(2, 3, 1, 0))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("fmt", ["npz", "pt"])
def test_import_pretrained_matches_jax(arch, fmt, tmp_path):
    sd = random_state_dict(arch, seed=4)
    path = str(tmp_path / f"w.{fmt}")
    if fmt == "npz":
        np.savez(path, **sd)
    else:
        torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, path)
    loaded, want_sd = TT.load_state_dict(path), JT.load_state_dict(path)
    assert loaded.keys() == want_sd.keys()
    assert all(np.array_equal(v, want_sd[k]) for k, v in loaded.items())
    cfg = SATConfig(encoder_arch=arch, input_size=64, vocab_size=20,
                    vocab_stoi=_stoi(20), embed_dim=8, attention_dim=8,
                    decoder_dim=16)
    model = SATModel.create(cfg, torch.Generator().manual_seed(0))
    got = TT.import_pretrained(arch, path, model_to_jax_tree(model))
    # JAX's import_pretrained on the same numpy tree
    want = JT.import_pretrained(arch, path, model_to_jax_tree(model))
    assert_trees_equal(got, want)
    assert_trees_equal(got["params"]["decoder"],
                       model_to_jax_tree(model)["params"]["decoder"])


def _stoi(v):
    stoi = {f"w{i}": i for i in range(1, v - 3)}
    stoi.update({"<UNK>": v - 3, "<START>": v - 2, "<END>": v - 1, "<PAD>": 0})
    return stoi


def test_model_create_with_pretrained_weights(tmp_path):
    """SATModel.create reads pretrained_weights as JAX's does: the encoder
    (backbone and batch statistics) equals JAX's bit for bit."""
    arch = "shufflenet_v2_x0_5"
    path = str(tmp_path / "w.npz")
    np.savez(path, **random_state_dict(arch, seed=5))
    kw = dict(encoder_arch=arch, input_size=64, vocab_size=20,
              vocab_stoi=_stoi(20), embed_dim=8, attention_dim=8,
              decoder_dim=16, pretrained=True, pretrained_weights=path)
    model = SATModel.create(SATConfig(**kw), torch.Generator().manual_seed(1))
    _, jvars = JaxModel.create(JaxConfig(**kw), jax.random.PRNGKey(1))
    jvars = jax.device_get(jvars)
    tree = model_to_jax_tree(model)
    assert_trees_equal(tree["params"]["encoder"]["backbone"],
                       jvars["params"]["encoder"]["backbone"])
    assert_trees_equal(tree["state"], jvars["state"])
    with pytest.raises(NotImplementedError, match="download"):
        SATModel.create(SATConfig(**dict(kw, pretrained_weights=None)),
                        torch.Generator().manual_seed(1))


def test_mismatched_state_dict_raises(tmp_path):
    """A state_dict of another table does not fit: a ValueError names the
    first leaf whose shape differs."""
    path = str(tmp_path / "w.npz")
    np.savez(path, **random_state_dict("shufflenet_v2_x1_0"))
    cfg = SATConfig(encoder_arch="shufflenet_v2_x0_5", input_size=64, vocab_size=20,
                    vocab_stoi=_stoi(20), embed_dim=8, attention_dim=8, decoder_dim=16)
    tree = model_to_jax_tree(SATModel.create(cfg, torch.Generator().manual_seed(0)))
    with pytest.raises(ValueError, match="shape mismatch"):
        TT.import_pretrained("shufflenet_v2_x0_5", path, tree)
