"""The port's checkpoint writing (sat_tpu_torch.train.checkpoints) against
sat_tpu.train.checkpoints on the CPU: the same bytes for the same config and
tree, JAX's reader on the port's file, and both packages' top-k and restart
managers fed the same sequences."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sat_tpu.config import SATConfig as JaxConfig
from sat_tpu.decode.beam import greedy_decode as jax_greedy
from sat_tpu.train import checkpoints as jax_ckpt
from sat_tpu_torch.config import SATConfig
from sat_tpu_torch.decode.beam import greedy_decode
from sat_tpu_torch.models.jax_import import model_to_jax_tree
from sat_tpu_torch.models.model import SATModel
from sat_tpu_torch.train import checkpoints
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

SMALL = dict(encoder_arch="shufflenet_v2_x0_5", input_size=32, encoder_dim=32,
             embed_dim=16, attention_dim=16, decoder_dim=32, deep_output=True)


def vocab(v=20):
    stoi = {f"w{i}": i for i in range(1, v - 3)}
    stoi.update({"<UNK>": v - 3, "<START>": v - 2, "<END>": v - 1, "<PAD>": 0})
    return dict(vocab_size=v, vocab_stoi=stoi)


def configs(**kw):
    d = dict(SMALL, **vocab(), **kw)
    return JaxConfig(**d), SATConfig(**d)


def mixed_tree(seed):
    """Arrays of several dtypes and sizes (fixext and ext8/16/32 bodies),
    0-d ints and floats (some negative or large), nested dicts whose keys
    are out of order, strings, None."""
    rng = np.random.default_rng(seed)
    return {
        "params": {"z": {"w": rng.standard_normal((300, 70)).astype(np.float32),
                         "b": rng.standard_normal(3).astype(np.float64)},
                   "a": {"k": rng.integers(-5, 5, (2, 3)).astype(np.int32),
                         "m": rng.integers(0, 255, 7).astype(np.uint8),
                         "h": rng.standard_normal(4).astype(np.float16),
                         "flag": np.array([True, False])}},
        "step": 123456, "epoch": 3, "count": -7, "big": 2 ** 40,
        "scheduler": {"factor": 0.1, "plateau_best": -1.5, "plateau_bad_epochs": 2},
        "early_stop": {"best": float("-inf"), "count": 0},
        "top_k": {"0": {"value": 0.25, "name": "epoch=0-step=8-bleu4=0.2500.ckpt"},
                  "1": {"value": 0.5, "name": "x" * 40}},
        "empty": {}, "none": None,
    }


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_same_bytes_as_jax(tmp_path, seed):
    jcfg, tcfg = configs(seed=seed)
    tree = mixed_tree(seed)
    jax_ckpt.save_checkpoint(str(tmp_path / "jax.ckpt"), jcfg, tree)
    checkpoints.save_checkpoint(str(tmp_path / "port.ckpt"), tcfg, tree)
    with open(tmp_path / "jax.ckpt", "rb") as a, open(tmp_path / "port.ckpt", "rb") as b:
        assert a.read() == b.read()


def test_jax_reads_the_port_file(tmp_path):
    """sat_tpu's load_checkpoint gives the tree the port wrote (tensors in,
    numpy out), the port's reader gives it back too, and JAX's greedy
    tokens from the file equal the port's."""
    _, tcfg = configs()
    model = SATModel.create(tcfg, torch.Generator().manual_seed(3))
    tree = model_to_jax_tree(model)
    tree.update(step=5, epoch=1, early_stop={"best": 0.5, "count": 1},
                top_k={"0": {"value": 0.5, "name": "a.ckpt"}})
    path = str(tmp_path / "m.ckpt")
    checkpoints.save_checkpoint(path, model.cfg, tree)

    cfg, got = jax_ckpt.load_checkpoint(path)
    assert cfg.to_dict() == JaxConfig(**model.cfg.to_dict()).to_dict()
    ref, got = flat(tree), flat(got)
    assert ref.keys() == got.keys()
    for k in ref:
        if isinstance(ref[k], str):
            assert got[k] == ref[k]
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]), err_msg=k)
            assert np.asarray(got[k]).dtype == np.asarray(ref[k]).dtype, k

    back, extras = checkpoints.load_model_from_checkpoint(path, device="cpu")
    assert int(extras["step"]) == 5 and extras["opt_state_raw"] is None
    sd, back_sd = model.state_dict(), back.state_dict()
    assert sd.keys() == back_sd.keys()
    for k in sd:
        assert torch.equal(sd[k], back_sd[k]), k

    jmodel, jvars, _ = jax_ckpt.load_model_from_checkpoint(path)
    imgs = np.random.default_rng(1).uniform(size=(3, 32, 32, 3)).astype(np.float32)
    jres = jax_greedy(jvars["params"]["decoder"], jmodel.cfg,
                      jmodel.encode(jvars, jnp.asarray(imgs)), max_gen_length=6)
    tres = greedy_decode(model.decoder, model.cfg,
                         model.encode(torch.from_numpy(imgs)), max_gen_length=6,
                         fused=False)
    np.testing.assert_array_equal(tres.tokens.numpy(), np.asarray(jres.tokens))


def _tree():
    return {"params": {"w": np.arange(6, dtype=np.float32)}, "step": 1}


@pytest.mark.parametrize("top_k,every", [(1, 1), (2, 1), (2, 2), (0, 3)])
def test_top_k_manager_matches_jax(tmp_path, top_k, every):
    jcfg, tcfg = configs(save_last_every=every)
    jm = jax_ckpt.TopKCheckpointManager(str(tmp_path / "jax"), "bleu4", top_k)
    tm = checkpoints.TopKCheckpointManager(str(tmp_path / "port"), "bleu4", top_k)
    values = [0.1, 0.3, 0.2, 0.3, 0.5, 0.05, 0.4]
    for i, v in enumerate(values):
        m = {"bleu4": v, "gleu": 1 - v}
        jm.on_validation_end(jcfg, _tree, m, i, 10 * i)
        tm.on_validation_end(tcfg, _tree, m, i, 10 * i)
        assert sorted(os.listdir(tmp_path / "jax")) == sorted(os.listdir(tmp_path / "port"))
        assert tm.state_dict() == jm.state_dict()
    tm.on_validation_end(tcfg, _tree, {}, 9, 90)       # empty metrics: nothing
    assert tm.best_value == jm.best_value
    for name in os.listdir(tmp_path / "jax"):
        with open(tmp_path / "jax" / name, "rb") as a, \
                open(tmp_path / "port" / name, "rb") as b:
            assert a.read() == b.read(), name


@pytest.mark.parametrize("warmup", [0, 3])
def test_restart_manager_matches_jax(tmp_path, warmup):
    jcfg, tcfg = configs()
    jm = jax_ckpt.RestartCheckpointManager(str(tmp_path / "jax"), warmup)
    tm = checkpoints.RestartCheckpointManager(str(tmp_path / "port"), warmup)
    lrs = [0.1, 0.2, 0.3, 0.1, 0.05, 0.3, 0.3, 0.2, 0.4, 0.01, 0.5]
    fired = []
    for step, lr in enumerate(lrs, start=1):
        a = jm.on_train_batch_end(jcfg, _tree, step, lr)
        b = tm.on_train_batch_end(tcfg, _tree, step, lr)
        assert (a is None) == (b is None)
        if b is not None:
            assert os.path.basename(a) == os.path.basename(b)
            fired.append(step)
    assert fired and sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "jax"))


def test_unwritable_leaves_raise(tmp_path):
    _, tcfg = configs()
    with pytest.raises(TypeError):
        checkpoints.save_checkpoint(str(tmp_path / "x.ckpt"), tcfg,
                                    {"x": torch.zeros(2, dtype=torch.bfloat16)})
