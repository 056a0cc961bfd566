"""device_resident_data and steps_per_dispatch in the port
(sat_tpu_torch.train.loop.Trainer) on the CPU, after
tests/test_device_resident.py: the staged epoch against the host loader's
(bit for bit: the same batches, trims and draws) at every steps_per_dispatch,
which the port accepts and runs step by step, as JAX's chunks are cut to
repeat the per-step run (a ragged tail, the encoder's unfreezing, a rise of
the LR with its restart files); validation from the staged pixels; the
oversize centre crop and its warning; one deterministic epoch against JAX's
device-resident Trainer in chunks of 2."""

import glob
import json
import os

import jax
import numpy as np
import pytest
import torch

from sat_tpu import config as jax_config
from sat_tpu.train.loop import Trainer as JaxTrainer
from sat_tpu_torch import config
from sat_tpu_torch.data.images import write_png
from sat_tpu_torch.data.preprocess import make_synthetic_dataset
from sat_tpu_torch.models.jax_import import model_from_jax_tree, model_to_jax_tree
from sat_tpu_torch.train.loop import Trainer
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


def cfg_(js, **kw):
    """tests/test_device_resident.py's settings: every draw on."""
    d = dict(json=js, batch=8, epochs=1, input_size=32, encoder_arch="shufflenet_v2_x0_5",
             encoder_dim=16, embed_dim=8, attention_dim=8, decoder_dim=16,
             decoder_tf="inv_sigmoid", bucket_sampler=True, val_interval=100, seed=3,
             val_beamk=2, val_max_len=5, dropout=0.3)
    d.update(kw)
    return config.SATConfig(**d)


def trainer(cfg, tmp_path, tag):
    return Trainer(cfg, log_root=str(tmp_path / tag), device="cpu")


def same_state(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    return sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)


@pytest.fixture(scope="module")
def js32(tmp_path_factory):
    return make_synthetic_dataset(str(tmp_path_factory.mktemp("dr_ds")), n_train=32,
                                  n_val=8, image_size=32, max_cap_length=6)


@pytest.mark.parametrize("spd,finetune_after", [(1, 0), (3, 0), (8, 2)])
def test_staged_epoch_is_the_host_path(js32, tmp_path, spd, finetune_after):
    """4 steps at spd 1, 3 (JAX: chunks of 3 + 1) and 8 (JAX: a chunk cut
    where the encoder starts training, step 2).  Weights, BatchNorm
    statistics, metrics and the validation are the host path's, bit for
    bit."""
    kw = dict(encoder_finetune_after=finetune_after, encoder_lr=0.01)
    host = trainer(cfg_(js32, **kw), tmp_path, "host")
    dev = trainer(cfg_(js32, device_resident_data=True, steps_per_dispatch=spd, **kw),
                  tmp_path, "dev")
    assert dev._staged_images.dtype == torch.uint8
    assert tuple(dev._staged_images.shape) == (32, 32, 32, 3)
    assert tuple(dev._staged_val_images.shape) == (8, 32, 32, 3)
    assert set(dev.staging_seconds) == {"train", "val"}
    m_host, m_dev = host.train_epoch(), dev.train_epoch()
    assert host.global_step == dev.global_step == 4
    assert m_host == m_dev
    assert same_state(host, dev)
    assert host.validate() == dev.validate()


def test_chunks_cut_at_a_rise_of_the_lr(tmp_path):
    """A cosine warm restart at step 5 of an 8-step epoch, inside what JAX
    runs as one 8-step chunk (cut there): spd 8 writes the restart files
    of spd 1 and trains to its weights bit for bit."""
    js = make_synthetic_dataset(str(tmp_path / "ds"), n_train=64, n_val=8, image_size=32,
                                max_cap_length=6)
    kw = dict(scheduler="cosine", cosine_iterations=3, lr_warmup_steps=0,
              device_resident_data=True)
    per_step = trainer(cfg_(js, steps_per_dispatch=1, **kw), tmp_path, "l1")
    chunked = trainer(cfg_(js, steps_per_dispatch=8, **kw), tmp_path, "l8")
    per_step.train_epoch()
    chunked.train_epoch()
    files = [sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(t.logdir, "restart-*.ckpt"))) for t in (per_step, chunked)]
    assert files[0], "no warm restart in the per-step run"
    assert files[0] == files[1]
    assert same_state(per_step, chunked)


def test_oversize_images_center_crop_with_warning(tmp_path, capsys):
    js = make_synthetic_dataset(str(tmp_path / "ds"), n_train=8, n_val=8, image_size=32,
                                max_cap_length=6)
    rng = np.random.default_rng(0)
    with open(js) as f:
        paths = json.load(f)["train"]["img_paths"]
    # 32 x 64: the shorter side is already 32, so staging crops the centre
    wide = rng.integers(0, 256, (len(paths), 32, 64, 3), np.uint8)
    for p, img in zip(paths, wide):
        write_png(p, img)
    t = trainer(cfg_(js, device_resident_data=True, native_decode=False), tmp_path, "l")
    assert tuple(t._staged_images.shape) == (8, 32, 32, 3)
    np.testing.assert_array_equal(t._staged_images.numpy(), wide[:, :, 16:48])
    out = capsys.readouterr().out
    assert "WARNING: 8/8 train images" in out and "center crop" in out
    assert np.isfinite(t.train_epoch()["loss"])


def test_staged_data_needs_a_dataset():
    from test_torch_train_step import SMALL, vocab
    cfg = config.SATConfig(**dict(SMALL, **vocab(), train_loader_len=4,
                                  device_resident_data=True))
    with pytest.raises(ValueError, match="device_resident_data"):
        Trainer(cfg, device="cpu")


def test_epoch_matches_jax_device_resident(js32, tmp_path):
    """One epoch of 4 steps in chunks of 2, deterministic (SGD, teacher
    forcing always, no augmentation, no dropout), in both packages' staged
    paths from JAX's weights: metrics within rtol 1e-4 and the weights
    within tests/test_torch_fit.py's rtol 5e-5, atol 5e-6."""
    kw = dict(device_resident_data=True, steps_per_dispatch=2, decoder_tf="always",
              dropout=0.0, embedding_dropout=0.0, aug_scale=1.0, aug_hflip=0.0,
              aug_noise_std=0.0, opt="sgd", momentum=0.0, decoder_lr=0.05,
              embedding_lr=0.05, mesh_shape=(1,))
    jt = JaxTrainer(jax_config.SATConfig(**cfg_(js32, **kw).to_dict()),
                    log_root=str(tmp_path / "jax"))
    tt = trainer(cfg_(js32, **kw), tmp_path, "port")
    tt.model.load_state_dict(model_from_jax_tree(
        tt.cfg, jax.device_get(jt.variables)).state_dict())
    np.testing.assert_array_equal(tt._staged_images.numpy(), np.asarray(jt._staged_images))
    m_jax, m_port = jt.train_epoch(), tt.train_epoch()
    assert jt.global_step == tt.global_step == 4
    for k in ("loss", "ce_loss", "att_loss", "accuracy"):
        np.testing.assert_allclose(m_port[k], m_jax[k], rtol=1e-4, err_msg=k)
    got = model_to_jax_tree(tt.model)
    want = jax.device_get(jt.variables)
    for part in ("params", "state"):
        flat_g = jax.tree_util.tree_leaves_with_path(got[part])
        flat_w = dict(jax.tree_util.tree_leaves_with_path(want[part]))
        assert len(flat_g) == len(flat_w)
        for path, leaf in flat_g:
            np.testing.assert_allclose(leaf, np.asarray(flat_w[path]), rtol=5e-5, atol=5e-6,
                                       err_msg=jax.tree_util.keystr(path))
