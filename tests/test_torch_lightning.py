"""Reference Lightning checkpoints in the port (models/lightning_import.py,
models/lightning_export.py, train/checkpoints.py::load_any_checkpoint)
against sat_tpu's importer and exporter on the CPU.

For each of the four shufflenet_v2_* tables, a tiny model (64 px, narrow
decoder, drawn by the port's SATModel.create and written as a SATTPU1 file,
the bytes JAX writes) is turned into a Lightning .ckpt in tmp_path by
sat_tpu.models.lightning_export (build_lightning_checkpoint through its
main).  The port's load_reference_checkpoint must give JAX's config, JAX's
variables tree bit for bit (through model_to_jax_tree) and JAX's beam
tokens on the same annotations; the port's exporter must give JAX's file
key for key and value for value; load_any_checkpoint must read both
formats alike.  The BatchNorm running statistics are drawn too, so that
every leaf's mapping is checked."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sat_tpu.decode.beam import beam_search as jax_beam
from sat_tpu.models import lightning_export as JE
from sat_tpu.models import lightning_import as JI
from sat_tpu.train import checkpoints as jax_ckpt
from sat_tpu_torch.config import SATConfig
from sat_tpu_torch.decode.beam import beam_search
from sat_tpu_torch.models import lightning_export as TE
from sat_tpu_torch.models import lightning_import as TI
from sat_tpu_torch.models import torch_import
from sat_tpu_torch.models.jax_import import model_to_jax_tree
from sat_tpu_torch.models.model import SATModel
from sat_tpu_torch.train.checkpoints import load_any_checkpoint, save_checkpoint
from test_torch_serve import tiny_cfg
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARCHS = ("shufflenet_v2_x0_5", "shufflenet_v2_x1_0", "shufflenet_v2_x1_5",
         "shufflenet_v2_x2_0")


def leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(v)


def assert_trees_equal(got, ref):
    got, ref = dict(leaves(got)), dict(leaves(ref))
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.fixture(scope="module", params=ARCHS)
def lightning(request, tmp_path_factory):
    """(arch, SATTPU1 path, Lightning path written by JAX's exporter)."""
    out = tmp_path_factory.mktemp(request.param)
    sat = str(out / "m.ckpt")
    cfg = SATConfig(**tiny_cfg(request.param).to_dict())
    g = torch.Generator().manual_seed(1)
    model = SATModel.create(cfg, g)
    for m in model.encoder.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.normal_(generator=g)
            m.running_var.uniform_(0.5, 2.0, generator=g)
    save_checkpoint(sat, model.cfg, dict(model_to_jax_tree(model), step=0, epoch=0))
    ref = str(out / "ref.ckpt")
    JE.main(["--input", sat, "--output", ref])
    return request.param, sat, ref


def test_import_matches_jax(lightning):
    arch, _, ref = lightning
    jcfg, jvars, jgrid = JI.load_reference_checkpoint(ref)
    cfg, model, grid = TI.load_reference_checkpoint(ref, device="cpu")
    assert cfg.encoder_arch == arch
    assert cfg.to_dict() == jcfg.to_dict() and tuple(grid) == tuple(jgrid)
    assert_trees_equal(model_to_jax_tree(model), jax.device_get(jvars))

    imgs = np.random.default_rng(1).random((2, 64, 64, 3), np.float32)
    annots = model.encode(torch.from_numpy(imgs))
    kw = dict(beamk=3, max_gen_length=8, rescore_method="LN")
    jr = jax_beam(jvars["params"]["decoder"], jcfg, jnp.asarray(annots.numpy()), **kw)
    tr = beam_search(model.decoder, cfg, annots, **kw)
    np.testing.assert_array_equal(tr.tokens.numpy(), np.asarray(jr.tokens))
    np.testing.assert_array_equal(tr.lengths.numpy(), np.asarray(jr.lengths))


def test_export_matches_jax(lightning, tmp_path):
    _, sat, ref = lightning
    jcfg, jraw = jax_ckpt.load_checkpoint(sat)
    model = load_any_checkpoint(sat, device="cpu")
    want = JE.build_lightning_checkpoint(jcfg, {"params": jraw["params"],
                                                "state": jraw["state"]})
    got = TE.build_lightning_checkpoint(model.cfg, model_to_jax_tree(model))
    assert list(got) == list(want)
    assert got["hyper_parameters"] == want["hyper_parameters"]
    assert list(got["state_dict"]) == list(want["state_dict"])
    for k, v in want["state_dict"].items():
        assert got["state_dict"][k].dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(got["state_dict"][k], np.asarray(v), err_msg=k)

    # the CLIs' files: torch.load of each gives the same dict
    path = str(tmp_path / "port.ckpt")
    TE.main(["--input", sat, "--output", path])
    a = torch.load(path, map_location="cpu", weights_only=False)
    b = torch.load(ref, map_location="cpu", weights_only=False)
    assert {k: v for k, v in a.items() if k != "state_dict"} == \
        {k: v for k, v in b.items() if k != "state_dict"}
    assert list(a["state_dict"]) == list(b["state_dict"])
    for k in b["state_dict"]:
        assert torch.equal(a["state_dict"][k], b["state_dict"][k]), k


def test_load_any_checkpoint_reads_both_formats(lightning, tmp_path):
    _, sat, ref = lightning
    a = load_any_checkpoint(sat, device="cpu").state_dict()
    b = load_any_checkpoint(ref, device="cpu").state_dict()
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(t.is_contiguous() for t in b.values())   # converted Linear weights
    # the importer's CLI writes JAX's SATTPU1 file, byte for byte
    got, want = str(tmp_path / "port.ckpt"), str(tmp_path / "jax.ckpt")
    TI.main(["--input", ref, "--output", got], device="cpu")
    JI.main(["--input", ref, "--output", want])
    with open(got, "rb") as f, open(want, "rb") as g:
        assert f.read() == g.read()


def test_other_encoders_raise():
    """A checkpoint of an encoder outside the zoo: the port's converter,
    importer and exporter stop with JAX's ValueErrors."""
    jcfg = tiny_cfg("vgg16")
    cfg = SATConfig(**jcfg.to_dict())
    ckpt = {"state_dict": {"encoder.1.weight": np.zeros((8, 3, 7, 7), np.float32)},
            "hyper_parameters": cfg.to_dict()}
    tree = {"params": {"encoder": {"backbone": {}}, "decoder": {}}, "state": {}}
    for what, call in (("converter", lambda: TI.load_reference_checkpoint(ckpt, device="cpu")),
                       ("converter", lambda: JI.load_reference_checkpoint(ckpt)),
                       ("converter", lambda: torch_import.convert_backbone("vgg16", {})),
                       ("exporter", lambda: TE.build_lightning_checkpoint(cfg, tree)),
                       ("exporter", lambda: JE.build_lightning_checkpoint(jcfg, tree))):
        with pytest.raises(ValueError, match=f"no {what} for vgg16"):
            call()


def test_no_card_raises(lightning):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, sat, ref = lightning
    for path in (sat, ref):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            load_any_checkpoint(path)
    assert os.path.exists(ref)
