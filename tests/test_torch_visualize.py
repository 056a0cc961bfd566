"""The attention visualizer of sat_tpu_torch against sat_tpu's, on the CPU
at float32, on tests/test_torch_search.py's setup (one checkpoint read by
both packages): the printed lines with the inference time masked, the
masks of JAX's formula on JAX's alphas byte for byte, ``--image``'s
conflicts, and the figure file."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from sat_tpu.data.dataset import CaptionDataset as JaxDataset
from sat_tpu.decode.api import caption_from_annotations as jax_caption
from sat_tpu.evalx import visualize as JV
from sat_tpu.train.checkpoints import load_model_from_checkpoint as jax_load
from sat_tpu.utils.images import load_square
from sat_tpu_torch.data.dataset import CaptionDataset
from sat_tpu_torch.decode.api import caption_from_annotations
from sat_tpu_torch.evalx import visualize as TV
from sat_tpu_torch.train.checkpoints import load_any_checkpoint
from test_torch_search import tool_setup
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

KW = dict(beamk=3, max_gen_length=6, show_topk=3)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    out = tmp_path_factory.mktemp("visualize")
    json_path, ckpt = tool_setup(out)
    jm, jv, _ = jax_load(ckpt)
    return out, json_path, ckpt, (jm, jv), load_any_checkpoint(ckpt, device="cpu")


def _masked(text):
    return re.sub(r"Inference in [0-9.]+ ms", "Inference in <t> ms", text)


@pytest.mark.parametrize("source", ["idx0", "idx4", "image"])
def test_printed_lines_match_jax(models, capsys, source):
    """Every printed line equal to JAX's but the time: the references, the
    length, each prediction's score and perplexity, the single-image BLEU."""
    out, json_path, _, (jm, jv), tm = models
    jds, tds = JaxDataset(json_path, "val"), CaptionDataset(json_path, "val")
    kw = (dict(image_path=tds.img_paths[2]) if source == "image"
          else dict(idx=int(source[3:])))
    ref = JV.make_visual(jm, jv, jds, out_dir=str(out / "jax"), **KW, **kw)
    jtext = capsys.readouterr().out
    got = TV.make_visual(tm, tds, out_dir=str(out / "port"), **KW, **kw)
    text = capsys.readouterr()
    assert _masked(text.out) == _masked(jtext)
    assert ("Caption 0 : " in jtext) == (source != "image")
    assert "decode route: plain (not a CUDA device)" in text.err
    assert os.path.basename(got) == os.path.basename(ref)
    fig = Image.open(got)
    assert fig.format == "JPEG" and fig.size[0] >= 2 * 256


def _jax_masks(atts):
    """sat_tpu/evalx/visualize.py:116-129, as JAX's tool computes them."""
    words = []
    for att in atts:
        att = ((att - att.min()) / max(att.max() - att.min(), 1e-8)) ** 5.0
        words.append(np.asarray(Image.fromarray(np.uint8(att * 255)).convert("RGB")
                                .resize((256, 256))))
    att = atts.sum(0)
    att = (att - att.min()) / max(att.max() - att.min(), 1e-8)
    return words, np.asarray(Image.fromarray(np.uint8(att * 255)).convert("RGB")
                             .resize((256, 256)))


def test_masks_match_jax_formula(models):
    """``attention_masks`` on JAX's alphas of each val image's best caption
    equals JAX's formula byte for byte; the port's own alphas are within
    1e-5 of JAX's."""
    _, json_path, _, (jm, jv), tm = models
    ds = CaptionDataset(json_path, "val")
    imgs = np.stack([np.asarray(load_square(p, 256).resize((64, 64)), np.float32)
                     for p in ds.img_paths]) / 255.0
    _, _, jal, _ = jax_caption(jv["params"]["decoder"], jm.cfg,
                               jm.encode(jv, jnp.asarray(imgs), train=False),
                               jm.grid_hw, beamk=3, max_gen_length=6,
                               rescore_method="LN", return_all=True)
    _, _, tal, _ = caption_from_annotations(
        tm.decoder, tm.cfg, tm.encode(torch.from_numpy(imgs)), tm.grid_hw,
        beamk=3, max_gen_length=6, rescore_method="LN", return_all=True)
    varied = 0
    for j, t in zip(jal, tal):
        atts = np.asarray(j[0], np.float32)
        words, total = TV.attention_masks(atts)
        ref_words, ref_total = _jax_masks(atts)
        assert len(words) == len(ref_words) == len(atts)
        for w, r in zip(words, ref_words):
            assert w.dtype == np.uint8 and w.shape == (256, 256, 3)
            np.testing.assert_array_equal(w, r)
            varied += int(w.max() > w.min())
        np.testing.assert_array_equal(total, ref_total)
        np.testing.assert_allclose(t[0], j[0], rtol=0, atol=1e-5)
    assert varied > 0


def test_image_conflicts_with_idx_and_json(models, capsys):
    """``--image`` with ``--idx`` or ``--json`` exits with JAX's usage
    error, in both packages."""
    _, json_path, ckpt, _, _ = models
    img = CaptionDataset(json_path, "val").img_paths[0]
    for extra in (["--idx", "0"], ["--json", json_path]):
        argv = ["--checkpoint", ckpt, "--image", img] + extra
        with pytest.raises(SystemExit) as ref:
            JV.main(argv)
        jerr = capsys.readouterr().err
        with pytest.raises(SystemExit) as got:
            TV.main(argv, device="cpu")
        err = capsys.readouterr().err
        assert got.value.code == ref.value.code == 2
        assert "--image conflicts with --idx/--json" in err
        assert err.splitlines()[-1] == jerr.splitlines()[-1]


def test_main_cli(models, capsys):
    """``python -m sat_tpu_torch.evalx.visualize``: JAX's flags and the
    figure's path printed last."""
    out, json_path, ckpt, _, _ = models
    path = TV.main(["--checkpoint", ckpt, "--json", json_path, "--idx", "1",
                    "--beamk", "2", "--max_gen_length", "6", "--out_dir",
                    str(out / "cli")], device="cpu")
    assert capsys.readouterr().out.splitlines()[-1] == f"saved: {path}"
    assert os.path.exists(path) and path.endswith("_result.jpg")
