"""The port's serving CLI (sat_tpu_torch.serve) against sat_tpu.serve on the
CPU: the same JSONL from one tiny SATTPU1 checkpoint (shufflenet_v2_x0_5,
64 px, narrow decoder) and 11 files (5 PNG, 5 JPEG, 1 corrupt), at
--batch 4 (two full batches and a padded tail) and --precision 32; captions
and error records identical, score within 1e-5 and perplexity within 1e-5
of its value (a random model's perplexity is near 85, where one float32
step is 7.6e-6).  Beam search
with and without --return_all; multinomial and topk sampling under one
fixed noise array patched into jax.random.gumbel and the port's
decode.beam.gumbel_noise (the pattern of tests/test_torch_beam.py).
--precision 16 is held against the port's own SATModel.caption on the cast
model.

Both packages' C++ decode pools are switched off, so both read the same
pixels through PIL: this file holds the PIL route, and
tests/test_torch_native.py holds the two pools' route, where both are on
(libjpeg's pixels differ from PIL's by 1-2 levels).  JAX runs on a
one-device mesh (--mesh_shape 1), so both batch alike."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import sat_tpu.native
import sat_tpu_torch.native
from sat_tpu import serve as jax_serve
from sat_tpu.config import SATConfig as JaxConfig
from sat_tpu.models.model import SATModel as JaxModel
from sat_tpu.train.checkpoints import save_checkpoint as jax_save
from sat_tpu_torch import serve
from sat_tpu_torch.decode import beam as TB
from sat_tpu_torch.train import checkpoints
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ATOL = 1e-5
BASE = ["--batch", "4", "--beamk", "3", "--max_gen_length", "6",
        "--precision", "32", "--mesh_shape", "1"]


def tiny_cfg(arch="shufflenet_v2_x0_5", **kw):
    v = 40
    stoi = {f"w{i}": i for i in range(1, v - 3)}
    stoi.update({"<UNK>": v - 3, "<START>": v - 2, "<END>": v - 1, "<PAD>": 0})
    d = dict(encoder_arch=arch, input_size=64, encoder_dim=32, vocab_size=v,
             vocab_stoi=stoi, embed_dim=16, attention_dim=16, decoder_dim=32,
             deep_output=True)
    d.update(kw)
    return JaxConfig(**d)


def write_tiny_checkpoint(path, seed=0, **kw):
    model, variables = JaxModel.create(tiny_cfg(**kw), jax.random.PRNGKey(seed))
    jax_save(path, model.cfg, {
        "params": jax.device_get(variables["params"]),
        "state": jax.device_get(variables["state"]), "step": 0, "epoch": 0})
    return model, variables


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    out = tmp_path_factory.mktemp("serve")
    ck = str(out / "m.ckpt")
    write_tiny_checkpoint(ck)
    imgdir = out / "imgs"
    imgdir.mkdir()
    rng = np.random.default_rng(0)
    for i in range(5):
        arr = rng.integers(0, 255, (80, 100, 3), dtype=np.uint8)
        Image.fromarray(arr).save(str(imgdir / f"i{i}.png"))
        Image.fromarray(arr).save(str(imgdir / f"j{i}.jpg"), quality=90)
    with open(imgdir / "k_corrupt.jpg", "w") as f:
        f.write("not an image at all")
    return ck, str(imgdir)


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def pil_only(monkeypatch):
    """Both packages decode with PIL."""
    for mod in (sat_tpu.native, sat_tpu_torch.native):
        monkeypatch.setattr(mod, "shared_pool", lambda: None)


def run_both(served, tmp_path, extra, monkeypatch):
    ck, imgdir = served
    pil_only(monkeypatch)
    argv = ["--checkpoint", ck, "--images", imgdir] + BASE + extra
    outs = {}
    for name, fn in (("jax", jax_serve.main),
                     ("port", lambda a: serve.main(a, device="cpu"))):
        outs[name] = str(tmp_path / f"{name}.jsonl")
        assert fn(argv + ["--output", outs[name]]) == 0
    return _records(outs["jax"]), _records(outs["port"])


def assert_same_records(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert list(g) == list(r)          # the same keys, in the same order
        assert g["image"] == r["image"]
        if "error" in r:
            assert g == r
            continue
        pairs = (zip(g["candidates"], r["candidates"]) if "candidates" in r
                 else [(g, r)])
        if "candidates" in r:
            assert len(g["candidates"]) == len(r["candidates"])
        for gc, rc in pairs:
            assert list(gc) == list(rc)
            assert gc["caption"] == rc["caption"]
            assert abs(gc["score"] - rc["score"]) <= ATOL
            assert abs(gc["perplexity"] - rc["perplexity"]) <= ATOL * rc["perplexity"]


@pytest.mark.parametrize("extra", [
    ["--rescore_method", "LN"],
    ["--rescore_method", "LN", "--return_all"],
    ["--rescore_method", "None", "--no_early_exit"],
], ids=["beam", "return_all", "no_rescore"])
def test_serve_jsonl_matches_jax(served, tmp_path, monkeypatch, extra):
    ref, got = run_both(served, tmp_path, extra, monkeypatch)
    assert len(ref) == 11 and [r["image"] for r in ref] == sorted(r["image"] for r in ref)
    errors = [r for r in got if "error" in r]
    assert len(errors) == 1 and errors[0]["image"].endswith("k_corrupt.jpg")
    assert errors[0] == {"image": errors[0]["image"], "error": "undecodable image"}
    assert_same_records(got, ref)
    if "--return_all" in extra:
        for r in got:
            if "candidates" in r:
                assert len(r["candidates"]) == 3
                scores = [c["score"] for c in r["candidates"]]
                assert scores == sorted(scores, reverse=True)


@pytest.mark.parametrize("method,temps", [("multinomial", ["1.0"]),
                                          ("topk", ["1.0", "0.8"])])
def test_sampling_under_shared_noise(served, tmp_path, monkeypatch, method, temps):
    """One fixed array stands in for every Gumbel draw of both packages."""
    g = np.random.default_rng(5).gumbel(size=(4, 3, 40)).astype(np.float32)
    monkeypatch.setattr(jax.random, "gumbel",
                        lambda key, shape=(), *a, **kw: jnp.asarray(g.reshape(shape)))
    monkeypatch.setattr(TB, "gumbel_noise",
                        lambda shape, gen, dev: torch.from_numpy(g).reshape(shape))
    ref, got = run_both(served, tmp_path, ["--sample_method", method,
                                           "--sample_topk", "2", "--temperature",
                                           *temps], monkeypatch)
    assert_same_records(got, ref)


def test_precision_16_casts_and_matches_caption(served, tmp_path, monkeypatch):
    """Every float leaf of the served model is bf16, and the records are the
    port's own SATModel.caption on that model and the bf16 images."""
    ck, imgdir = served
    pil_only(monkeypatch)
    seen = {}
    real = checkpoints.load_any_checkpoint

    def load(path, device=None):
        seen["model"] = real(path, device=device)
        return seen["model"]
    monkeypatch.setattr(checkpoints, "load_any_checkpoint", load)
    out = str(tmp_path / "bf16.jsonl")
    argv = ["--checkpoint", ck, "--images", imgdir, "--batch", "4", "--beamk",
            "3", "--max_gen_length", "6", "--output", out]
    assert serve.main(argv, device="cpu") == 0      # --precision 16: the default
    model = seen["model"]
    tensors = list(model.parameters()) + list(model.buffers())
    floats = [t for t in tensors if t.is_floating_point()]
    assert floats and all(t.dtype == torch.bfloat16 for t in floats)
    got = _records(out)
    paths = serve.gather_images([imgdir])
    imgs, ok = serve.decode_images(paths, model.cfg.input_size)
    assert ok.sum() == 10
    for lo in range(0, len(paths), 4):
        chunk = imgs[lo:lo + 4]
        x = torch.from_numpy(np.concatenate(
            [chunk, np.repeat(chunk[-1:], 4 - len(chunk), 0)])).to(torch.bfloat16)
        caps, scores, _, ppl = model.caption(
            x / torch.tensor(255.0, dtype=torch.bfloat16), beamk=3,
            max_gen_length=6, rescore_method="LN",
            generator=torch.Generator().manual_seed(0), early_exit=True)
        for i, rec in enumerate(got[lo:lo + 4]):
            if not ok[lo + i]:
                assert rec["error"] == "undecodable image"
                continue
            assert rec["caption"] == " ".join(model.vocab.itos(t) for t in caps[i])
            assert rec["score"] == scores[i] and rec["perplexity"] == ppl[i]


def test_gather_images_matches_jax(served, tmp_path, capsys):
    _, imgdir = served
    cases = [[imgdir], [os.path.join(imgdir, "*.jpg")],
             [os.path.join(imgdir, "i0.png"), imgdir]]
    for specs in cases:
        assert serve.gather_images(specs) == jax_serve.gather_images(specs)
    assert len(serve.gather_images([imgdir])) == 11
    # a file literally named 'img[1].png' is returned as it is; a glob that
    # matches nothing warns on stderr
    lit = str(tmp_path / "img[1].png")
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(str(tmp_path / "tmp.png"))
    os.rename(str(tmp_path / "tmp.png"), lit)
    empty = str(tmp_path / "nope*.jpg")
    for fn in (serve.gather_images, jax_serve.gather_images):
        assert fn([lit]) == [lit]
        assert fn([empty]) == []
        assert "matched nothing" in capsys.readouterr().err


def test_one_device_only_and_no_card(served, tmp_path):
    ck, imgdir = served
    argv = ["--checkpoint", ck, "--images", imgdir, "--output",
            str(tmp_path / "x.jsonl")]
    for bad in (["--mesh_shape", "4", "2", "--mesh_axes", "data", "model"],
                ["--mesh_shape", "2"], ["--mesh_shape", "1", "2", "--mesh_axes",
                                        "data", "model"]):
        with pytest.raises(ValueError, match="torchrun --nproc_per_node"):
            serve.main(argv + bad, device="cpu")
    assert serve.main(["--checkpoint", ck, "--images",
                       str(tmp_path / "none*.png")], device="cpu") == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve.main(argv)


def test_image_helpers_match_jax(served, tmp_path):
    """sat_tpu_torch.utils.images against sat_tpu.utils.images."""
    from sat_tpu.utils import images as JI
    from sat_tpu_torch.utils import images as TI
    _, imgdir = served
    path = os.path.join(imgdir, "j0.jpg")
    for size in (None, 48, 64):
        a, b = TI.load_square(path, size), JI.load_square(path, size)
        assert a.size == b.size and np.array_equal(np.asarray(a), np.asarray(b))
        got = TI.prepare_image(TI.pil_loader(path), size)
        want = JI.prepare_image(JI.pil_loader(path), size)
        assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)
    img = TI.pil_loader(path)
    assert np.array_equal(np.asarray(TI.crop_center(img, 30, 20)),
                          np.asarray(JI.crop_center(img, 30, 20)))
    for t in (5.0, 61.0, 3601.0, 7300.5):
        assert TI.time_to_string(t) == JI.time_to_string(t)
    js = tmp_path / "x.json"
    js.write_text('{"a": [1, 2]}')
    assert TI.json_loader(str(js)) == JI.json_loader(str(js)) == {"a": [1, 2]}
