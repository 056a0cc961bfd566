"""The port's C++ decode pool (sat_tpu_torch.native) and the routes that take
it, against the JAX package's (sat_tpu.native) on the CPU, bit for bit.

* The pools: seeded JPEGs (small, large enough for libjpeg's IDCT scaling,
  grayscale, one of extreme aspect that takes decode_resized's
  grow-and-retry), PNGs, and files that are not images or are missing;
  decode_batch with the centre sentinel and with random offsets,
  decode_resized, and corpus_stats, which also equals the Python
  _corpus_stats.
* CaptionLoader at the default route of both packages: train with random
  crops and val, with and without cache_images, after a mid-epoch skip; a
  BMP the pools reject falls back to PIL per image, taking square_crop's
  integer draws after the batch's float draws, in both.
* serve: the port's JSONL on JPEGs equals sat_tpu.serve's with both pools
  at their defaults (tests/test_torch_serve.py holds the PIL route).

Skipped only where either pool does not build (g++, jpeglib.h, png.h), as
tests/test_native_decode.py is."""

import json
import os

import numpy as np
import pytest
from PIL import Image

import sat_tpu.native as jax_native
from sat_tpu import serve as jax_serve
from sat_tpu.data import dataset as jax_data
from sat_tpu.evalx import metrics as jax_metrics
from sat_tpu_torch import native, serve
from sat_tpu_torch.data import dataset
from sat_tpu_torch.data.images import decode_resized, square_crop
from sat_tpu_torch.evalx import metrics
from test_torch_metrics import corpus, refs_of
from test_torch_serve import BASE, assert_same_records, write_tiny_checkpoint
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

pytestmark = pytest.mark.skipif(not (native.available() and jax_native.available()),
                                reason="a C++ decode pool does not build here")


def scene(rng, h, w, gray=False):
    """Gradients with a block of noise: smooth parts and JPEG edges."""
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x * 255 // w, y * 255 // h, (x + y) * 255 // (w + h)], -1)
    img[h // 4:h // 2, w // 4:w // 2] = rng.integers(0, 256, (h // 2 - h // 4,
                                                              w // 2 - w // 4, 3))
    img = img.astype(np.uint8)
    return Image.fromarray(img).convert("L") if gray else Image.fromarray(img)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    out = tmp_path_factory.mktemp("native")
    rng = np.random.default_rng(0)
    made = {}
    for name, (h, w, kw) in {"small.jpg": (48, 60, {}), "large.jpg": (480, 640, {}),
                             "tall.jpg": (333, 250, {}), "gray.jpg": (90, 70, {"gray": True}),
                             "wide.jpg": (20, 400, {}), "rgb.png": (50, 41, {}),
                             "gray.png": (37, 52, {"gray": True})}.items():
        path = str(out / name)
        img = scene(rng, h, w, **kw)
        img.save(path, **({"quality": 90} if name.endswith(".jpg") else {}))
        made[name] = path
    made["corrupt.jpg"] = str(out / "corrupt.jpg")
    with open(made["corrupt.jpg"], "w") as f:
        f.write("not an image at all")
    made["missing.jpg"] = str(out / "missing.jpg")
    return made


@pytest.fixture(scope="module")
def pools():
    return native.DecodePool(3), jax_native.DecodePool(3)


def test_builds_into_the_port_build_dir():
    path = native.lib_path()
    assert path.parent.name == "build" and path.parent.parent.name == "sat_tpu_torch"
    assert path.exists() and native.shared_pool() is native.shared_pool()
    assert native.shared_pool().n_threads == min(16, os.cpu_count() or 1)
    assert native.route() == "C++ pool"


@pytest.mark.parametrize("size", [16, 32, 64])
@pytest.mark.parametrize("crop", ["centre", "random"])
@pytest.mark.parametrize("fast_dct", [True, False])
def test_decode_batch_matches_jax(files, pools, size, crop, fast_dct):
    paths = list(files.values())
    offs = (np.random.default_rng(size).random((len(paths), 2)).astype(np.float32)
            if crop == "random" else np.full((len(paths), 2), -1.0, np.float32))
    got, ok = pools[0].decode_batch(paths, size, offs, fast_dct=fast_dct)
    want, want_ok = pools[1].decode_batch(paths, size, offs, fast_dct=fast_dct)
    assert ok.tolist() == want_ok.tolist() == [not p.endswith(("corrupt.jpg", "missing.jpg"))
                                               for p in paths]
    assert np.array_equal(got, want)


def test_decode_resized_matches_jax(files, pools):
    """The cache path, the extreme aspect through the grow-and-retry."""
    for name, path in files.items():
        got, want = pools[0].decode_resized(path, 32), pools[1].decode_resized(path, 32)
        if name.startswith(("corrupt", "missing")):
            assert got is None and want is None
            continue
        assert got.shape == want.shape and np.array_equal(got, want), name
    assert pools[0].decode_resized(files["wide.jpg"], 32).shape == (32, 640, 3)


def test_pool_pixels_are_not_pil_pixels(files, pools):
    """The parity above has teeth: libjpeg's decode is not PIL's."""
    got, _ = pools[0].decode_batch([files["large.jpg"]], 64, np.full((1, 2), -1.0, np.float32))
    pil = square_crop(decode_resized(files["large.jpg"], 64), 64)
    assert not np.array_equal(got[0], pil)


@pytest.mark.parametrize("seed", range(3))
def test_corpus_stats_match_jax_and_python(pools, seed):
    caps, enc, lens, emb = corpus(seed)
    hyps = np.zeros((len(caps), max(map(len, caps))), np.int32)
    for i, c in enumerate(caps):
        hyps[i, :len(c)] = c
    hyp_lens = np.array([len(c) for c in caps], np.int32)
    args = (hyps, hyp_lens, enc[:, :, 1:], lens - 1)
    got, want = pools[0].corpus_stats(*args), pools[1].corpus_stats(*args)
    assert got == want == metrics._corpus_stats(refs_of(enc, lens), caps, max_n=4)
    # score_captions takes the pool; its floats are JAX's
    assert metrics._native_corpus_stats(caps, enc, lens) == got
    assert metrics.score_captions(caps, enc, lens, embedding=emb) == \
        jax_metrics.score_captions(caps, enc, lens, embedding=emb)


# ---------------------------------------------------------------------------
# CaptionLoader on the pool's route
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def caption_json(tmp_path_factory):
    """JPEGs of several aspects (so the crops move), a PNG, and a BMP that
    the pools reject; captions of several lengths."""
    out = tmp_path_factory.mktemp("loader_native")
    rng = np.random.default_rng(1)
    stoi = {f"w{i}": i for i in range(1, 9)}
    stoi.update({"<UNK>": 9, "<START>": 10, "<END>": 11, "<PAD>": 0})
    js = {"vocab_stoi": stoi, "vocab_size": 12, "embed_dim": None,
          "pretrained_embedding": None, "min_count": 1, "max_cap_length": 10}
    for split, n in (("train", 13), ("val", 7)):
        paths, caps, lens = [], [], []
        for i in range(n):
            h, w = [(40, 56), (56, 40), (36, 36), (44, 70), (120, 90)][i % 5]
            ext = {3: ".png", 5: ".bmp"}.get(i, ".jpg")
            p = str(out / f"{split}_{i}{ext}")
            scene(rng, h, w).save(p, **({"quality": 85} if ext == ".jpg" else {}))
            paths.append(p)
            ln = rng.integers(2, 11, 3)
            c = np.zeros((3, 12), np.int64)
            c[:, 0] = 10
            for r, k in enumerate(ln):
                c[r, 1:k] = rng.integers(1, 9, k - 1)
                c[r, k] = 11
            caps.append(c.tolist())
            lens.append(ln.tolist())
        js[split] = {"samples": n, "img_paths": paths, "encoded_captions": caps,
                     "lengths": lens}
    return js


LOADERS = {
    "shuffle": dict(shuffle=True),
    "bucket_workers2": dict(bucket=True, workers=2),
    "cache": dict(shuffle=True, cache_images=True),
    "keep_tail": dict(shuffle=True, drop_last=False),
}


def _pair(js, split, kw):
    common = dict(kw, seed=5, train=split == "train")
    if split == "val":
        common.setdefault("drop_last", False)     # two batches of 7
    ref = jax_data.CaptionLoader(jax_data.CaptionDataset(js, split), 4, 32, **common)
    got = dataset.CaptionLoader(dataset.CaptionDataset(js, split), 4, 32, **common)
    assert ref._native is not None and got._native is not None
    return ref, got


def _same(ref_batches, got_batches):
    ref_batches, got_batches = list(ref_batches), list(got_batches)
    assert len(ref_batches) == len(got_batches) > 0
    for r, g in zip(ref_batches, got_batches):
        assert r.keys() == g.keys()
        for k in r:
            assert r[k].dtype == g[k].dtype and r[k].shape == g[k].shape, k
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("case", list(LOADERS))
def test_loader_batches_match_jax(caption_json, case, split):
    """Two epochs through set_epoch, and a pass after a mid-epoch skip."""
    ref, got = _pair(caption_json, split, LOADERS[case])
    for epoch in (0, 1):
        ref.set_epoch(epoch)
        got.set_epoch(epoch)
        _same(ref, got)
    ref.set_epoch(2, skip_batches=1)
    got.set_epoch(2, skip_batches=1)
    _same(ref, got)


def test_loader_routes_differ(caption_json):
    """The pool's train crops are not the PIL route's."""
    ld = lambda nd: dataset.CaptionLoader(dataset.CaptionDataset(caption_json, "train"),
                                          4, 32, seed=5, native_decode=nd)
    a, b = next(iter(ld(None))), next(iter(ld(False)))
    assert not np.array_equal(a["images"], b["images"])
    assert np.array_equal(a["captions"], b["captions"])


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------

def test_serve_jsonl_matches_jax_with_both_pools(files, tmp_path, monkeypatch):
    """The fault's closing test: both packages at their default decode."""
    ck = str(tmp_path / "m.ckpt")
    write_tiny_checkpoint(ck)
    imgdir = tmp_path / "imgs"
    imgdir.mkdir()
    for name, path in files.items():
        if name != "missing.jpg":
            os.link(path, imgdir / name)
    argv = ["--checkpoint", ck, "--images", str(imgdir)] + BASE
    outs = {}
    for name, fn in (("jax", jax_serve.main),
                     ("port", lambda a: serve.main(a, device="cpu", timings=tm))):
        tm = {}
        outs[name] = str(tmp_path / f"{name}.jsonl")
        assert fn(argv + ["--output", outs[name]]) == 0
    assert tm["route"] == "C++ pool"
    recs = {k: [json.loads(line) for line in open(v)] for k, v in outs.items()}
    assert len(recs["jax"]) == 8
    assert [r["image"] for r in recs["port"] if "error" in r] == [str(imgdir / "corrupt.jpg")]
    assert_same_records(recs["port"], recs["jax"])
    # the PIL route (the port's pool switched off) gives other records on the JPEGs
    monkeypatch.setattr(native, "shared_pool", lambda: None)
    pil = str(tmp_path / "pil.jsonl")
    assert serve.main(argv + ["--output", pil], device="cpu", timings=tm) == 0
    assert tm["route"] != "C++ pool"
    assert [json.loads(line) for line in open(pil)] != recs["port"]
