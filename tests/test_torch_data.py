"""The port's image decoding, dataset makers and loader
(sat_tpu_torch.data.images, .preprocess, .compositional, .dataset) against
PIL and sat_tpu.data on the CPU.

* PNG: every row filter and colour type read as PIL reads it; the port's
  write_png read back by PIL unchanged.
* Resize: the no-PIL resampler equals Pillow's BILINEAR exactly (the bar is
  1, as tests/test_native_decode.py allows the C++ one; the copy of Pillow's
  fixed-point arithmetic meets 0).
* Makers: the same JSON and the same pixels as JAX's makers.
* Loader: batches bit-identical to JAX's CaptionLoader (native_decode=False
  on both, so both decode with PIL here) for train and val over two epochs;
  tests/test_torch_native.py holds both loaders on the C++ pool's route."""

import builtins
import json
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from sat_tpu.data import compositional as jax_comp
from sat_tpu.data import dataset as jax_data
from sat_tpu.data import preprocess as jax_pre
from sat_tpu_torch.data import compositional, dataset, images, preprocess
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

# ---------------------------------------------------------------------------
# PNG reader and writer
# ---------------------------------------------------------------------------


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filter_row(f, cur, prev, bpp):
    out = bytearray(len(cur))
    for i, x in enumerate(cur):
        a = cur[i - bpp] if i >= bpp else 0
        b, c = prev[i], prev[i - bpp] if i >= bpp else 0
        pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[f]
        out[i] = (x - pred) & 0xFF
    return bytes([f]) + bytes(out)


def write_png_filtered(path, px, ctype, filt, palette=None, interlace=0):
    """A PNG of uint8 samples px (H, W, C) with row filter ``filt`` (0-4)
    on every row, or "mixed" (row y uses filter y % 5); ``interlace`` only
    sets the header's flag."""
    h, w, ch = px.shape
    rows, prev = [], bytes(w * ch)
    for y in range(h):
        cur = px[y].tobytes()
        f = y % 5 if filt == "mixed" else filt
        rows.append(_filter_row(f, cur, prev, ch))
        prev = cur

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))
    data = chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, interlace))
    if palette is not None:
        data += chunk(b"PLTE", palette.tobytes())
    data += chunk(b"IDAT", zlib.compress(b"".join(rows), 9)) + chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + data)


MODES = {"gray": (0, 1), "gray_alpha": (4, 2), "rgb": (2, 3), "rgba": (6, 4),
         "palette": (3, 1)}


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4, "mixed"])
@pytest.mark.parametrize("mode", list(MODES))
def test_png_reader_matches_pil(tmp_path, mode, filt):
    ctype, ch = MODES[mode]
    rng = np.random.default_rng([list(MODES).index(mode), len(str(filt))])
    h, w = 7, 11
    # smooth content (so the predictors matter) plus noise
    base = np.linspace(0, 200, h * w * ch).reshape(h, w, ch)
    px = (base + rng.integers(0, 56, (h, w, ch))).astype(np.uint8)
    palette = None
    if mode == "palette":
        palette = rng.integers(0, 256, (40, 3), dtype=np.uint8)
        px = (px % 40).astype(np.uint8)
    path = str(tmp_path / "x.png")
    write_png_filtered(path, px, ctype, filt, palette)
    ref = np.asarray(Image.open(path).convert("RGB"))
    np.testing.assert_array_equal(images.read_png(path), ref)


@pytest.mark.parametrize("shape", [(9, 13), (9, 13, 3), (9, 13, 4)])
def test_write_png_reads_back_through_pil(tmp_path, shape):
    arr = np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)
    path = str(tmp_path / "w.png")
    images.write_png(path, arr)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), arr)
    np.testing.assert_array_equal(images.read_png(path),
                                  np.asarray(Image.open(path).convert("RGB")))


def test_unsupported_files_name_pil(tmp_path):
    """Without PIL: JPEG, 16-bit and interlaced PNG raise, naming PIL."""
    arr = np.zeros((8, 8, 3), np.uint8)
    jpg = str(tmp_path / "a.jpg")
    Image.fromarray(arr).save(jpg)
    Image.fromarray(np.zeros((8, 8), np.uint16)).save(str(tmp_path / "b16.png"))
    write_png_filtered(str(tmp_path / "il.png"), arr, 2, 0, interlace=1)
    for name in ("a.jpg", "b16.png", "il.png"):
        with pytest.raises(RuntimeError, match="PIL"):
            images.read_png(str(tmp_path / name))


# ---------------------------------------------------------------------------
# Resize
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("src,dst", [((37, 53), (17, 29)), ((37, 53), (96, 131)),
                                     ((64, 201), (64, 63)), ((333, 500), (224, 337)),
                                     ((20, 31), (41, 31)), ((25, 25), (7, 7))])
def test_resampler_matches_pil_bilinear(src, dst):
    rng = np.random.default_rng(sum(src + dst))
    a = rng.integers(0, 256, src + (3,), dtype=np.uint8)
    a = ((a.astype(np.int32) + np.roll(a, 1, 0)) // 2).astype(np.uint8)
    ref = np.asarray(Image.fromarray(a).resize(dst[::-1], Image.BILINEAR))
    got = images.resize_bilinear(a, dst)
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    np.testing.assert_array_equal(got, ref)


@pytest.fixture
def no_pil(monkeypatch):
    real = builtins.__import__

    def fake(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no PIL")
        return real(name, *a, **k)
    monkeypatch.setattr(builtins, "__import__", fake)


@pytest.mark.parametrize("hw,size", [((40, 56), 32), ((90, 30), 32), ((32, 32), 32),
                                     ((21, 35), 48)])
def test_decode_routes_agree(tmp_path, hw, size, no_pil):
    """decode_resized without PIL equals JAX's PIL route on PNG files
    (sat_tpu.data.dataset holds PIL from its import, before PIL went)."""
    arr = np.random.default_rng(3).integers(0, 256, hw + (3,), dtype=np.uint8)
    path = str(tmp_path / "img.png")
    images.write_png(path, arr)
    assert images.decode_route() == "zlib+numpy (PNG only)"
    got = images.decode_resized(path, size)
    assert got.shape[:2] == images.resized_shape(hw, size)
    np.testing.assert_array_equal(got, jax_data.decode_resized(path, size))


def test_pil_route_is_jax_route(tmp_path):
    arr = np.random.default_rng(4).integers(0, 256, (45, 61, 3), dtype=np.uint8)
    path = str(tmp_path / "img.png")
    Image.fromarray(arr).save(path)
    assert images.decode_route() == "PIL"
    np.testing.assert_array_equal(images.decode_resized(path, 32),
                                  jax_data.decode_resized(path, 32))


# ---------------------------------------------------------------------------
# Dataset makers
# ---------------------------------------------------------------------------


def _same_dataset(jax_json, port_json):
    """Equal JSON but for the image directory, and equal pixels."""
    with open(jax_json) as f:
        ref = json.load(f)
    with open(port_json) as f:
        got = json.load(f)
    for split in ("train", "val", "test"):
        rp, gp = ref[split].pop("img_paths"), got[split].pop("img_paths")
        assert [os.path.basename(p) for p in rp] == [os.path.basename(p) for p in gp]
        for a, b in zip(rp, gp):
            np.testing.assert_array_equal(np.asarray(Image.open(b)),
                                          np.asarray(Image.open(a)))
    assert got == ref


@pytest.mark.parametrize("maker", ["synthetic", "learnable", "compositional"])
def test_dataset_makers_match_jax(tmp_path, maker):
    kw = dict(n_train=6, n_val=3, n_test=2, seed=3)
    if maker == "synthetic":
        fns, kw = (jax_pre.make_synthetic_dataset, preprocess.make_synthetic_dataset), \
            dict(kw, image_size=24, max_cap_length=9)
    elif maker == "learnable":
        fns, kw = (jax_pre.make_learnable_dataset, preprocess.make_learnable_dataset), \
            dict(kw, image_size=20)
    else:
        fns, kw = (jax_comp.make_compositional_dataset,
                   compositional.make_compositional_dataset), \
            dict(kw, image_size=32, n_nouns=8)
    ref = fns[0](str(tmp_path / "jax"), **kw)
    got = fns[1](str(tmp_path / "port"), **kw)
    _same_dataset(ref, got)
    if maker == "compositional":
        assert (compositional.prior_baseline_bleu(got)
                == jax_comp.prior_baseline_bleu(ref))


def test_n64_vocabulary_matches_the_serving_checkpoint(tmp_path):
    """make_compositional_dataset(n_nouns=64) has the n64 checkpoint's
    vocabulary (no images written)."""
    from sat_tpu_torch.train.checkpoints import read_checkpoint_config
    path = compositional.make_compositional_dataset(
        str(tmp_path), n_train=0, n_val=0, n_test=0, n_nouns=64)
    with open(path) as f:
        stoi = json.load(f)["vocab_stoi"]
    ckpt = os.path.join(os.path.dirname(__file__), "data",
                        "best_n64_r4_serving.ckpt")
    assert stoi == read_checkpoint_config(ckpt).vocab_stoi


# ---------------------------------------------------------------------------
# Loader
# ---------------------------------------------------------------------------

N_TRAIN, N_VAL, T_FULL = 13, 7, 12


@pytest.fixture(scope="module")
def caption_json(tmp_path_factory):
    """A dataset of PNGs of several aspects (so the crops move) and
    captions of several lengths (so the buckets and trims differ)."""
    out = tmp_path_factory.mktemp("loader")
    rng = np.random.default_rng(0)
    stoi = {f"w{i}": i for i in range(1, 9)}
    stoi.update({"<UNK>": 9, "<START>": 10, "<END>": 11, "<PAD>": 0})
    js = {"vocab_stoi": stoi, "vocab_size": 12, "embed_dim": None,
          "pretrained_embedding": None, "min_count": 1,
          "max_cap_length": T_FULL - 2}
    for split, n in (("train", N_TRAIN), ("val", N_VAL)):
        paths, caps, lens = [], [], []
        for i in range(n):
            hw = [(40, 56), (56, 40), (36, 36), (44, 70)][i % 4]
            p = str(out / f"{split}_{i}.png")
            Image.fromarray(rng.integers(0, 256, hw + (3,), dtype=np.uint8)).save(p)
            paths.append(p)
            ln = rng.integers(2, T_FULL - 1, 3)
            c = np.zeros((3, T_FULL), np.int64)
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
    "bucket_trim": dict(bucket=True, shuffle=False),
    "shuffle": dict(shuffle=True),
    "shuffle_workers2": dict(shuffle=True, workers=2),
    "bucket_cache_workers2": dict(bucket=True, cache_images=True, workers=2),
    "keep_tail": dict(shuffle=True, drop_last=False),
}


def _loader_pair(js, split, kw):
    common = dict(kw, seed=5, train=split == "train")
    ref = jax_data.CaptionLoader(jax_data.CaptionDataset(js, split), 4, 32,
                                 native_decode=False, **common)
    got = dataset.CaptionLoader(dataset.CaptionDataset(js, split), 4, 32,
                                native_decode=False, **common)
    return ref, got


def _same_batches(ref_batches, got_batches):
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
    """Two epochs (the second through set_epoch), bit for bit."""
    ref, got = _loader_pair(caption_json, split, LOADERS[case])
    assert len(ref) == len(got)
    for epoch in (0, 1):
        ref.set_epoch(epoch)
        got.set_epoch(epoch)
        _same_batches(ref, got)


def test_loader_skip_batches_and_trims(caption_json):
    """set_epoch(e, skip_batches=1) drops the first batch before decoding
    and keeps the crops of the rest; trims are 4-buckets + 1."""
    ref, got = _loader_pair(caption_json, "train", dict(bucket=True))
    for ld in (ref, got):
        ld.set_epoch(1, skip_batches=1)
    g = list(got)
    _same_batches(ref, g)
    assert len(g) == len(got) - 1
    assert {b["captions"].shape[2] for b in g} <= {5, 9, T_FULL}
    full = dataset.CaptionLoader(dataset.CaptionDataset(caption_json, "train"), 4, 32,
                                 bucket=True, seed=5, native_decode=False)
    full.set_epoch(1)
    _same_batches(list(full)[1:], g)


def test_cache_decodes_each_image_once(caption_json):
    ds = dataset.CaptionDataset(caption_json, "val")
    ld = dataset.CaptionLoader(ds, 4, 32, shuffle=False, train=False,
                               drop_last=False, cache_images=True, workers=2)
    first, second = list(ld), list(ld)
    assert ld.decoded == len(ds)
    _same_batches(first, second)


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_dead_producer_raises(caption_json):
    js = json.loads(json.dumps(caption_json))
    js["train"]["img_paths"][5] = "/nonexistent/missing.png"
    ld = dataset.CaptionLoader(dataset.CaptionDataset(js, "train"), 4, 32,
                               shuffle=False, workers=2)
    with pytest.raises(RuntimeError, match="producer thread died"):
        list(ld)


def test_native_decode_is_not_ported(caption_json, monkeypatch):
    """The name predates the port of the C++ pool: native_decode=True now
    takes the pool where it builds, and raises, as JAX's loader does, only
    where it does not build."""
    from sat_tpu_torch import native
    ds = dataset.CaptionDataset(caption_json, "train")
    if native.available():
        ld = dataset.CaptionLoader(ds, 4, 32, native_decode=True)
        assert ld._native is native.shared_pool() and len(list(ld)) == len(ld)
    monkeypatch.setattr(native, "shared_pool", lambda: None)
    with pytest.raises(RuntimeError, match="does not build"):
        dataset.CaptionLoader(ds, 4, 32, native_decode=True)
    assert dataset.CaptionLoader(ds, 4, 32)._native is None
