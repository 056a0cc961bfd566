"""Offline COCO preprocessing and the synthetic dataset makers of
``sat_tpu/data/preprocess.py``.

``preprocess_karpathy`` (the CLI, ``python -m sat_tpu_torch.data.preprocess
--karpathy_json K --coco_image_folder DIR --output OUT.json [...]``) turns a
Karpathy split JSON into one self-contained dataset JSON

    {vocab_stoi, vocab_size, embed_dim, pretrained_embedding, min_count,
     max_cap_length, train/val/test: {samples, img_paths, encoded_captions,
     lengths}}

plus, with ``--glove_file`` and ``--pretrained_dim``, a GloVe ``.npy``
embedding matrix beside it.  ``make_synthetic_dataset`` and
``make_learnable_dataset`` write PNG images (``data/images.write_png``) and
the same schema.  Every random draw is JAX's, in JAX's order, so the same
arguments give the same JSON bytes, matrix and pixels.  Host only."""

from __future__ import annotations

import argparse
import json
import os
import random
from collections import Counter
from typing import Dict, List, Optional

import numpy as np

from ..vocab import Vocab
from .images import write_png

# Common misspelling fixes (reference: preprocess.ipynb cell 9 `sp = lambda`)
_SPELL_FIX = (("tolet", "toilet"), ("skiis", "skis"),
              ("porduce", "produce"), ("raquet", "racket"))


def clean_token(t: str) -> str:
    t = t.lower()
    for a, b in _SPELL_FIX:
        t = t.replace(a, b)
    return t


def preprocess_karpathy(
    karpathy_json: str,
    coco_image_folder: str,
    output_path: str,
    ref_sentences: int = 5,
    min_count: int = 5,
    max_vocab: Optional[int] = 3072,
    max_cap_length: int = 26,
    dev_train_keep: Optional[int] = None,
    dev_val_keep: Optional[int] = None,
    glove_file: Optional[str] = None,
    pretrained_dim: Optional[int] = None,
    extend_dim: bool = True,
    seed: int = 42,
) -> Dict:
    """Build the dataset JSON (reference: preprocess.ipynb cells 8-17)."""
    rng = random.Random(seed)
    with open(karpathy_json) as f:
        full_data = json.load(f)

    word_freq: Counter = Counter()
    length_count: Counter = Counter()
    splits = {k: {"img": [], "cap": [], "len": []} for k in ("train", "test", "val")}

    for img_data in full_data["images"]:
        img_caps: List[List[str]] = []
        cap_lens: List[int] = []
        sub_folder = "train2014" if "train" in img_data["filename"] else "val2014"
        abs_img_path = os.path.join(coco_image_folder, sub_folder, img_data["filename"])

        for sent in img_data["sentences"]:
            # This shows up a bunch in COCO so the reference removes it (cell 9)
            if "i am unable to see" in sent["raw"].lower():
                continue
            tokens = [clean_token(t) for t in sent["tokens"]]
            if len(tokens) > max_cap_length:
                tokens = tokens[:max_cap_length]
            img_caps.append(tokens)
            cap_lens.append(len(tokens) + 1)  # +1 for <START>
            length_count.update([len(tokens)])
            word_freq.update(tokens)

        if not img_caps:
            continue
        # Pad/duplicate to exactly ref_sentences refs per image so val batches stack
        while ref_sentences > len(img_caps):
            idx = rng.randint(0, len(img_caps) - 1)
            img_caps.append(img_caps[idx])
            cap_lens.append(cap_lens[idx])
        img_caps, cap_lens = img_caps[:ref_sentences], cap_lens[:ref_sentences]

        split = img_data["split"]
        dst = ("train" if split in ("train", "restval")
               else split if split in ("test", "val") else None)
        if dst is None:
            continue
        keep = dev_train_keep if dst == "train" else dev_val_keep
        if keep is not None and len(splits[dst]["img"]) >= keep:
            continue
        splits[dst]["img"].append(abs_img_path)
        splits[dst]["cap"].append(img_caps)
        splits[dst]["len"].append(cap_lens)

    # Shrink max_cap_length if no caption hits the cap (cell 10)
    max_cap_length = min(max_cap_length, max(length_count.keys()))

    vocab = Vocab.build(word_freq, min_count=min_count, max_vocab=max_vocab)

    embed_dim, pretrained_embedding = None, None
    if glove_file is not None and pretrained_dim is not None:
        mat, embed_dim = build_glove_matrix(vocab, glove_file, pretrained_dim, extend_dim)
        pretrained_embedding = os.path.splitext(output_path)[0] + ".npy"
        np.save(pretrained_embedding, mat)

    output: Dict = {
        "vocab_stoi": vocab.stoi_map,
        "vocab_size": vocab.size,
        "embed_dim": embed_dim,
        "pretrained_embedding": pretrained_embedding,
        "min_count": min_count,
        "max_cap_length": max_cap_length,
    }
    for name in ("train", "test", "val"):
        s = splits[name]
        encoded = [[vocab.encode(cap, max_cap_length) for cap in caps] for caps in s["cap"]]
        output[name] = {
            "samples": len(s["img"]),
            "img_paths": s["img"],
            "encoded_captions": encoded,
            "lengths": s["len"],
        }
    if output_path:
        with open(output_path, "w") as f:
            json.dump(output, f)
    return output


def build_glove_matrix(vocab: Vocab, glove_file: str, pretrained_dim: int,
                       extend_dim: bool = True, seed: int = 0):
    """GloVe matrix with zero <PAD> row, N(0,0.4) OOV rows, and optional zero-pad
    to a multiple of 8 separating pretrained from random subspaces
    (reference: preprocess.ipynb cell 16)."""
    rng = np.random.default_rng(seed)
    table = {}
    with open(glove_file, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip().split(" ")
            table[parts[0]] = np.asarray(parts[1:], dtype=np.float64)
    pad_dim = 0
    if extend_dim:
        new_dim = int(-(-(1 + pretrained_dim) // 8) * 8)
        pad_dim = new_dim - pretrained_dim
    mat = np.zeros((vocab.size, pretrained_dim + pad_dim))
    for idx, word in vocab.itos_map.items():
        if idx == 0:
            continue  # pad row stays zero
        if word in table:
            mat[idx, :pretrained_dim] = table[word]
        else:
            mat[idx] = rng.normal(scale=0.4, size=(pretrained_dim + pad_dim,))
    return mat, pretrained_dim + pad_dim

_SYNTH_WORDS = (
    "a the man woman dog cat rides sits on in near table chair park street "
    "red blue green small large bike horse boat plate food holding standing "
    "group of people playing with ball grass field water sky tree building"
).split()


def make_synthetic_dataset(
    out_dir: str,
    n_train: int = 64,
    n_val: int = 16,
    n_test: int = 16,
    image_size: int = 64,
    ref_sentences: int = 5,
    max_cap_length: int = 16,
    seed: int = 0,
    json_name: str = "synthetic",
) -> str:
    """Writes PNG images + the dataset JSON. Returns the JSON path."""
    rng = random.Random(seed)
    nprng = np.random.default_rng(seed)
    os.makedirs(os.path.join(out_dir, "imgs"), exist_ok=True)

    word_freq = Counter({w: 100 for w in _SYNTH_WORDS})
    vocab = Vocab.build(word_freq, min_count=5, max_vocab=None)

    def make_split(n: int, tag: str):
        img_paths, caps, lens = [], [], []
        for i in range(n):
            arr = nprng.integers(0, 256, size=(image_size, image_size, 3), dtype=np.uint8)
            path = os.path.join(out_dir, "imgs", f"{tag}_{i}.png")
            write_png(path, arr)
            img_paths.append(path)
            ic, il = [], []
            for _ in range(ref_sentences):
                n_words = rng.randint(4, max_cap_length)
                toks = [rng.choice(_SYNTH_WORDS) for _ in range(n_words)]
                ic.append(vocab.encode(toks, max_cap_length))
                il.append(n_words + 1)
            caps.append(ic)
            lens.append(il)
        return {"samples": n, "img_paths": img_paths,
                "encoded_captions": caps, "lengths": lens}

    output = {
        "vocab_stoi": vocab.stoi_map,
        "vocab_size": vocab.size,
        "embed_dim": None,
        "pretrained_embedding": None,
        "min_count": 5,
        "max_cap_length": max_cap_length,
        "train": make_split(n_train, "train"),
        "val": make_split(n_val, "val"),
        "test": make_split(n_test, "test"),
    }
    path = os.path.join(out_dir, f"{json_name}.json")
    with open(path, "w") as f:
        json.dump(output, f)
    return path


_COLORS = {
    "red": (220, 40, 40), "green": (40, 200, 60), "blue": (50, 70, 220),
    "yellow": (230, 220, 50), "purple": (160, 60, 200), "cyan": (60, 210, 210),
    "orange": (240, 140, 30), "white": (235, 235, 235),
}


def make_learnable_dataset(out_dir: str, n_train: int = 96, n_val: int = 32,
                           n_test: int = 32, image_size: int = 32,
                           seed: int = 0, json_name: str = "colors") -> str:
    """A synthetic captioning task the model can actually SOLVE: each image is
    two colored halves, captioned '<left> on the left and <right> on the
    right'.  Used by the learning test to demonstrate the full train->decode->
    BLEU loop converges (the tiny-dataset analogue of the reference's smoke
    runs)."""
    rng = random.Random(seed)
    nprng = np.random.default_rng(seed)
    os.makedirs(os.path.join(out_dir, "imgs"), exist_ok=True)
    names = list(_COLORS)
    words = names + "on the left and right".split()
    vocab = Vocab.build(Counter({w: 100 for w in words}), min_count=5,
                        max_vocab=None)
    max_cap_length = 9

    def make_split(n: int, tag: str):
        img_paths, caps, lens = [], [], []
        for i in range(n):
            lc, rc = rng.choice(names), rng.choice(names)
            arr = np.zeros((image_size, image_size, 3), np.uint8)
            arr[:, : image_size // 2] = _COLORS[lc]
            arr[:, image_size // 2:] = _COLORS[rc]
            arr = np.clip(arr.astype(np.int16)
                          + nprng.integers(-8, 9, arr.shape), 0, 255
                          ).astype(np.uint8)
            path = os.path.join(out_dir, "imgs", f"{tag}_{i}.png")
            write_png(path, arr)
            img_paths.append(path)
            toks = f"{lc} on the left and {rc} on the right".split()
            enc = vocab.encode(toks, max_cap_length)
            caps.append([enc] * 5)
            lens.append([len(toks) + 1] * 5)
        return {"samples": n, "img_paths": img_paths,
                "encoded_captions": caps, "lengths": lens}

    output = {
        "vocab_stoi": vocab.stoi_map, "vocab_size": vocab.size,
        "embed_dim": None, "pretrained_embedding": None, "min_count": 5,
        "max_cap_length": max_cap_length,
        "train": make_split(n_train, "train"),
        "val": make_split(n_val, "val"),
        "test": make_split(n_test, "test"),
    }
    path = os.path.join(out_dir, f"{json_name}.json")
    with open(path, "w") as f:
        json.dump(output, f)
    return path


def main(argv=None):
    p = argparse.ArgumentParser(description="COCO caption preprocessing (SAT-TPU)")
    p.add_argument("--karpathy_json", required=True)
    p.add_argument("--coco_image_folder", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--ref_sentences", default=5, type=int)
    p.add_argument("--min_count", default=5, type=int)
    p.add_argument("--max_vocab", default=3072, type=int)
    p.add_argument("--max_cap_length", default=26, type=int)
    p.add_argument("--dev_train_keep", default=None, type=int)
    p.add_argument("--dev_val_keep", default=None, type=int)
    p.add_argument("--glove_file", default=None, type=str)
    p.add_argument("--pretrained_dim", default=None, type=int)
    p.add_argument("--no_extend_dim", action="store_true")
    p.add_argument("--seed", default=42, type=int)
    p.add_argument("--inspect", default=0, type=int, metavar="N",
                   help="after writing, decode N samples back to words and "
                        "print vocab stats (preprocess.ipynb cell 18's "
                        "visual sanity check)")
    p.add_argument("--inspect_images", default=None, metavar="DIR",
                   help="with --inspect: also save an image montage of the "
                        "inspected samples to DIR/inspect.jpg (cell 18's "
                        "visual half)")
    a = p.parse_args(argv)
    data = preprocess_karpathy(
        a.karpathy_json, a.coco_image_folder, a.output,
        ref_sentences=a.ref_sentences, min_count=a.min_count, max_vocab=a.max_vocab,
        max_cap_length=a.max_cap_length, dev_train_keep=a.dev_train_keep,
        dev_val_keep=a.dev_val_keep, glove_file=a.glove_file,
        pretrained_dim=a.pretrained_dim, extend_dim=not a.no_extend_dim, seed=a.seed)
    if a.inspect:
        inspect_dataset(data, a.inspect, image_dir=a.inspect_images)


def inspect_dataset(data, n: int = 3, image_dir: Optional[str] = None) -> None:
    """Decode n samples back to words + vocab stats (preprocess.ipynb cell 18).
    `data`: the dataset dict, or a path to its JSON.  With `image_dir`, also
    writes DIR/inspect.jpg — a caption-annotated montage of the n samples
    (cell 18 displays each image above its decoded captions)."""
    if isinstance(data, str):
        with open(data) as f:
            data = json.load(f)
    vocab = Vocab(data["vocab_stoi"])
    print(f"vocab_size={data['vocab_size']} max_cap_length={data['max_cap_length']}"
          f" embed_dim={data.get('embed_dim')}")
    for split in ("train", "val", "test"):
        s = data[split]
        refs = len(s["encoded_captions"][0]) if s["samples"] else 0
        print(f"{split}: {s['samples']} images x {refs} refs")
    tr = data["train"]
    n = min(n, tr["samples"])
    for i in range(n):
        print(f"[{i}] {os.path.basename(tr['img_paths'][i])}")
        for c, l in zip(tr["encoded_captions"][i], tr["lengths"][i]):
            print(f"    ({l}) {' '.join(vocab.decode(c[1:l]))}")
    if image_dir and n:
        _write_inspect_montage(data, n, image_dir)


def _write_inspect_montage(data, n: int, image_dir: str,
                           tile: int = 256) -> str:
    """n (image, first-caption) tiles stacked vertically -> inspect.jpg
    (needs PIL)."""
    from PIL import Image, ImageDraw
    vocab = Vocab(data["vocab_stoi"])
    tr = data["train"]
    band = 24
    canvas = Image.new("RGB", (tile, n * (tile + band)), (255, 255, 255))
    draw = ImageDraw.Draw(canvas)
    for i in range(n):
        y = i * (tile + band)
        try:
            img = Image.open(tr["img_paths"][i]).convert("RGB")
            img = img.resize((tile, tile), Image.BILINEAR)
            canvas.paste(img, (0, y))
        except Exception as e:  # missing image file: annotate, keep going
            draw.text((4, y + tile // 2), f"<unreadable: {e}>", fill=(255, 0, 0))
        cap = " ".join(vocab.decode(
            tr["encoded_captions"][i][0][1:tr["lengths"][i][0]]))
        draw.text((4, y + tile + 4), cap[:60], fill=(0, 0, 0))
    os.makedirs(image_dir, exist_ok=True)
    path = os.path.join(image_dir, "inspect.jpg")
    canvas.save(path, quality=90)
    print(f"montage -> {path}")
    return path


if __name__ == "__main__":
    main()
