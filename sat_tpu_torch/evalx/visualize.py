"""Attention-map visualizer, ported from ``sat_tpu/evalx/visualize.py``
(reference: visualize.ipynb cell 1 ``make_visual``).

Loads one image from a dataset split (or any file, ``--image``), captions
it with ``return_all=True``, prints the references, the top predictions
with their scores and perplexities and a single-image BLEU, as JAX's tool
prints them, then renders each word's attention mask
``((a - min) / (max - min))^5`` at 256 px over the image and a
total-attention panel, saved as ``<out_dir>/<img_name>_result.jpg``.

    python -m sat_tpu_torch.evalx.visualize --checkpoint last.ckpt \\
        --split val --idx 3 --beamk 3

The figure is composed with PIL (text in ``ImageFont.load_default()``),
in JAX's column layout; its pixels cannot equal matplotlib's, a stated
departure.  The masks are JAX's, byte for byte (``attention_masks``).  The
decode route (``SATModel.decode_route``) is reported on stderr.  Runs on
the card unless ``main(argv, device="cpu")``."""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

VISUAL_SIZE = 256


def attention_masks(atts: np.ndarray, visual_size: int = VISUAL_SIZE
                    ) -> Tuple[List[np.ndarray], np.ndarray]:
    """JAX's masks of a caption's attention maps ``atts`` (len, h, w)
    float32: each word's ``((a - min) / max(max - min, 1e-8)) ** 5`` and
    the total's ``(s - min) / max(max - min, 1e-8)`` of the sum over words,
    as uint8, RGB, resized to ``visual_size`` by PIL.  Returns the word
    masks and the total's, (S, S, 3) uint8 each."""
    from PIL import Image

    def rgb(att):
        return np.asarray(Image.fromarray(np.uint8(att * 255)).convert("RGB")
                          .resize((visual_size, visual_size)))

    words = []
    for att in atts:
        words.append(rgb(((att - att.min()) / max(att.max() - att.min(), 1e-8)) ** 5.0))
    att = atts.sum(0)
    return words, rgb((att - att.min()) / max(att.max() - att.min(), 1e-8))


def _figure(title: str, panels: Sequence[Tuple[np.ndarray, str]],
            columns: int, rows: int):
    """The figure: the title's lines at the top left, then the panels in
    ``columns`` columns, each image above its word (JAX's x label)."""
    from PIL import Image, ImageDraw, ImageFont

    font = ImageFont.load_default()
    line_h, pad, label_h = 14, 12, 18
    lines = title.split("\n")
    cell_w, cell_h = VISUAL_SIZE + 2 * pad, VISUAL_SIZE + label_h + pad
    text_w = max((int(font.getlength(s)) for s in lines), default=0) + 2 * pad
    head = len(lines) * line_h + 2 * pad
    fig = Image.new("RGB", (max(columns * cell_w, text_w), head + rows * cell_h),
                    "white")
    draw = ImageDraw.Draw(fig)
    for i, s in enumerate(lines):
        draw.text((pad, pad + i * line_h), s, fill="black", font=font)
    for n, (arr, label) in enumerate(panels):
        x = (n % columns) * cell_w + pad
        y = head + (n // columns) * cell_h
        fig.paste(Image.fromarray(arr), (x, y))
        w = font.getlength(label)
        draw.text((x + (VISUAL_SIZE - w) / 2, y + VISUAL_SIZE + 3), label,
                  fill="black", font=font)
    return fig


def make_visual(model, valid_ds=None, idx: int = 0,
                image_path: Optional[str] = None, beamk: int = 3,
                max_gen_length: int = 32,
                temperature: Union[float, Sequence[float]] = 1.0,
                sample_method: str = "beam", sample_topk: int = 3,
                decoder_noise: Optional[float] = None,
                rescore_method: Optional[str] = "LN",
                rescore_reward: float = 1.0, show_topk: int = 1,
                out_dir: str = "data/visualize",
                input_size: Optional[int] = None) -> str:
    """JAX's ``make_visual`` on the model's device (the model carries its
    weights).  Returns the saved figure's path."""
    import torch
    from ..decode.api import caption_from_annotations
    from ..utils.images import load_square
    from .metrics import corpus_bleu

    columns = 4
    input_size = input_size or model.cfg.input_size
    vocab = model.vocab

    if image_path is not None:
        # any image: no references, no single-image BLEU
        img_path, references = image_path, None
    else:
        if valid_ds is None:
            raise ValueError("need a dataset split or --image")
        img_path = valid_ds.img_paths[idx]
        references = [list(map(int, c[1:l])) for c, l in
                      zip(valid_ds.encoded_captions[idx], valid_ds.lengths[idx])]
    img_name = os.path.splitext(os.path.basename(img_path))[0]

    title = f"{img_name}\n"
    if references is not None:
        for i, r in enumerate(references):
            s = f"Caption {i} : {' '.join(vocab.itos(t) for t in r)}"
            title += s + "\n"
            print(s)

    img_pil = load_square(img_path, size=VISUAL_SIZE)
    img_in = np.asarray(img_pil.resize((input_size, input_size)),
                        np.float32)[None] / 255.0
    print(f"decode route: {model.decode_route(decoder_noise)}", file=sys.stderr)

    t0 = time.time()
    annots = model.encode(torch.from_numpy(img_in))
    captions, scores, alphas, ppl = caption_from_annotations(
        model.decoder, model.cfg, annots, model.grid_hw, beamk=beamk,
        max_gen_length=max_gen_length, temperature=temperature,
        sample_method=sample_method, sample_topk=sample_topk,
        decoder_noise=decoder_noise, rescore_method=rescore_method,
        rescore_reward=rescore_reward, return_all=True)
    dur = time.time() - t0
    s = (f"Inference in {dur*1e3:.2f} ms for beamk={beamk} and "
         f"length={max(len(c) for c in captions[0])}")
    title += s + "\n"
    print(s)

    for i in range(min(beamk, show_topk)):
        s = (f"Prediction {i} (s={scores[0][i]:.2f}, p={ppl[0][i]:.2f}) : "
             f"{' '.join(vocab.decode(captions[0][i]))}")
        title += s + "\n"
        print(s)

    if references is not None:
        b1 = corpus_bleu([references], captions[0][:1], (1, 0, 0, 0))
        b4 = corpus_bleu([references], captions[0][:1], (0.25,) * 4)
        s = f"bleu1 = {b1:.4f}. bleu4 = {b4:.4f}"
        title += s
        print(s)

    words = vocab.decode(captions[0][0])
    cap_len = len(captions[0][0])
    num_figs = 2 + cap_len
    if cap_len < columns:
        columns = num_figs
    rows = 1 + num_figs // columns

    word_masks, total = attention_masks(np.asarray(alphas[0][0], np.float32))
    img = np.asarray(img_pil, np.float32)
    # a mask drawn at 75 % opacity over the image, as JAX's imshow(alpha=0.75)
    panels = [(np.asarray(img_pil), "<START>")] + [
        (np.rint(0.25 * img + 0.75 * m).astype(np.uint8), w)
        for m, w in zip(word_masks, words)]
    panels.append((total, "Total Attention"))
    fig = _figure(title, panels, columns, rows)
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, f"{img_name}_result.jpg")
    fig.save(out)
    return out


def main(argv: Optional[Sequence[str]] = None,
         device: Union[str, None] = None) -> str:
    from ..data.dataset import CaptionDataset
    from ..train.checkpoints import load_any_checkpoint

    p = argparse.ArgumentParser(description="attention visualization")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--json", default=None, help="dataset json (default: from ckpt)")
    p.add_argument("--split", default="val")
    p.add_argument("--idx", default=None, type=int)
    p.add_argument("--image", default=None,
                   help="caption an arbitrary image file instead of a "
                        "dataset index (no ground-truth panel)")
    p.add_argument("--beamk", default=3, type=int)
    p.add_argument("--max_gen_length", default=32, type=int)
    p.add_argument("--temperature", nargs="+", default=[1.0], type=float)
    p.add_argument("--sample_method", default="beam")
    p.add_argument("--sample_topk", default=3, type=int)
    p.add_argument("--decoder_noise", default=None, type=float)
    p.add_argument("--rescore_method", default="LN")
    p.add_argument("--rescore_reward", default=1.0, type=float)
    p.add_argument("--show_topk", default=5, type=int)
    p.add_argument("--out_dir", default="data/visualize")
    a = p.parse_args(argv)

    model = load_any_checkpoint(a.checkpoint, device=device)
    if a.image is not None:
        if a.idx is not None or a.json is not None:
            p.error("--image conflicts with --idx/--json (it captions an "
                    "arbitrary file, not a dataset sample)")
        ds, idx = None, 0
    else:
        ds = CaptionDataset(a.json or model.cfg.json, a.split)
        idx = a.idx if a.idx is not None else int(np.random.randint(len(ds)))
    path = make_visual(model, ds, idx, image_path=a.image, beamk=a.beamk,
                       max_gen_length=a.max_gen_length,
                       temperature=(a.temperature[0] if len(a.temperature) == 1
                                    else list(a.temperature)),
                       sample_method=a.sample_method, sample_topk=a.sample_topk,
                       decoder_noise=a.decoder_noise,
                       rescore_method=(None if a.rescore_method in ("None", "")
                                       else a.rescore_method),
                       rescore_reward=a.rescore_reward, show_topk=a.show_topk,
                       out_dir=a.out_dir)
    print("saved:", path)
    return path


if __name__ == "__main__":
    main()
