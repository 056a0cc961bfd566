"""Decode-parameter random search, ported from ``sat_tpu/evalx/search.py``
(reference: evaluate.ipynb cells 3-10): N random trials over beamk,
temperature, sample method, decoder noise and rescore method and reward,
each scored on a few batches of a split, the rows appended to a CSV for
scatter and correlation analysis.

    python -m sat_tpu_torch.evalx.search --checkpoint last.ckpt \\
        --split test --trials 32 --csv evaluations.csv --plot

Without pandas or matplotlib (neither is on the card's machine), and so
with three stated departures from the JAX tool: ``run_search`` returns the
rows as a list of dicts, not a DataFrame; ``correlation_report`` returns
the numeric column names and a float64 matrix, and ``main`` prints it as a
plain table of its own; ``plot_search_results`` draws its panels into
arrays, without axis text, and writes them with ``data/images.py``'s PNG
writer.  The CSV is written as pandas' ``to_csv(index=False)`` writes it,
across calls too (``_write_csv``).  Each trial reports its decode route
(``SATModel.decode_route``) on stderr: noisy trials take the plain path.
Runs on the card unless ``main(argv, device="cpu")``."""

from __future__ import annotations

import argparse
import csv
import math
import os
import random
import re
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

_INT = re.compile(r"[+-]?\d+\Z")


def run_search(model, ds, n_trials: int = 32, batches_per_trial: int = 4,
               batch_size: int = 16, csv_path: str = "evaluations.csv",
               max_gen_length: int = 32, seed: int = 0,
               beamk_range=(5, 20), temp_range=(0.7, 1.2),
               methods=("beam", "multinomial", "topk"),
               noises=(None, 0.05, 0.1, 0.2),
               rescores=(None, "LN", "WR", "BAR"),
               rewards=(0.25, 0.5, 1.0, 2.0)) -> List[Dict]:
    """JAX's search on the model's device: trial settings drawn from
    ``random.Random(seed)`` in JAX's order, the first ``batches_per_trial``
    batches encoded once, each trial's captions (its draws from a generator
    seeded with the trial's index) scored batch by batch with the
    embedding and perplexities, the means in one row with
    ``seconds_per_batch``.  The CSV holds the rows already in it plus this
    call's, rewritten after every trial.  Returns this call's rows."""
    import torch
    from ..data.dataset import CaptionLoader
    from ..data.transforms import val_preprocess
    from ..decode.api import caption_from_annotations
    from .metrics import score_captions

    rng = random.Random(seed)
    if os.path.dirname(csv_path):
        os.makedirs(os.path.dirname(csv_path), exist_ok=True)
    loader = CaptionLoader(ds, batch_size, model.cfg.input_size, shuffle=False,
                           train=False, drop_last=True)
    dev = model.decoder.embedding.device
    batches = []
    for i, batch in enumerate(loader):
        if i >= batches_per_trial:
            break
        batches.append((model.encode(val_preprocess(
            torch.from_numpy(batch["images"]).to(dev))), batch))
    embedding = model.decoder.embedding.detach().float().cpu().numpy()
    # the rows already in the file, read once: each write below re-emits
    # them with this call's rows, so searches append across calls
    old = _read_csv(csv_path) if os.path.exists(csv_path) else None

    rows: List[Dict] = []
    for trial in range(n_trials):
        params = {
            "beamk": rng.choice(list(beamk_range)),
            "temperature": round(rng.uniform(*temp_range), 3),
            "sample_method": rng.choice(list(methods)),
            "sample_topk": rng.choice([3, 5]),
            "decoder_noise": rng.choice(list(noises)),
            "rescore_method": rng.choice(list(rescores)),
            "rescore_reward": rng.choice(list(rewards)),
        }
        print(f"trial {trial}: decode route: "
              f"{model.decode_route(params['decoder_noise'])}", file=sys.stderr)
        t0 = time.time()
        trial_metrics: List[Dict[str, float]] = []
        for annots, batch in batches:
            caps, _, _, ppl = caption_from_annotations(
                model.decoder, model.cfg, annots, model.grid_hw,
                max_gen_length=max_gen_length, return_all=False,
                generator=torch.Generator(dev).manual_seed(trial), **params)
            trial_metrics.append(score_captions(
                caps, batch["captions"], batch["lengths"],
                embedding=embedding, perplexities=ppl))
        means = {k: float(np.mean([m[k] for m in trial_metrics]))
                 for k in trial_metrics[0]}
        row = {**params, **means,
               "seconds_per_batch": (time.time() - t0) / len(batches)}
        rows.append(row)
        print(f"trial {trial}: bleu4={means['bleu4']:.4f} gleu={means['gleu']:.4f} "
              f"({row['seconds_per_batch']:.2f}s/batch) {params}")
        _write_csv(csv_path, old, rows)
    return rows


_TEN = [float(f"1e{k}") for k in range(309)]


def _parse_float(s: str) -> float:
    """A number as pandas' ``read_csv`` parses it by default (its C
    tokenizer's ``precise_xstrtod``): at most 17 significant digits, the
    integer part's leading zeros counted, the rest dropped, accumulated as
    a double and scaled by one power of ten.  That is not always the
    nearest double: ``0.08175098692698718`` reads as ``0.0817509869269871``,
    and a CSV rewritten by pandas writes the value read."""
    t = s.strip()
    if t.lstrip("+-").lower() in ("inf", "infinity"):
        return float(t)
    m = re.fullmatch(r"([+-]?)(\d*)(?:\.(\d*))?(?:[eE]([+-]?\d+))?", t)
    if m is None or not (m.group(2) or m.group(3)):
        raise ValueError(f"not a number: {s!r}")
    sign, whole, frac, exp = m.group(1), m.group(2), m.group(3) or "", m.group(4)
    number, digits, exponent = 0.0, 0, 0
    for ch in whole:
        if digits < 17:
            number = number * 10.0 + (ord(ch) - 48)
            digits += 1
        else:
            exponent += 1
    decimals = 0
    for ch in frac:
        if digits >= 17:
            break
        number = number * 10.0 + (ord(ch) - 48)
        digits += 1
        decimals += 1
    exponent -= decimals
    if sign == "-":
        number = -number
    if exp is not None:
        exponent += int(exp.lstrip("+-")[:17] or 0) * (-1 if exp.startswith("-") else 1)
    if exponent > 308:
        return math.copysign(math.inf, number)
    if exponent > 0:
        return number * _TEN[exponent]
    if exponent < -616:
        return 0.0 * number
    if exponent < -308:
        return number / _TEN[-308 - exponent] / _TEN[308]
    return number / _TEN[-exponent]


def _read_csv(path: str) -> Tuple[List[str], List[list]]:
    """(header, columns) of a CSV as this module writes it (a missing value
    is an empty field), each column's fields typed as pandas' ``read_csv``
    infers them: int where every field is an integer, float (missing: NaN;
    ``_parse_float``) where every present field is a number, else str
    (missing: None)."""
    with open(path, newline="") as f:
        header, *records = list(csv.reader(f))
    cols = []
    for j in range(len(header)):
        fields = [r[j] if j < len(r) else "" for r in records]
        present = [x for x in fields if x]
        if present and len(present) == len(fields) and all(_INT.match(x) for x in present):
            cols.append([int(x) for x in fields])
            continue
        try:
            cols.append([_parse_float(x) if x else math.nan for x in fields])
        except ValueError:
            cols.append([x or None for x in fields])
    return header, cols


def _missing(v) -> bool:
    return v is None or (isinstance(v, float) and math.isnan(v))


def _field(v, kind: str) -> str:
    if _missing(v):
        return ""
    if kind == "float":
        return repr(float(v))
    return repr(float(v)) if isinstance(v, float) else str(v)


def _column_kind(values) -> str:
    """The dtype pandas gives a column of the concatenated frame: int64
    (integers, none missing), float64 (numbers, missing as NaN) or object."""
    present = [v for v in values if not _missing(v)]
    if all(isinstance(v, int) and not isinstance(v, bool) for v in present) \
            and len(present) == len(values):
        return "int"
    if present and all(isinstance(v, (int, float)) and not isinstance(v, bool)
                       for v in present):
        return "float"
    return "object"


def _write_csv(path: str, old: Optional[Tuple[List[str], List[list]]],
               rows: List[Dict]) -> None:
    """The old rows and ``rows`` as ``pd.concat([old, DataFrame(rows)])
    .to_csv(index=False)`` writes them: the columns in order of first
    appearance, a missing value as an empty field, floats by ``repr``,
    integers of a float column as floats (``5.0``)."""
    header = list(dict.fromkeys((old[0] if old else []) + [k for r in rows for k in r]))
    n_old = len(old[1][0]) if old and old[1] else 0
    old_cols = dict(zip(*old)) if old else {}
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(header)
        cols = [old_cols.get(k, [None] * n_old) + [r.get(k) for r in rows]
                for k in header]
        kinds = [_column_kind(c) for c in cols]
        for i in range(n_old + len(rows)):
            w.writerow([_field(c[i], kind) for c, kind in zip(cols, kinds)])


def _numeric(csv_path: str) -> Tuple[List[str], np.ndarray]:
    """The numeric columns of the CSV as ``read_csv`` +
    ``select_dtypes("number")`` give them: names and a float64 (rows,
    columns) matrix, NaN where a field is missing."""
    header, cols = _read_csv(csv_path)
    keep = [(h, c) for h, c in zip(header, cols)
            if all(isinstance(v, (int, float)) for v in c)]
    return [h for h, _ in keep], np.array([c for _, c in keep], np.float64).T


def pearson(mat: np.ndarray) -> np.ndarray:
    """``DataFrame.corr(method="pearson")`` of a float64 (rows, columns)
    matrix: each pair over the rows where both are finite, by Welford's
    updates in pandas' order (``nancorr``), clipped to [-1, 1]; NaN where
    no row is complete or a column is constant there."""
    n, k = mat.shape
    ok = np.isfinite(mat)
    out = np.empty((k, k), np.float64)
    for xi in range(k):
        for yi in range(xi + 1):
            nobs = 0
            ssqdmx = ssqdmy = covxy = meanx = meany = 0.0
            for i in range(n):
                if ok[i, xi] and ok[i, yi]:
                    vx, vy = float(mat[i, xi]), float(mat[i, yi])
                    nobs += 1
                    dx, dy = vx - meanx, vy - meany
                    meanx += 1.0 / nobs * dx
                    meany += 1.0 / nobs * dy
                    ssqdmx += (vx - meanx) * dx
                    ssqdmy += (vy - meany) * dy
                    covxy += (vx - meanx) * dy
            divisor = math.sqrt(ssqdmx * ssqdmy)
            val = (min(max(covxy / divisor, -1.0), 1.0)
                   if nobs and divisor != 0 else math.nan)
            out[xi, yi] = out[yi, xi] = val
    return out


def correlation_report(csv_path: str) -> Tuple[List[str], np.ndarray]:
    """Pearson correlation of the decode settings and metrics
    (evaluate.ipynb cells 8-10): the numeric columns' names and their
    float64 correlation matrix, as pandas' ``read_csv(...).select_dtypes(
    "number").corr()`` computes it (an all-empty column is numeric and
    NaN)."""
    names, mat = _numeric(csv_path)
    return names, pearson(mat)


def format_report(names: Sequence[str], corr: np.ndarray) -> str:
    """The correlation matrix as a plain text table."""
    w = max(len(n) for n in names)
    lines = [" " * w + " " + " ".join(f"{n[:8]:>8}" for n in names)]
    for n, row in zip(names, corr):
        lines.append(f"{n:<{w}} " + " ".join(
            "     nan" if math.isnan(v) else f"{v:8.4f}" for v in row))
    return "\n".join(lines)


_DOT = np.array((31, 119, 180), np.float32)          # matplotlib's first colour
_COLD, _MID, _HOT = (np.array(c, np.float32) for c in
                     ((33, 102, 172), (247, 247, 247), (178, 24, 43)))


def _scatter_panel(x: np.ndarray, y: np.ndarray, w: int = 240,
                   h: int = 180, pad: int = 12) -> np.ndarray:
    """One panel: white, a black frame, each finite (x, y) a 5 x 5 dot at
    70 % opacity, both axes scaled to their finite range."""
    img = np.full((h, w, 3), 255.0, np.float32)
    img[pad - 1, pad - 1:w - pad + 1] = img[h - pad, pad - 1:w - pad + 1] = 0
    img[pad - 1:h - pad + 1, pad - 1] = img[pad - 1:h - pad + 1, w - pad] = 0
    ok = np.isfinite(x) & np.isfinite(y)

    def scale(v, n):
        lo, hi = v.min(), v.max()
        return np.full(v.shape, n // 2) if hi == lo else np.rint(
            (v - lo) / (hi - lo) * (n - 1)).astype(int)

    if ok.any():
        cx = pad + 2 + scale(x[ok], w - 2 * pad - 4)
        cy = h - pad - 3 - scale(y[ok], h - 2 * pad - 4)
        for px, py in zip(cx, cy):
            patch = img[py - 2:py + 3, px - 2:px + 3]
            patch[:] = 0.3 * patch + 0.7 * _DOT
    return img


def _heat_color(v: float) -> np.ndarray:
    """A diverging map like matplotlib's RdBu_r: -1 blue, 0 near-white,
    +1 red; NaN grey."""
    if math.isnan(v):
        return np.array((200, 200, 200), np.float32)
    v = min(max(v, -1.0), 1.0)
    return _MID + (v * (_HOT - _MID) if v >= 0 else -v * (_COLD - _MID))


def plot_search_results(csv_path: str, out_dir: str = ".") -> List[str]:
    """The scatter panels of each metric (rows) against each decode setting
    (columns), and the correlation heatmap, as JAX's tool lays them out
    (evaluate.ipynb cells 8-10), written as ``search_scatter.png`` and
    ``search_correlation.png`` in ``out_dir``.  The panels carry no axis
    text or tick labels, and the heatmap no numbers or colour bar: the port
    draws without matplotlib.  Returns the two paths."""
    from ..data.images import write_png

    names, mat = _numeric(csv_path)
    col = dict(zip(names, mat.T))
    metrics = [c for c in ("bleu4", "gleu", "cosine_similarity", "perplexity")
               if c in col]
    params = [c for c in ("beamk", "temperature", "rescore_reward",
                          "seconds_per_batch") if c in col]
    grid = np.concatenate([np.concatenate(
        [_scatter_panel(col[p], col[m]) for p in params], axis=1)
        for m in metrics], axis=0)
    os.makedirs(out_dir, exist_ok=True)
    sc = os.path.join(out_dir, "search_scatter.png")
    write_png(sc, np.rint(grid).astype(np.uint8))

    corr, cell = pearson(mat), 32
    heat = np.zeros((len(names) * cell, len(names) * cell, 3), np.float32)
    for i in range(len(names)):
        for j in range(len(names)):
            heat[i * cell:(i + 1) * cell, j * cell:(j + 1) * cell] = _heat_color(
                corr[i, j])
    hm = os.path.join(out_dir, "search_correlation.png")
    write_png(hm, np.rint(heat).astype(np.uint8))
    return [sc, hm]


def main(argv: Optional[Sequence[str]] = None,
         device: Union[str, None] = None) -> List[Dict]:
    from ..data.dataset import CaptionDataset
    from ..train.checkpoints import load_any_checkpoint

    p = argparse.ArgumentParser(description="decode-param random search")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--json", default=None)
    p.add_argument("--split", default="test")
    p.add_argument("--trials", default=32, type=int)
    p.add_argument("--batches", default=4, type=int)
    p.add_argument("--batch_size", default=16, type=int)
    p.add_argument("--csv", default="evaluations.csv")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--plot", action="store_true",
                   help="save scatter matrix + correlation heatmap pngs")
    a = p.parse_args(argv)
    model = load_any_checkpoint(a.checkpoint, device=device)
    ds = CaptionDataset(a.json or model.cfg.json, a.split)
    rows = run_search(model, ds, n_trials=a.trials,
                      batches_per_trial=a.batches, batch_size=a.batch_size,
                      csv_path=a.csv, seed=a.seed)
    print(format_report(*correlation_report(a.csv)))
    if a.plot:
        print("plots:", plot_search_results(a.csv, os.path.dirname(a.csv) or "."))
    return rows


if __name__ == "__main__":
    main()
