"""The decode-parameter search of sat_tpu_torch against sat_tpu's, on the
CPU at float32, with tests/test_tools.py's setup (a synthetic dataset at 32
px, narrow widths, one checkpoint read by both packages; ``tool_setup``): the trial
settings, beam trials' metrics, sampled and noisy trials under one shared
noise array patched into both packages, the CSV's text after two calls,
the correlation report against pandas' ``corr``, the plots and the CLI."""

import csv
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from sat_tpu.data.dataset import CaptionDataset as JaxDataset
from sat_tpu.evalx import search as JS
from sat_tpu.train.checkpoints import load_model_from_checkpoint as jax_load
from sat_tpu_torch.config import SATConfig
from sat_tpu_torch.data.dataset import CaptionDataset
from sat_tpu_torch.data.preprocess import make_synthetic_dataset
from sat_tpu_torch.decode import beam as TB
from sat_tpu_torch.evalx import search as TS
from sat_tpu_torch.models.jax_import import model_to_jax_tree
from sat_tpu_torch.models.model import SATModel
from sat_tpu_torch.train.checkpoints import load_any_checkpoint, save_checkpoint
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

# two calls: seed 7 draws a multinomial, a beam and a topk trial, all
# without noise (an all-empty decoder_noise column); seed 1 a beam trial
# and a noisy beam trial, appended to the same CSV
CALLS = ((7, 3), (1, 2))
SEARCH = dict(batches_per_trial=1, batch_size=4, max_gen_length=6,
              beamk_range=(2, 3))
NOT_COMPARED = ("seconds_per_batch",)


def tool_setup(out):
    """tests/test_tools.py's setup: the synthetic dataset at 32 px and
    narrow widths, one checkpoint for both packages; written by the port,
    with resnet18 at 64 px so that the attention grid is 2 x 2 (L = 1 at
    32 px leaves every mask constant) and JAX's encoder compiles in
    seconds.  Returns (dataset JSON, checkpoint)."""
    json_path = make_synthetic_dataset(str(out), n_train=8, n_val=6, n_test=6,
                                       image_size=32, max_cap_length=8)
    js = json.load(open(json_path))
    cfg = SATConfig(json=json_path, input_size=64, encoder_arch="resnet18",
                    encoder_dim=24, embed_dim=16, attention_dim=16,
                    decoder_dim=32, deep_output=True, vocab_stoi=js["vocab_stoi"],
                    vocab_size=js["vocab_size"], max_cap_length=js["max_cap_length"])
    model = SATModel.create(cfg, torch.Generator().manual_seed(0))
    ckpt = str(out / "model.ckpt")
    save_checkpoint(ckpt, model.cfg, dict(model_to_jax_tree(model), step=0, epoch=0))
    return json_path, ckpt


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    out = tmp_path_factory.mktemp("search")
    return (out, *tool_setup(out))


def _shared_noise(mp):
    """Every Gumbel and normal draw of both packages from one array per
    shape, made from a seed by numpy."""
    def arr(shape, kind):
        rng = np.random.default_rng([*shape, kind == "g"])
        return (rng.gumbel(size=shape) if kind == "g"
                else rng.normal(size=shape)).astype(np.float32)

    mp.setattr(jax.random, "gumbel",
               lambda key, shape=(), *a, **kw: jnp.asarray(arr(shape, "g")))
    mp.setattr(jax.random, "normal",
               lambda key, shape=(), *a, **kw: jnp.asarray(arr(shape, "n")))
    mp.setattr(TB, "gumbel_noise",
               lambda shape, gen, dev: torch.from_numpy(arr(tuple(shape), "g")))
    mp.setattr(TB, "normal_noise",
               lambda shape, gen, dev: torch.from_numpy(arr(tuple(shape), "n")))


@pytest.fixture(scope="module")
def searched(setup):
    """Both packages' searches, two calls each into one CSV per package,
    under the shared noise: (JAX's rows, the port's rows, JAX's CSV, the
    port's CSV)."""
    out, json_path, ckpt = setup
    jm, jv, _ = jax_load(ckpt)
    tm = load_any_checkpoint(ckpt, device="cpu")
    jcsv, tcsv = str(out / "jax" / "evals.csv"), str(out / "port" / "evals.csv")
    jrows, trows = [], []
    with pytest.MonkeyPatch.context() as mp:
        _shared_noise(mp)
        for seed, n in CALLS:
            jrows += JS.run_search(jm, jv, JaxDataset(json_path, "test"),
                                   n_trials=n, csv_path=jcsv, seed=seed,
                                   **SEARCH).to_dict("records")
            trows += TS.run_search(tm, CaptionDataset(json_path, "test"),
                                   n_trials=n, csv_path=tcsv, seed=seed, **SEARCH)
    return jrows, trows, jcsv, tcsv


SETTINGS = ("beamk", "temperature", "sample_method", "sample_topk",
            "decoder_noise", "rescore_method", "rescore_reward")


def _none(v):
    return None if v is None or (isinstance(v, float) and math.isnan(v)) else v


def test_trial_settings_match_jax(searched):
    jrows, trows, _, _ = searched
    assert len(jrows) == len(trows) == 5
    for j, t in zip(jrows, trows):
        assert list(t) == list(j)
        assert [_none(t[k]) for k in SETTINGS] == [_none(j[k]) for k in SETTINGS]
    kinds = {(t["sample_method"], t["decoder_noise"] is not None) for t in trows}
    assert {("beam", False), ("multinomial", False), ("topk", False),
            ("beam", True)} <= kinds


def _metrics(row):
    return {k: v for k, v in row.items() if k not in SETTINGS + NOT_COMPARED}


@pytest.mark.parametrize("kind", ["beam", "sampled", "noisy"])
def test_trial_metrics_match_jax(searched, kind):
    """Beam trials without noise as they are; sampled and noisy trials
    under the shared noise array: every metric within 1e-6, of its size
    where that is above 1 (a mean perplexity of ~400 is a float32 mean of
    float32 exponentials, whose ulp there is 3e-5)."""
    jrows, trows, _, _ = searched
    pick = {"beam": lambda r: r["sample_method"] == "beam" and r["decoder_noise"] is None,
            "sampled": lambda r: r["sample_method"] != "beam",
            "noisy": lambda r: r["decoder_noise"] is not None}[kind]
    pairs = [(j, t) for j, t in zip(jrows, trows) if pick(t)]
    assert pairs
    for j, t in pairs:
        got, ref = _metrics(t), _metrics(j)
        assert got.keys() == ref.keys() and "bleu4" in got and "perplexity" in got
        for k in got:
            assert abs(got[k] - ref[k]) <= 1e-6 * max(1.0, abs(ref[k])), (k, got[k], ref[k])


def _records(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_csv_text_matches_jax(searched, tmp_path):
    """Five rows after two calls.  The header and every setting field equal
    JAX's CSV as text, and each metric field holds the row's metric (within
    test_trial_metrics_match_jax's tolerance of JAX's).  JAX's own rows,
    written by the port's writer in the same two calls, give JAX's file
    byte for byte, timings included."""
    jrows, _, jcsv, tcsv = searched
    ref, got = _records(jcsv), _records(tcsv)
    assert got[0] == ref[0] and len(got) == len(ref) == 6
    for g, r in zip(got[1:], ref[1:]):
        for name, x, y in zip(ref[0], g, r):
            if name in SETTINGS:
                assert x == y, name
            elif name not in NOT_COMPARED:
                assert abs(float(x) - float(y)) <= 1e-6 * max(1.0, abs(float(y)))
    assert len(pd.read_csv(tcsv)) == 5
    path, done = str(tmp_path / "replay.csv"), 0
    for _, n in CALLS:
        old = TS._read_csv(path) if done else None
        for i in range(1, n + 1):
            TS._write_csv(path, old, jrows[done:done + i])
        done += n
    with open(path) as f, open(jcsv) as g:
        assert f.read() == g.read()


# rows and earlier files for the writer, each against pandas: a column of
# None and floats, an all-None column, a string column with None, integers,
# NaN and inf, an int column the old file holds with an empty field
WRITER_CASES = {
    "fresh": (None, [{"a": 5, "n": None, "r": None, "f": 0.1 + 0.2, "t": 1.0},
                     {"a": 20, "n": 0.05, "r": "LN", "f": 1e-5, "t": 0.913}]),
    "append_all_empty": ("a,n,r,f,t\n5,,,,inf\n",
                         [{"a": 3, "n": None, "r": "WR", "f": float("nan"), "t": 2.0}]),
    "append_float_to_empty": ("a,n,r,f,t\n5,,,1.5,2\n7,,,2.5,3\n",
                              [{"a": 3, "n": 0.2, "r": None, "f": 1.0, "t": 2.0}]),
    "old_int_with_gap": ("a,n\n5,\n,1.0\n", [{"a": 2, "n": 0.5}]),
}


@pytest.mark.parametrize("case", list(WRITER_CASES))
def test_csv_writer_matches_pandas(tmp_path, case):
    old_text, rows = WRITER_CASES[case]
    path = str(tmp_path / "x.csv")
    df = pd.DataFrame(rows)
    if old_text is not None:
        with open(path, "w") as f:
            f.write(old_text)
        df = pd.concat([pd.read_csv(path), df], ignore_index=True)
    ref = df.to_csv(index=False)
    TS._write_csv(path, TS._read_csv(path) if old_text is not None else None, rows)
    with open(path) as f:
        assert f.read() == ref


def _assert_corr(path):
    names, got = TS.correlation_report(path)
    ref = pd.read_csv(path).select_dtypes("number").corr(method="pearson")
    assert names == list(ref.columns)
    r = ref.to_numpy()
    assert got.dtype == np.float64
    np.testing.assert_array_equal(np.isnan(got), np.isnan(r))
    ok = ~np.isnan(r)
    assert np.abs(got[ok] - r[ok]).max() <= 1e-12
    return names, got


def test_correlation_report_matches_pandas(searched, tmp_path):
    """Both packages' CSVs, and one with gaps (pairwise-complete rows), a
    constant column and an all-empty one."""
    _, _, jcsv, tcsv = searched
    for path in (jcsv, tcsv):
        names, got = _assert_corr(path)
        mat = pd.read_csv(path)[names].to_numpy(np.float64)
        varies = np.nanstd(mat, axis=0) > 0
        assert varies.sum() >= 4 and (np.diag(got)[varies] == 1.0).all()
    rng = np.random.default_rng(3)
    x = rng.normal(size=(9, 3))
    x[[1, 4], 0] = np.nan
    x[6, 2] = np.nan
    df = pd.DataFrame({"a": x[:, 0], "b": x[:, 1], "c": x[:, 2], "k": 1.0,
                       "e": None, "s": ["u"] * 9, "i": np.arange(9)})
    gapped = str(tmp_path / "gapped.csv")
    df.to_csv(gapped, index=False)
    names, got = _assert_corr(gapped)
    assert "s" not in names and np.isnan(got[names.index("k")]).all()


def test_float_parse_matches_read_csv(tmp_path):
    """Numbers as read_csv reads them, bit for bit: 17 significant digits
    with the leading zeros of the integer part, exponents, signs, inf."""
    rng = np.random.default_rng(11)
    vals = np.concatenate([rng.random(300), rng.normal(size=100) * 1e3,
                           10.0 ** rng.uniform(-12, 12, 100)])
    texts = [repr(float(v)) for v in vals] + [
        "0.08175098692698718", "-1e-05", "1E+16", "123456789012345678901",
        "0.000000000000000000001234", "-inf", "7.", ".5", "+2.5e3"]
    path = str(tmp_path / "f.csv")
    with open(path, "w") as f:
        f.write("x\n" + "\n".join(texts) + "\n")
    ref = pd.read_csv(path)["x"].to_numpy(np.float64)
    got = np.array([TS._parse_float(t) for t in texts])
    np.testing.assert_array_equal(got.view(np.int64), ref.view(np.int64))


def test_plots_are_written(searched, tmp_path):
    from PIL import Image
    _, _, _, tcsv = searched
    paths = TS.plot_search_results(tcsv, str(tmp_path / "plots"))
    assert [os.path.basename(p) for p in paths] == ["search_scatter.png",
                                                   "search_correlation.png"]
    scatter = np.asarray(Image.open(paths[0]))
    # four metric rows of four setting panels, each with dots drawn
    assert scatter.shape == (4 * 180, 4 * 240, 3)
    assert (np.abs(scatter.astype(int) - (31, 119, 180)).sum(-1) < 60).any()
    names, _ = TS.correlation_report(tcsv)
    assert np.asarray(Image.open(paths[1])).shape == (32 * len(names),) * 2 + (3,)


def test_main_cli(setup, tmp_path, capsys):
    """``python -m sat_tpu_torch.evalx.search``: JAX's flags, the trial
    lines, the route on stderr, the correlation table and the plots."""
    _, json_path, ckpt = setup
    out = str(tmp_path / "cli" / "evals.csv")
    rows = TS.main(["--checkpoint", ckpt, "--json", json_path, "--trials", "2",
                    "--batches", "1", "--batch_size", "4", "--csv", out,
                    "--seed", "7", "--plot"], device="cpu")
    text = capsys.readouterr()
    assert len(rows) == 2 and len(pd.read_csv(out)) == 2
    assert "trial 0: bleu4=" in text.out and "trial 1: bleu4=" in text.out
    assert text.err.count("decode route: plain (not a CUDA device)") == 2
    assert any(line.startswith("bleu4 ") for line in text.out.splitlines())
    assert "plots:" in text.out
    assert os.path.exists(os.path.join(os.path.dirname(out), "search_scatter.png"))
