"""The port's Karpathy preprocessing CLI (sat_tpu_torch.data.preprocess)
against sat_tpu.data.preprocess on a tiny Karpathy JSON and a tiny GloVe
file: the same dataset JSON bytes, the same GloVe ``.npy`` bytes, the same
``--inspect`` text and montage."""

import os

import numpy as np
import pytest

from sat_tpu.data import preprocess as JP
from sat_tpu_torch.data import preprocess as TP
from test_preprocess import karpathy_fixture
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


def glove_file(tmp_path, dim=10):
    """Vectors for some of the fixture's words; the rest draw from the
    matrix builder's generator."""
    rng = np.random.default_rng(3)
    path = tmp_path / "glove.txt"
    with open(path, "w", encoding="utf-8") as f:
        for w in ("a", "dog", "the", "cat", "skis", "man"):
            f.write(w + " " + " ".join(f"{v:.5f}" for v in rng.normal(size=dim)) + "\n")
    return str(path)


def run_both(main_of, argv, out):
    """Each package's ``main`` writing ``out`` in turn: {name: (JSON
    bytes, .npy bytes or None)}."""
    got = {}
    for name, main in main_of.items():
        main(argv + ["--output", out])
        npy = os.path.splitext(out)[0] + ".npy"
        with open(out, "rb") as f:
            got[name] = (f.read(), open(npy, "rb").read() if os.path.exists(npy) else None)
        for p in (out, npy):
            if os.path.exists(p):
                os.remove(p)
    return got


@pytest.mark.parametrize("extra", [
    [],                                                    # the defaults: min_count 5
    ["--min_count", "0"],
    ["--min_count", "0", "--dev_train_keep", "1", "--dev_val_keep", "1"],
    ["--min_count", "0", "--max_vocab", "8", "--max_cap_length", "4", "--seed", "7"],
    ["--min_count", "0", "--ref_sentences", "7"],           # more padding draws
    ["--min_count", "0", "--glove", "--pretrained_dim", "10"],
    ["--min_count", "0", "--glove", "--pretrained_dim", "10", "--no_extend_dim"],
])
def test_main_writes_jax_bytes(tmp_path, extra):
    kp = karpathy_fixture(tmp_path)
    argv = ["--karpathy_json", kp, "--coco_image_folder", str(tmp_path / "coco")]
    for a in extra:
        argv += ["--glove_file", glove_file(tmp_path)] if a == "--glove" else [a]
    got = run_both({"jax": JP.main, "port": TP.main}, argv, str(tmp_path / "ds.json"))
    assert got["port"] == got["jax"]
    assert (got["port"][1] is not None) == ("--glove" in extra)


def test_build_glove_matrix_matches_jax(tmp_path):
    """The matrix and its width, with and without the pad to a multiple of
    8, OOV rows drawn from JAX's generator in JAX's order."""
    kp = karpathy_fixture(tmp_path)
    data = JP.preprocess_karpathy(kp, "coco", "", min_count=0, max_vocab=None)
    from sat_tpu.vocab import Vocab as JaxVocab
    from sat_tpu_torch.vocab import Vocab
    gp = glove_file(tmp_path, dim=12)
    for extend in (True, False):
        want = JP.build_glove_matrix(JaxVocab(data["vocab_stoi"]), gp, 12, extend, seed=5)
        got = TP.build_glove_matrix(Vocab(data["vocab_stoi"]), gp, 12, extend, seed=5)
        assert got[1] == want[1] == (16 if extend else 12)
        assert got[0].dtype == want[0].dtype and np.array_equal(got[0], want[0])
    assert [TP.clean_token(t) for t in ("Tolet", "SKIIS", "porduce", "raquet")] == \
        [JP.clean_token(t) for t in ("Tolet", "SKIIS", "porduce", "raquet")]


def test_inspect_matches_jax(tmp_path, capsys):
    """``--inspect 3 --inspect_images DIR``: the same printed text (the
    montage line names each package's DIR) and the same JPEG bytes."""
    kp = karpathy_fixture(tmp_path)
    base = ["--karpathy_json", kp, "--coco_image_folder", str(tmp_path / "coco"),
            "--min_count", "0", "--inspect", "3"]
    text, jpeg = {}, {}
    for name, main in (("jax", JP.main), ("port", TP.main)):
        out_dir = str(tmp_path / name)
        main(base + ["--output", str(tmp_path / f"{name}.json"), "--inspect_images", out_dir])
        text[name] = capsys.readouterr().out.replace(out_dir, "DIR")
        with open(os.path.join(out_dir, "inspect.jpg"), "rb") as f:
            jpeg[name] = f.read()
    assert text["port"] == text["jax"] and "[0] COCO_train2014_0.jpg" in text["port"]
    assert jpeg["port"] == jpeg["jax"]
    TP.inspect_dataset(str(tmp_path / "port.json"), n=2)
    JP.inspect_dataset(str(tmp_path / "jax.json"), n=2)
    port, jax_text = capsys.readouterr().out.split("vocab_size=")[1:]
    assert port == jax_text
