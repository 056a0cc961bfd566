"""The port's caption metrics (sat_tpu_torch.evalx.metrics) against
sat_tpu.evalx.metrics on seeded random captions and references.  The two are
the same arithmetic in the same order (JAX may count n-grams in its C++
pool, whose integer statistics are the Python path's), so the floats are
held equal with ``==``."""

import numpy as np
import pytest

from sat_tpu.evalx import metrics as jax_metrics
from sat_tpu_torch.evalx import metrics
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

V, E = 14, 6


def corpus(seed, b=9, r=4, t=10):
    """Token captions, references as (B, R, T) rows <START> w.. <END> pads
    with lengths, and an embedding.  Edge cases: an empty caption, a
    one-word reference, a caption longer than every reference."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(2, t - 1, (b, r))
    lens[0, 0] = 2                       # a reference of one word
    enc = np.zeros((b, r, t), np.int32)
    enc[..., 0] = V - 2
    for i in range(b):
        for j in range(r):
            enc[i, j, 1:lens[i, j]] = rng.integers(1, 5, lens[i, j] - 1)
            enc[i, j, lens[i, j]] = V - 1
    caps = [rng.integers(1, 5, rng.integers(1, t)).tolist() for _ in range(b)]
    caps[1] = []                         # an empty caption
    caps[2] = rng.integers(1, 5, 3 * t).tolist()
    emb = rng.standard_normal((V, E)).astype(np.float32)
    return caps, enc, lens.astype(np.int32), emb


def refs_of(enc, lens):
    return [[enc[i, j, 1:lens[i, j]].tolist() for j in range(enc.shape[1])]
            for i in range(enc.shape[0])]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("weights", [(1, 0, 0, 0), (0.5, 0.5, 0, 0),
                                     (1 / 3, 1 / 3, 1 / 3, 0), (0.25,) * 4])
def test_corpus_bleu(seed, weights):
    caps, enc, lens, _ = corpus(seed)
    refs = refs_of(enc, lens)
    got = metrics.corpus_bleu(refs, caps, weights)
    assert got == jax_metrics.corpus_bleu(refs, caps, weights)


@pytest.mark.parametrize("seed", range(4))
def test_corpus_gleu_and_cosine(seed):
    caps, enc, lens, emb = corpus(seed)
    refs = refs_of(enc, lens)
    assert metrics.corpus_gleu(refs, caps) == jax_metrics.corpus_gleu(refs, caps)
    assert (metrics.embedding_cosine_similarity(emb, caps, refs)
            == jax_metrics.embedding_cosine_similarity(emb, caps, refs))


@pytest.mark.parametrize("seed", range(4))
def test_score_captions(seed):
    caps, enc, lens, emb = corpus(seed)
    ppl = list(np.random.default_rng(seed).uniform(1, 9, len(caps)))
    got = metrics.score_captions(caps, enc, lens, embedding=emb, perplexities=ppl)
    ref = jax_metrics.score_captions(caps, enc, lens, embedding=emb, perplexities=ppl)
    assert got == ref
    assert set(got) == {"bleu1", "bleu2", "bleu3", "bleu4", "gleu",
                        "cosine_similarity", "perplexity"}


def test_zero_precision_and_empty_corpus():
    """No 4-gram in common gives BLEU-4 0 (no smoothing); all-empty
    captions give 0 everywhere in both packages."""
    refs = [[[1, 2, 3, 4, 5]], [[2, 3]]]
    caps = [[1, 2, 3, 5, 4], [2, 3]]
    for w in [(0.25,) * 4, (1, 0, 0, 0)]:
        assert metrics.corpus_bleu(refs, caps, w) == jax_metrics.corpus_bleu(refs, caps, w)
    assert metrics.corpus_bleu(refs, caps) == 0.0
    empty = [[], []]
    assert metrics.corpus_bleu(refs, empty) == jax_metrics.corpus_bleu(refs, empty) == 0.0
    assert metrics.corpus_gleu(refs, empty) == jax_metrics.corpus_gleu(refs, empty)
    enc = np.array([[[12, 1, 2, 13, 0]], [[12, 2, 13, 0, 0]]], np.int32)
    lens = np.array([[3], [2]], np.int32)
    assert (metrics.score_captions(empty, enc, lens)
            == jax_metrics.score_captions(empty, enc, lens))
