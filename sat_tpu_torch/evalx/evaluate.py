"""Checkpoint evaluation CLI, ported from ``sat_tpu/evalx/evaluate.py``:
BLEU-1..4 / GLEU / cosine / perplexity of a checkpoint's beam-search
captions on a dataset split (the reference's evaluate.ipynb cell-1 "load
checkpoint, score the test split" flow).

Takes a ``SATTPU1`` or a reference Lightning ``.ckpt`` (auto-detected,
``train/checkpoints.py::load_any_checkpoint``): the BLEU-parity harness.

    python -m sat_tpu_torch.evalx.evaluate --checkpoint v72.ckpt \\
        --json 128k256.json --split test --beamk 5 --rescore_method LN

``main(argv, device="cpu")`` runs on the CPU; by default it runs on the CUDA
card (beam search through the step kernels) and raises without one.  Under
a process group (``torchrun --nproc_per_node N -m
sat_tpu_torch.evalx.evaluate ...``) each batch splits over the ranks, as
JAX's shards over its mesh: each rank captions its rows, the captions are
gathered, and every rank scores the split.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch


def evaluate(model, ds, batch_size: int = 64, beamk: int = 5,
             max_gen_length: int = 32, temperature: float = 1.0,
             rescore_method: Optional[str] = "LN", rescore_reward: float = 0.5,
             limit_batches: Optional[int] = None, verbose: bool = True,
             early_exit: bool = True, return_captions: bool = False,
             timings: Optional[Dict[str, float]] = None, mesh=None):
    """Decode the split with beam search on the model's device, then score
    it once as a corpus.  ``return_captions`` also returns the best-beam
    token-id lists in split order; a ``timings`` dict receives the seconds
    spent on data, decode (encode, beam search, fetch) and score.  ``mesh``
    (default: every rank of the process group, one without one) splits
    each batch, padded to a multiple of its size, over its ranks."""
    from ..data.dataset import CaptionLoader
    from ..data.transforms import val_preprocess
    from ..evalx.metrics import score_captions
    from ..parallel.mesh import create_mesh

    loader = CaptionLoader(ds, min(batch_size, len(ds)), model.cfg.input_size,
                           shuffle=False, train=False, drop_last=False)
    mesh = mesh or create_mesh()
    dev = next(model.parameters()).device
    if verbose:
        print(f"decode route: {model.decode_route()}", file=sys.stderr)
    embedding = model.decoder.embedding.detach().float().cpu().numpy()
    tm = {"data": 0.0, "decode": 0.0, "score": 0.0}
    # Accumulate the WHOLE split, then score once: corpus BLEU/GLEU are
    # nonlinear, so per-batch scores averaged together depend on the batch
    # size and are NOT the corpus metric (nltk corpus_bleu over the split is
    # what the reference logs and what parity requires).
    all_caps, all_enc, all_lens, all_ppl = [], [], [], []
    n_images = 0
    t0 = time.time()
    # the fixed batch, a multiple of the mesh; the tail is padded to it
    bs = -(-loader.batch_size // mesh.size) * mesh.size
    t_max = loader.ds.encoded_captions.shape[2]
    batches = iter(loader)
    for i in range(len(loader)):
        if limit_batches is not None and i >= limit_batches:
            break
        t = time.perf_counter()
        batch = next(batches)
        tm["data"] += time.perf_counter() - t
        t = time.perf_counter()
        n = batch["images"].shape[0]
        imgs = batch["images"]
        if n < bs:  # pad the tail to the fixed batch
            imgs = np.concatenate([imgs, np.repeat(imgs[-1:], bs - n, 0)])
        caps, _, _, ppl = model.caption(
            val_preprocess(torch.from_numpy(mesh.rows(imgs)).to(dev)), beamk=beamk,
            max_gen_length=max_gen_length, temperature=temperature,
            rescore_method=rescore_method, rescore_reward=rescore_reward,
            early_exit=early_exit, mesh=mesh)
        if mesh.size > 1:   # every rank's rows, in order
            parts = mesh.gather_objects((caps, ppl))
            caps, ppl = (sum((list(q[j]) for q in parts), []) for j in range(2))
        tm["decode"] += time.perf_counter() - t
        all_caps.extend(caps[:n])
        all_ppl.extend(ppl[:n])
        enc = np.asarray(batch["captions"])
        if enc.shape[2] < t_max:  # bucket-trimmed batches re-pad to stack
            enc = np.pad(enc, ((0, 0), (0, 0), (0, t_max - enc.shape[2])))
        all_enc.append(enc)
        all_lens.append(np.asarray(batch["lengths"]))
        n_images += n
        if verbose:
            print(f"\r# batch {i + 1}/{len(loader)} ({n_images} images)",
                  end="", file=sys.stderr)
    if verbose:
        print(f" in {time.time() - t0:.1f}s", file=sys.stderr)
    if timings is not None:
        timings.update(tm)
    if not all_caps:
        return ({}, []) if return_captions else {}
    t = time.perf_counter()
    metrics = score_captions(all_caps, np.concatenate(all_enc),
                             np.concatenate(all_lens), embedding=embedding,
                             perplexities=all_ppl)
    if timings is not None:
        timings["score"] = time.perf_counter() - t
    if return_captions:
        return metrics, all_caps
    return metrics


def main(argv: Optional[Sequence[str]] = None,
         device: Union[str, torch.device, None] = None) -> Dict[str, float]:
    from ..data.dataset import CaptionDataset
    from ..parallel.mesh import create_mesh, maybe_initialize_distributed
    from ..train.checkpoints import load_any_checkpoint

    p = argparse.ArgumentParser(description="evaluate a checkpoint on a split")
    p.add_argument("--checkpoint", required=True,
                   help="SAT-TPU or reference-Lightning .ckpt")
    p.add_argument("--json", default=None, help="dataset json (default: from ckpt)")
    p.add_argument("--split", default="test", choices=["train", "val", "test"])
    p.add_argument("--batch", default=64, type=int)
    p.add_argument("--beamk", default=5, type=int)
    p.add_argument("--max_gen_length", default=32, type=int)
    p.add_argument("--temperature", default=1.0, type=float)
    p.add_argument("--rescore_method", default="LN")
    p.add_argument("--rescore_reward", default=0.5, type=float)
    p.add_argument("--limit_batches", default=None, type=int)
    p.add_argument("--early_exit", action="store_true", default=True,
                   help="stop each batch's decode when all captions end "
                        "(exact). Default on; --no_early_exit reverts")
    p.add_argument("--no_early_exit", dest="early_exit", action="store_false")
    a = p.parse_args(argv)
    maybe_initialize_distributed()
    mesh = create_mesh()

    model = load_any_checkpoint(a.checkpoint, device=device)
    ds = CaptionDataset(a.json or model.cfg.json, a.split)
    rescore = None if a.rescore_method in ("None", "none", "") else a.rescore_method
    metrics = evaluate(model, ds, batch_size=a.batch,
                       beamk=a.beamk, max_gen_length=a.max_gen_length,
                       temperature=a.temperature, rescore_method=rescore,
                       rescore_reward=a.rescore_reward,
                       limit_batches=a.limit_batches,
                       early_exit=a.early_exit, mesh=mesh)
    if mesh.rank == 0:
        print(json.dumps({"split": a.split, "beamk": a.beamk, **
                          {k: round(v, 5) for k, v in metrics.items()}}))
    return metrics


if __name__ == "__main__":
    main()
