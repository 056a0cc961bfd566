"""Batch captioning CLI, the port's serving path, ported from
``sat_tpu/serve.py``: a directory (files, globs) of images in, one JSONL
record per image out.

    python -m sat_tpu_torch.serve --checkpoint last.ckpt --images photos/ \\
        --batch 64 --beamk 3 --rescore_method LN --output captions.jsonl

The checkpoint is a ``SATTPU1`` file or a reference Lightning ``.ckpt``
(``train/checkpoints.py::load_any_checkpoint``).  Images are decoded on the
host (shorter side to ``input_size``, centre crop) in one prefetch thread,
so batch N + 1 decodes while the card captions batch N: by the C++ pool of
``native/`` where it builds, as the JAX package's serve does, with
``data/images.py`` for each file the pool rejects, and by ``data/images.py``
alone where the pool does not build.  A file that does not decode gives an error record.
Batches have the fixed size ``--batch``, the tail padded with its last
image; each batch is encoded and decoded by ``SATModel.caption`` (beam
search: the step kernels on the card, or the plain path by
``decode.beam.decode_route``'s rule, reported on stderr).  ``--precision
16`` (the default, as in the JAX package) casts every float leaf of the
model and the images to bfloat16, which moves captions away from float32
(``ROADMAP.md`` §3).  ``main(argv, device="cpu")`` runs on
the CPU; by default it runs on the CUDA card and raises without one.

On a mesh of ranks (``--mesh_shape`` / ``--mesh_axes``, one process per
device, e.g. ``torchrun --nproc_per_node 2 -m sat_tpu_torch.serve
--mesh_shape 2 ...``; ``--mesh_axes data model`` shards the vocab tables),
``--batch`` is rounded up to the mesh size, each rank decodes and captions
its rows of every batch, and rank 0 writes the records in input order.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

_IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def gather_images(specs: List[str]) -> List[str]:
    """Expand dirs / globs / files into a sorted unique image-path list."""
    paths: List[str] = []
    for spec in specs:
        if os.path.isdir(spec):
            for root, _, files in os.walk(spec):
                paths.extend(os.path.join(root, f) for f in files
                             if f.lower().endswith(_IMG_EXTS))
        elif any(ch in spec for ch in "*?[") and not os.path.exists(spec):
            hits = [p for p in glob.glob(spec, recursive=True)
                    if p.lower().endswith(_IMG_EXTS)]
            if not hits:
                print(f"warning: --images glob {spec!r} matched nothing",
                      file=sys.stderr)
            paths.extend(hits)
        else:
            # literal path first: a file genuinely named 'img[1].jpg' must
            # not be swallowed by glob expansion (it would match 'img1.jpg')
            paths.append(spec)
    return sorted(dict.fromkeys(paths))


def decode_images(paths: List[str], size: int, pool=None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(N, size, size, 3) uint8 centre crops + per-image ok mask: one
    ``pool.decode_batch`` call where a ``native.DecodePool`` is given, and
    ``data/images.py`` for the files it rejects, or for all without one.  A
    corrupt or undecodable file does not stop the run: it is flagged
    ok=False (zeros in its place) and the caller emits an error record."""
    from .data.images import decode_resized, square_crop
    n = len(paths)
    if pool is not None:
        imgs, ok = pool.decode_batch(paths, size, np.full((n, 2), -1.0, np.float32))
    else:
        imgs, ok = np.zeros((n, size, size, 3), np.uint8), np.zeros(n, bool)
    for j in np.flatnonzero(~ok):
        try:
            imgs[j] = square_crop(decode_resized(paths[j], size), size)
            ok[j] = True
        except Exception:
            pass  # stays ok=False
    return imgs, ok


def main(argv: Optional[Sequence[str]] = None,
         device: Union[str, torch.device, None] = None,
         timings: Optional[Dict[str, float]] = None) -> int:
    """The CLI.  A ``timings`` dict receives the run's seconds (``seconds``
    from the checkpoint's load to the last record, ``decode_s`` in the
    prefetch thread, ``decode_wait_s`` waited on it), ``images`` and the
    image-decode route (``route``) and the beam route (``decode_route``,
    printed on stderr too)."""
    from . import native
    from .parallel.mesh import (create_mesh, maybe_initialize_distributed,
                                shard_vocab_params)
    from .train.checkpoints import load_any_checkpoint
    from .utils.platform import resolve_device

    p = argparse.ArgumentParser(description="batch image captioning")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--images", nargs="+", required=True,
                   help="image files, directories, or globs")
    p.add_argument("--batch", default=64, type=int)
    p.add_argument("--beamk", default=3, type=int)
    p.add_argument("--max_gen_length", default=32, type=int)
    p.add_argument("--temperature", nargs="+", default=[1.0], type=float)
    p.add_argument("--sample_method", default="beam",
                   choices=["beam", "multinomial", "topk"])
    p.add_argument("--sample_topk", default=3, type=int)
    p.add_argument("--decoder_noise", default=None, type=float,
                   help="hidden-state noise; decodes by the plain path (the "
                        "step kernels draw none), as the JAX package's rule")
    p.add_argument("--rescore_method", default="LN")
    p.add_argument("--rescore_reward", default=0.5, type=float)
    p.add_argument("--early_exit", action="store_true", default=True,
                   help="stop decoding as soon as every caption in the batch "
                        "has ended (exact). Default on; --no_early_exit reverts")
    p.add_argument("--no_early_exit", dest="early_exit", action="store_false")
    p.add_argument("--return_all", action="store_true",
                   help="emit all beamk candidates per image")
    p.add_argument("--mesh_shape", nargs="+", default=[-1], type=int,
                   help="mesh of ranks (-1: the world size)")
    p.add_argument("--mesh_axes", nargs="+", default=["data"], type=str,
                   help="its axes: data, and model for vocab-dim TP")
    p.add_argument("--precision", default=16, type=int, choices=[16, 32])
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--output", default="-", help="JSONL path ('-' = stdout)")
    a = p.parse_args(argv)
    maybe_initialize_distributed()
    mesh = create_mesh(a.mesh_shape, a.mesh_axes)
    if a.batch % mesh.size:
        a.batch += mesh.size - a.batch % mesh.size
        print(f"# batch rounded up to {a.batch} ({mesh.size} devices)",
              file=sys.stderr)
    main_rank = mesh.rank == 0
    paths = gather_images(a.images)
    if not paths:
        print("no images found", file=sys.stderr)
        return 1

    decode_pool = native.pool_for()
    dev = resolve_device(device)
    model = load_any_checkpoint(a.checkpoint, device=dev)
    vocab, size = model.vocab, model.cfg.input_size
    dt = torch.bfloat16 if a.precision == 16 else torch.float32
    model = model.to(dt)
    if mesh.vocab_sharded(model.cfg.vocab_size):
        shard_vocab_params(model.decoder, mesh)
    scale = torch.tensor(255.0, dtype=dt, device=dev)
    rescore = None if a.rescore_method in ("None", "none", "") else a.rescore_method
    temperature = (a.temperature[0] if len(a.temperature) == 1
                   else list(a.temperature))
    generator = torch.Generator(device=dev).manual_seed(a.seed)
    route = model.decode_route(a.decoder_noise)
    print(f"decode route: {route}", file=sys.stderr)

    out = None if not main_rank else (
        sys.stdout if a.output == "-" else open(a.output, "w"))
    n_done, t0 = 0, time.perf_counter()
    tm = {"decode_s": 0.0, "decode_wait_s": 0.0}

    def timed_decode(chunk):
        t = time.perf_counter()
        res = decode_images(chunk, size, decode_pool)
        tm["decode_s"] += time.perf_counter() - t
        return res

    def emit(chunk, ok, caps, scores, ppl):
        for i, path in enumerate(chunk):
            if not ok[i]:
                rec = {"image": path, "error": "undecodable image"}
            elif a.return_all:
                rec = {"image": path, "candidates": [
                    {"caption": " ".join(vocab.itos(t) for t in c),
                     "score": s, "perplexity": pp}
                    for c, s, pp in zip(caps[i], scores[i], ppl[i])]}
            else:
                rec = {"image": path,
                       "caption": " ".join(vocab.itos(t) for t in caps[i]),
                       "score": scores[i], "perplexity": ppl[i]}
            out.write(json.dumps(rec) + "\n")

    rows = a.batch // mesh.size

    def own_rows(chunk):
        """This rank's files of the chunk padded to the batch with its last
        file (padded after decoding: each file decodes once)."""
        lo = mesh.rank * rows
        return chunk[lo:lo + rows] or chunk[-1:]

    # one prefetch thread: the host decodes chunk N + 1 while chunk N is
    # captioned (beam search syncs with the host every step, so the overlap
    # has to come from a second host thread)
    chunks = [paths[lo:lo + a.batch] for lo in range(0, len(paths), a.batch)]
    try:
        with ThreadPoolExecutor(max_workers=1) as pool:
            pending = pool.submit(timed_decode, own_rows(chunks[0]))
            for i, chunk in enumerate(chunks):
                t = time.perf_counter()
                imgs, ok = pending.result()
                tm["decode_wait_s"] += time.perf_counter() - t
                if i + 1 < len(chunks):
                    pending = pool.submit(timed_decode, own_rows(chunks[i + 1]))
                n = len(chunk)
                if len(imgs) < rows:  # pad the tail to the fixed batch
                    imgs = np.concatenate(
                        [imgs, np.repeat(imgs[-1:], rows - len(imgs), axis=0)])
                    ok = np.concatenate([ok, np.repeat(ok[-1:], rows - len(ok))])
                x = torch.from_numpy(imgs).to(dev).to(dt) / scale
                caps, scores, _, ppl = model.caption(
                    x, beamk=a.beamk, max_gen_length=a.max_gen_length,
                    temperature=temperature, sample_method=a.sample_method,
                    sample_topk=a.sample_topk, decoder_noise=a.decoder_noise,
                    rescore_method=rescore, rescore_reward=a.rescore_reward,
                    return_all=a.return_all, generator=generator,
                    early_exit=a.early_exit, mesh=mesh)
                if mesh.size > 1:   # every rank's rows, in order
                    parts = mesh.gather_objects((ok, caps, scores, ppl))
                    ok, caps, scores, ppl = (sum((list(q[j]) for q in parts), [])
                                             for j in range(4))
                if main_rank:
                    emit(chunk, ok, caps, scores, ppl)
                n_done += n
                if main_rank:
                    print(f"\r# {n_done}/{len(paths)} "
                          f"({n_done / (time.perf_counter() - t0):.0f} imgs/s)",
                          end="", file=sys.stderr)
        if main_rank:
            print(file=sys.stderr)
    finally:
        if out is not None and out is not sys.stdout:
            out.close()
    if timings is not None:
        timings.update(tm, images=n_done, seconds=time.perf_counter() - t0,
                       route=native.route(), decode_route=route)
    return 0


if __name__ == "__main__":
    sys.exit(main())
