"""The JSON dataset, bucket sampler and batch loader of
``sat_tpu/data/dataset.py``, with its process shards.

Batches are numpy dicts: ``images`` uint8 (B, S, S, 3), ``captions`` int32
(B, R, T) and ``lengths`` int32 (B, R), bit-identical to the JAX loader's
for the same seed, since both draw from the same numpy ``SeedSequence``
streams: ``[seed, 7, epoch]`` for the shuffle, ``[seed, 11, epoch]`` for the
bucket groups and ``[seed, 5, process_index, epoch, batch]`` for each
batch's crops.
Images decode through the C++ pool of ``native/`` where it builds, else
through ``data/images.py`` (PIL, or PNG by zlib + numpy), by JAX's rules;
``workers > 0`` decodes in a prefetch thread."""

from __future__ import annotations

import json
import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .. import native
from ..vocab import Vocab
from .images import decode_resized, square_crop

Batch = Dict[str, np.ndarray]


class CaptionDataset:
    """One split of the preprocessed JSON."""

    def __init__(self, jsonpath_or_dict, split: str = "train"):
        if isinstance(jsonpath_or_dict, str):
            with open(jsonpath_or_dict) as f:
                jsonpath_or_dict = json.load(f)
        self.json = jsonpath_or_dict
        self.split = split
        self.vocab = Vocab(self.json["vocab_stoi"])
        sd = self.json[split]
        self.img_paths: List[str] = sd["img_paths"]
        self.encoded_captions = np.asarray(sd["encoded_captions"], np.int32)
        self.lengths = np.asarray(sd["lengths"], np.int32)
        if not len(self.img_paths) == len(self.encoded_captions) == len(self.lengths):
            raise ValueError(f"split {split!r}: img_paths, encoded_captions and "
                             "lengths differ in length")

    def __len__(self) -> int:
        return len(self.img_paths)


class BucketSampler:
    """Indices grouped by the sum of each image's caption lengths, longest
    group first, each group shuffled by the epoch's stream."""

    def __init__(self, lengths: np.ndarray, seed: int = 0):
        totals = np.asarray(lengths).sum(axis=1)
        groups: Dict[int, List[int]] = {}
        for i, t in enumerate(totals):
            groups.setdefault(int(t), []).append(i)
        self.grouped = [groups[k] for k in sorted(groups, reverse=True)]
        self._seed = seed

    def order(self, epoch: int) -> List[int]:
        rng = np.random.default_rng(np.random.SeedSequence([self._seed, 11, epoch]))
        out: List[int] = []
        for g in self.grouped:
            g = list(g)
            rng.shuffle(g)
            out.extend(g)
        return out


class CaptionLoader:
    """Fixed-shape batch iterator with a threaded decode prefetch.

    ``drop_last`` drops the trailing partial batch (train); val keeps it.
    With ``bucket``, captions trim to <START> + the batch's longest target
    run, rounded up to a multiple of 4.  ``cache_images`` keeps each decoded
    image (before the crop) for later epochs.

    ``native_decode`` picks the decode route (``native.pool_for``: by
    default the C++ pool where it builds, else PIL).  The pool's route
    draws each batch's crops as JAX's does: uncached, one ``decode_batch``
    per batch with ``rng.random((n, 2))`` float32 offsets (train) or the
    centre sentinel -1 (val), and ``square_crop``'s integer draws for a
    file the pool rejects, which falls back to ``decode_resized``; cached,
    ``decode_resized`` of the pool, then ``square_crop``.

    ``process_count > 1`` loads one process's share, as JAX's multi-host
    loader does: ``batch_size`` stays the global batch, every process
    computes the same epoch order, and process ``process_index`` takes the
    contiguous rows ``[i * B / P, (i + 1) * B / P)`` of each global batch,
    with the global batch's caption trim.  The batch must divide by the
    process count, and a ragged tail is not allowed (``drop_last``)."""

    def __init__(self, ds: CaptionDataset, batch_size: int, input_size: int,
                 shuffle: bool = True, bucket: bool = False, seed: int = 0,
                 workers: int = 0, train: bool = True, drop_last: bool = True,
                 cache_images: bool = False,
                 native_decode: Optional[bool] = None,
                 process_index: int = 0, process_count: int = 1):
        if process_count > 1:
            # JAX's checks, raised as ValueError (an assert vanishes under -O)
            if batch_size % process_count:
                raise ValueError(f"batch {batch_size} not divisible by "
                                 f"{process_count} processes")
            if not drop_last:
                raise ValueError("multi-process loading requires drop_last")
        self._native = native.pool_for(native_decode)
        self.ds = ds
        self.batch_size = batch_size
        self.process_index = process_index
        self.process_count = process_count
        self.input_size = input_size
        self.shuffle = shuffle
        self.workers = max(0, workers)
        self.train = train
        self.drop_last = drop_last
        self._img_cache: Optional[Dict[int, np.ndarray]] = (
            {} if cache_images else None)
        self.decoded = 0      # images decoded so far (cache misses)
        self._seed = seed
        self._sampler = BucketSampler(ds.lengths, seed) if bucket else None
        self._epoch = 0
        self._external_epoch: Optional[int] = None
        self._skip_next = 0

    def set_epoch(self, epoch: int, skip_batches: int = 0) -> None:
        """Fix the epoch (the streams) of every later pass, and drop the
        next pass's first ``skip_batches`` batches before anything is
        decoded."""
        self._external_epoch = epoch
        self._skip_next = skip_batches

    def __len__(self) -> int:
        n = len(self.ds)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _order(self, epoch: int) -> List[int]:
        if self._sampler is not None:
            return self._sampler.order(epoch)
        order = list(range(len(self.ds)))
        if self.shuffle:
            np.random.default_rng(np.random.SeedSequence(
                [self._seed, 7, epoch])).shuffle(order)
        return order

    def _decode_full(self, idx: int) -> np.ndarray:
        if self._img_cache is not None and idx in self._img_cache:
            return self._img_cache[idx]
        path = self.ds.img_paths[idx]
        arr = (self._native.decode_resized(path, self.input_size)
               if self._native is not None else None)
        if arr is None:
            arr = decode_resized(path, self.input_size)
        self.decoded += 1
        if self._img_cache is not None:
            self._img_cache[idx] = arr
        return arr

    def _pool_batch(self, idxs: Sequence[int], rng: np.random.Generator) -> np.ndarray:
        """One ``decode_batch`` call for the batch; a file the pool rejects
        is decoded by ``decode_resized`` and cropped by ``square_crop``."""
        paths = [self.ds.img_paths[i] for i in idxs]
        size = self.input_size
        offs = (rng.random((len(idxs), 2)).astype(np.float32) if self.train
                else np.full((len(idxs), 2), -1.0, np.float32))
        imgs, ok = self._native.decode_batch(paths, size, offs)
        for j in np.flatnonzero(~ok):
            imgs[j] = square_crop(decode_resized(paths[j], size), size,
                                  random_offset=self.train, rng=rng)
        self.decoded += len(idxs)
        return imgs

    def _trim_len(self, idxs: Sequence[int]) -> int:
        """<START> + the longest target run of batch ``idxs``, rounded up to
        4k + 1."""
        t_needed = int(self.ds.lengths[list(idxs)].max()) + 1
        return min(-(-t_needed // 4) * 4 + 1, self.ds.encoded_captions.shape[2])

    def captions_of(self, idxs: Sequence[int], trim: Optional[int] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Batch ``idxs``'s captions and lengths; with the bucket sampler the
        captions trimmed to ``trim`` (a plan's global trim), by default the
        batch's own ``_trim_len``."""
        captions = self.ds.encoded_captions[list(idxs)]
        lengths = self.ds.lengths[list(idxs)]
        if self._sampler is not None:
            captions = captions[:, :, :trim or self._trim_len(idxs)]
        return captions, lengths

    def _make_batch(self, idxs: Sequence[int], trim: Optional[int],
                    stream: Tuple[int, int]) -> Batch:
        epoch, bi = stream
        rng = np.random.default_rng(np.random.SeedSequence(
            [self._seed, 5, self.process_index, epoch, bi]))
        if self._native is None or self._img_cache is not None:
            imgs = np.stack([square_crop(self._decode_full(i), self.input_size,
                                         random_offset=self.train, rng=rng)
                             for i in idxs])
        else:
            imgs = self._pool_batch(idxs, rng)
        captions, lengths = self.captions_of(idxs, trim)
        return {"images": imgs, "captions": captions, "lengths": lengths}

    def batch_plans(self) -> List[Tuple[List[int], Optional[int], Tuple[int, int]]]:
        """One epoch's plan, (this process's dataset indices, the global
        batch's caption trim or None for one process, crop stream key) per
        batch, without decoding anything.  Without ``set_epoch``, each pass
        is the next epoch."""
        epoch = (self._external_epoch if self._external_epoch is not None
                 else self._epoch)
        order = self._order(epoch)
        n_full = len(order) // self.batch_size
        batches = [order[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(n_full)]
        if not self.drop_last and len(order) % self.batch_size:
            batches.append(order[n_full * self.batch_size:])
        if self.process_count > 1:
            local = self.batch_size // self.process_count
            lo = self.process_index * local
            batches = [(b[lo:lo + local], self._trim_len(b)) for b in batches]
        else:
            batches = [(b, None) for b in batches]
        plans = [(b, trim, (epoch, bi))
                 for bi, (b, trim) in enumerate(batches)][self._skip_next:]
        self._skip_next = 0
        self._epoch += 1
        return plans

    def __iter__(self) -> Iterator[Batch]:
        plans = self.batch_plans()
        if self.workers == 0:
            for idxs, trim, stream in plans:
                yield self._make_batch(idxs, trim, stream)
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.workers * 2)
        stop = threading.Event()   # set when the consumer leaves early

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            for idxs, trim, stream in plans:
                if not put(self._make_batch(idxs, trim, stream)):
                    return
            put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                try:
                    item = q.get(timeout=1.0)
                except queue.Empty:
                    if not t.is_alive():
                        raise RuntimeError("prefetch producer thread died "
                                           "(see the traceback above)")
                    continue
                if item is None:
                    break
                yield item
        finally:
            stop.set()
            t.join(timeout=10)
