"""Training, ported from ``sat_tpu/train/loop.py``: the train
step (augment -> encoder -> grouped teacher-forced loss -> backward -> clip
-> group-LR update), the epoch over the dataset's loader, ``validate``
(beam search at ``val_beamk``, LN rescoring, BLEU/GLEU/cosine/perplexity),
and ``fit`` with the plateau scheduler, early stopping, the top-k,
``last.ckpt`` and restart checkpoints and the metrics logger.

As in JAX:

* the encoder trains once ``global_step >= encoder_finetune_after`` (and
  only where ``encoder_finetune_after > 0`` and ``encoder_lr > 0``); before
  that it runs without autograd, with its LR at 0, and its BatchNorm still
  in train mode, updating the running statistics, unless
  ``frozen_encoder_eval`` puts it in eval mode;
* teacher forcing's epsilon is set per epoch, the LRs per step from
  ``LRScheduler``, whose per-batch, per-epoch and validation hooks run where
  JAX runs them;
* the randomness of a step (augmentation, coins, dropout) is a function of
  ``(cfg.seed, global_step)`` alone, the counterpart of
  ``fold_in(seed_base, global_step)``;
* a step's metrics stay on the device; every ``log_every`` steps they are
  fetched at once and each step is logged with its own step number.

The checkpoints hold the weights, the optimizer state in optax's layout
(``train/opt_state.py``), the counters, the scheduler, early-stopping and
top-k state, as JAX's do, and ``cfg.resume`` continues from any of them, a
JAX package's file too: a mid-epoch file (``restart-{step}.ckpt``)
re-enters its epoch and skips the batches already trained.

The settings of JAX's step and epoch, as JAX runs them:

* ``precision 16``: the augment and the images in bf16, and every float32
  weight cast to bf16 inside the loss, so the gradients reach the float32
  weights; the BatchNorm statistics stay float32 (flax's reductions); no
  loss scaling, no ``torch.autocast``.  Validation decodes at float32.
* ``microbatch``: the batch in ``batch / microbatch`` chunks, one forward
  and backward each, the gradients summed; each chunk's CE weighted by its
  share of the batch's target tokens and its attention term by
  ``1 / chunks``, so the sum is the whole batch's loss; BatchNorm
  statistics carry from chunk to chunk.  A chunk's coins and dropout come
  from ``(cfg.seed, global_step, chunk)`` (JAX splits its key per chunk:
  the draws differ from JAX's, the rule does not).
* ``accumulate``: ``train/optim.py::MultiSteps``, optax.MultiSteps' mean of
  ``accumulate`` gradients; the clip, the update and Adam's count only on
  every ``accumulate``-th step, at that step's LRs; BatchNorm statistics
  and the LR schedule move every step.
* ``device_resident_data``: each split decoded once into a uint8 tensor on
  the device (one centre crop for a larger image); a step gathers its rows
  by index, validation too.  ``steps_per_dispatch`` is accepted and
  changes nothing: JAX runs that many steps in one dispatch, which torch
  has no counterpart of, so a staged epoch runs step by step, which is
  JAX's chunked run's result.
* ``profile_dir``: a ``torch.profiler`` trace of ``fit``'s first train
  epoch (``utils/timing.py::maybe_profile``), validation outside it.

On a mesh of ``torch.distributed`` ranks (``mesh_shape`` / ``mesh_axes``,
``parallel/mesh.py``), as JAX's mesh step runs:

* the global ``batch`` splits over every rank; each rank's loaders give its
  rows (``CaptionLoader(process_index, process_count)``), the validation
  batch is cut to a multiple of the mesh and its ragged tail dropped;
* a step on P ranks is the one-process step on the global batch: the
  augment, coins and dropout drawn once for the global batch, BatchNorm on
  the global batch's statistics, the loss normalised by the global counts,
  the gradients summed over the ranks, the clip's norm the whole model's;
  with a ``model`` axis, vocab TP shards the embedding and ``out_proj``
  (and their moments) over it;
* ``microbatch`` chunks each rank's rows (``microbatch / P`` per chunk), so
  chunk i is every rank's chunk i: JAX chunks the global batch
  contiguously, which would leave ranks idle in a chunk;
* validation decodes each rank's rows and gathers the results, and every
  rank scores the whole batch;
* rank 0 alone writes the logs and checkpoints, into the version directory
  it chose; a checkpoint holds the full tables, gathered from the slices;
* ``device_resident_data`` is one process's."""

from __future__ import annotations

import contextlib
import itertools
import os
import sys
import time
from typing import Any, Dict, Iterable, Iterator, List, Mapping, Optional, Union

import numpy as np
import torch

from ..config import SATConfig
from ..data.dataset import CaptionDataset, CaptionLoader
from ..data.images import square_crop
from ..data.transforms import build_train_augment, val_preprocess
from ..decode.api import unpack_beam_result
from ..decode.beam import BeamResult, beam_search
from ..evalx.metrics import score_captions
from ..models.jax_import import model_to_jax_tree
from ..models.model import SATModel
from ..models.sat import train_forward_loss_grouped
from ..parallel.mesh import (ONE_RANK, Mesh, create_mesh, gather_tree,
                             place_tree, shard_vocab_params)
from ..utils.platform import resolve_device
from ..utils.timing import StepTimer, maybe_profile
from .checkpoints import (RestartCheckpointManager, TopKCheckpointManager,
                          load_checkpoint, save_checkpoint)
from .logging import MetricsLogger, next_version_dir
from .opt_state import load_optax_state, optax_state_dict
from .optim import MultiSteps, apply_group_lrs, build_optimizer, clip_gradients, step
from .schedules import LRScheduler
from .tf_schedule import teacher_forcing_epsilon

# images uint8 (B, S, S, 3) or, with staged data, image_idx (B,);
# captions (B, R, T), lengths (B, R)
Batch = Mapping[str, Any]


@contextlib.contextmanager
def cast_weights(module: torch.nn.Module, dtype: torch.dtype) -> Iterator[None]:
    """Within the block, each float32 parameter of ``module`` is its cast to
    ``dtype`` (as ``torch.func.functional_call`` swaps parameters): a
    differentiable copy, so a backward reaches the float32 weights.  Buffers
    (the BatchNorm statistics) are not cast.  Nothing changes at float32."""
    swapped = [] if dtype == torch.float32 else [
        (m, name, p) for m in module.modules() for name, p in m._parameters.items()
        if p is not None and p.dtype == torch.float32]
    for m, name, p in swapped:
        m._parameters[name] = p.to(dtype)
    try:
        yield
    finally:
        for m, name, p in swapped:
            m._parameters[name] = p


def val_decode(model: SATModel, cfg: SATConfig, images: Any,
               mesh: Mesh = ONE_RANK) -> BeamResult:
    """The validation decode: uint8 images (B, S, S, 3) -> [0, 1] ->
    ``model.encode`` -> beam search at ``val_beamk`` with LN rescoring, on
    the model's device (the step kernels on a card); on a ``mesh``, of this
    rank's rows."""
    dev = next(model.parameters()).device
    images = val_preprocess(torch.as_tensor(images).to(dev))
    return beam_search(model.decoder, cfg, model.encode(images),
                       beamk=cfg.val_beamk, max_gen_length=cfg.val_max_len,
                       temperature=1.0, rescore_method="LN",
                       early_exit=cfg.val_early_exit, mesh=mesh)


def _fetch_without_alphas(res: BeamResult, mesh: Mesh = ONE_RANK) -> BeamResult:
    """The result on the host, with zeros in place of the attention maps,
    which scoring never reads; on a ``mesh``, every rank's rows gathered."""
    host = [mesh.fetch_global(x).cpu().numpy()
            for x in (res.tokens, res.lengths, res.raw_scores, res.scores, res.perplexity)]
    alphas = np.zeros(host[1].shape + tuple(res.alphas.shape[2:]), np.float32)
    return BeamResult(*host, alphas)


class Trainer:
    """Trains a fresh ``SATModel.create(cfg, seed cfg.seed)`` on one device,
    or on each rank of the mesh ``cfg.mesh_shape`` / ``cfg.mesh_axes``.

    With ``cfg.json`` or ``dataset`` (a path or the loaded dataset dict) it
    builds the train and val loaders, takes the vocabulary, ``vocab_size``,
    ``embed_dim``, ``pretrained_embedding`` and ``max_cap_length`` from the
    dataset, and writes logs and checkpoints to
    ``{log_root}/{cfg.name}/version_N``; ``fit`` then trains and validates.
    Without a dataset ``cfg`` is complete, with the vocabulary and sizes as a
    checkpoint header carries them, ``steps_per_epoch`` (default
    ``cfg.train_loader_len``) sizes the LR schedules, and the caller hands
    the batches to ``train_step``/``train_epoch``.  ``device=None`` means the
    CUDA card and raises where there is none.  ``cfg.resume`` continues
    from that checkpoint (``_resume``).  The first validation reports its
    decode route (``SATModel.decode_route``) on stderr.

    Every rank builds its own ``Trainer`` (``maybe_initialize_distributed``
    first).  A mesh whose size is not the world size, or a ``batch`` the
    mesh does not divide, raises ``ValueError`` before anything is built.
    On a mesh, ``train_step`` takes this rank's rows of the global batch
    (``parallel.mesh.shard_batch``) and returns the global batch's
    metrics."""

    def __init__(self, cfg: SATConfig, dataset: Optional[Any] = None,
                 log_root: str = "logs",
                 device: Union[str, torch.device, None] = None,
                 steps_per_epoch: Optional[int] = None):
        self.mesh = create_mesh(cfg.mesh_shape, cfg.mesh_axes)
        n_ranks = self.mesh.size
        if cfg.batch % n_ranks:
            raise ValueError(
                f"--batch {cfg.batch} must be divisible by the mesh size "
                f"{n_ranks} (mesh_shape={cfg.mesh_shape}): the batch is "
                "sharded across every rank on the mesh")
        if cfg.microbatch and cfg.microbatch % n_ranks:
            raise ValueError(f"--microbatch {cfg.microbatch} must be divisible by "
                             f"the mesh size {n_ranks}: each rank chunks its rows")
        if cfg.device_resident_data and n_ranks > 1:
            raise ValueError("device_resident_data is single-process: the "
                             "staged pixel array lives in one process's device "
                             "memory (multi-process runs keep the host loaders)")
        self.device = resolve_device(device)
        self.train_loader = self.val_loader = None
        if cfg.json is not None or dataset is not None:
            cfg = self._build_data(cfg, dataset)
            steps_per_epoch = steps_per_epoch or len(self.train_loader)
        elif cfg.device_resident_data:
            raise ValueError("device_resident_data stages the dataset's splits: "
                             "it needs cfg.json or a dataset")
        if cfg.microbatch and (cfg.microbatch >= cfg.batch or cfg.batch % cfg.microbatch):
            raise ValueError(
                f"--microbatch {cfg.microbatch} must be a divisor of --batch "
                f"{cfg.batch} smaller than it (the step runs batch/microbatch "
                "gradient chunks)")
        if cfg.vocab_stoi is None or cfg.vocab_size is None:
            raise ValueError("Trainer needs the vocabulary in the config "
                             "(vocab_stoi, vocab_size) or a dataset")
        steps_per_epoch = steps_per_epoch or cfg.train_loader_len
        if not steps_per_epoch:
            raise ValueError("steps_per_epoch is needed where the config has "
                             "no train_loader_len")
        cfg = cfg.replace(train_loader_len=steps_per_epoch).validate()
        if cfg.frozen_encoder_eval and not (cfg.pretrained
                                            or cfg.pretrained_weights):
            print("WARNING: --frozen_encoder_eval with a from-scratch "
                  "encoder runs the frozen phase on INIT BN statistics "
                  "(mean 0/var 1); intended for pretrained encoders whose "
                  "running stats are warm", file=sys.stderr)
        self.model = SATModel.create(
            cfg, torch.Generator(self.device).manual_seed(cfg.seed))
        self.cfg = cfg = self.model.cfg          # encoder_dim written back
        self.vocab_sharded = self.mesh.vocab_sharded(cfg.vocab_size)
        if self.vocab_sharded:
            shard_vocab_params(self.model.decoder, self.mesh)
        self.model.decoder.requires_grad_(True)
        self.optimizer, _ = build_optimizer(cfg, self.model.named_parameters())
        self.multisteps = (MultiSteps(cfg.accumulate, self.model.named_parameters())
                           if cfg.accumulate > 1 else None)
        self.compute_dtype = torch.bfloat16 if cfg.precision == 16 else torch.float32
        self.scheduler = LRScheduler(cfg, steps_per_epoch=steps_per_epoch)
        self.augment = build_train_augment(cfg, self.mesh)
        self.encoder_on = cfg.encoder_finetune_after > 0 and cfg.encoder_lr > 0
        self.global_step = 0
        self.current_epoch = 0
        self._resume_skip_batches = 0
        self.early_stop_count = 0
        self.early_stop_best: Optional[float] = None
        self.should_stop = False
        self._route_reported = False
        self.last_train_timings: Dict[str, float] = {}
        self.last_val_timings: Dict[str, float] = {}
        self.epoch_timings: List[Dict[str, Any]] = []
        self.logdir = self.logger = self.ckpt = self.restart_ckpt = None
        self.is_main = self.mesh.rank == 0
        if self.train_loader is not None:
            # rank 0 owns every file; its version directory is everyone's
            self.logdir = self.mesh.broadcast_object(
                next_version_dir(log_root, cfg.name) if self.is_main else None)
            self.logger = MetricsLogger(self.logdir, enabled=self.is_main)
            self.ckpt = TopKCheckpointManager(self.logdir, cfg.save_monitor,
                                              cfg.save_top_k, write=self.is_main)
            self.restart_ckpt = RestartCheckpointManager(
                self.logdir, cfg.lr_warmup_steps, write=self.is_main)
        if cfg.resume:
            self._resume(cfg.resume, steps_per_epoch)
        self.staging_seconds: Dict[str, float] = {}
        self._staged_images = self._staged_val_images = None
        if cfg.device_resident_data:
            self._staged_images = self._stage_split(self.train_ds, self.train_loader, "train")
            self._staged_val_images = self._stage_split(self.val_ds, self.val_loader, "val")

    def _resume(self, path: str, steps_per_epoch: int) -> None:
        """Weights, BatchNorm statistics, optimizer state, counters,
        scheduler, early stopping and the top-k registry from ``path``, as
        JAX's Trainer restores them.  A file that ended an epoch starts the
        next; a mid-epoch one re-enters its epoch, skipping
        ``step % steps_per_epoch`` batches.  Under vocab TP each rank takes
        its slices of the tables and their moments."""
        from ..models.jax_import import model_from_jax_tree
        _, raw = load_checkpoint(path)
        if "opt_state" not in raw:
            raise ValueError(f"{path} has no 'opt_state': resume needs a checkpoint "
                             "written by training (top-k, last.ckpt or restart-*.ckpt)")
        if self.vocab_sharded:
            raw = dict(raw, params=place_tree(raw["params"], self.mesh),
                       opt_state=place_tree(raw["opt_state"], self.mesh))
        self.model.load_state_dict(model_from_jax_tree(self.cfg, raw).state_dict())
        load_optax_state(self.cfg, self.model, self.optimizer, raw["opt_state"],
                         self.multisteps)
        self.global_step = int(raw["step"])
        self._resume_skip_batches = self.global_step % max(steps_per_epoch, 1)
        self.current_epoch = int(raw["epoch"]) + (self._resume_skip_batches == 0)
        if "scheduler" in raw:
            self.scheduler.load_state_dict(raw["scheduler"])
        if "early_stop" in raw:
            best = float(raw["early_stop"]["best"])
            self.early_stop_best = None if best == float("-inf") else best
            self.early_stop_count = int(raw["early_stop"]["count"])
        if raw.get("top_k") and self.ckpt is not None:
            self.ckpt.load_state_dict(raw["top_k"], os.path.dirname(os.path.abspath(path)))

    def _build_data(self, cfg: SATConfig, dataset: Optional[Any]) -> SATConfig:
        """The datasets and loaders (this rank's rows on a mesh); returns
        cfg with the dataset's vocabulary and sizes."""
        self.train_ds = CaptionDataset(dataset if dataset is not None else cfg.json,
                                       "train")
        self.val_ds = CaptionDataset(self.train_ds.json, "val")
        js = self.train_ds.json
        cfg = cfg.replace(
            vocab_stoi=self.train_ds.vocab.stoi_map,
            vocab_size=js["vocab_size"],
            embed_dim=js["embed_dim"] if js.get("embed_dim") else cfg.embed_dim,
            pretrained_embedding=js.get("pretrained_embedding"),
            max_cap_length=js["max_cap_length"])
        n, shards = self.mesh.size, dict(process_index=self.mesh.rank,
                                         process_count=self.mesh.size)
        self.train_loader = CaptionLoader(
            self.train_ds, cfg.batch, cfg.input_size,
            shuffle=not cfg.bucket_sampler, bucket=cfg.bucket_sampler,
            seed=cfg.seed, workers=cfg.workers, train=True,
            cache_images=cfg.cache_images, native_decode=cfg.native_decode,
            **shards)
        # val keeps its tail batch on one process; on a mesh every batch
        # splits over the ranks, and a ragged tail is dropped
        val_batch = min(cfg.batch, len(self.val_ds))
        if n > 1:
            val_batch = max(val_batch - val_batch % n, n)
        self.val_loader = CaptionLoader(
            self.val_ds, val_batch, cfg.input_size,
            shuffle=False, bucket=cfg.bucket_sampler, seed=cfg.seed,
            workers=cfg.workers, train=False, drop_last=n > 1,
            cache_images=cfg.cache_images, native_decode=cfg.native_decode,
            **shards)
        return cfg

    def _stage_split(self, ds: CaptionDataset, loader: CaptionLoader,
                     tag: str) -> torch.Tensor:
        """The split decoded once into one uint8 (N, S, S, 3) tensor on the
        device.  Images that decode to S x S are the host path's exactly
        (the train crop is then the identity); a larger one gets one centre
        crop here, which for val is the host path's crop and for train loses
        the per-epoch crop offset, with a warning."""
        size = self.cfg.input_size
        staged = np.empty((len(ds), size, size, 3), np.uint8)
        t0 = time.perf_counter()
        n_cropped = 0
        for i in range(len(ds)):
            arr = loader._decode_full(i)
            if arr.shape[:2] != (size, size):
                n_cropped += 1
                arr = square_crop(arr, size)
            staged[i] = arr
        if n_cropped and tag == "train":
            print(f"WARNING: {n_cropped}/{len(ds)} train images were larger than "
                  f"{size}x{size}; device_resident staged a fixed center crop — "
                  "per-epoch crop translation is lost for those images")
        out = torch.from_numpy(staged).to(self.device)
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
        self.staging_seconds[tag] = time.perf_counter() - t0
        print(f"device-resident staging: {len(ds)} {tag} images "
              f"({staged.nbytes / 1e9:.2f} GB uint8) decoded + uploaded in "
              f"{self.staging_seconds[tag]:.1f}s", flush=True)
        return out

    def step_generator(self, chunk: Optional[int] = None) -> torch.Generator:
        """The generator of this step's draws, seeded from
        ``(cfg.seed, global_step)``, or of a microbatch chunk's coins and
        dropout, seeded from ``(cfg.seed, global_step, chunk)``."""
        key = [self.cfg.seed, 0x5A7, self.global_step] + ([] if chunk is None else [chunk])
        seed = np.random.SeedSequence(key)
        return torch.Generator(self.device).manual_seed(
            int(seed.generate_state(1, np.uint64)[0]))

    def train_step(self, batch: Batch) -> Dict[str, torch.Tensor]:
        """One step on ``batch``: augment, forward and backward (by
        microbatch chunks where set), clip and update (with ``accumulate``,
        only on every k-th step, on the mean of the k gradients); returns
        its metrics as 0-d tensors on the device (``loss``, ``ce_loss``,
        ``att_loss``, ``accuracy``) without waiting for them: on a mesh,
        ``batch`` holds this rank's rows and the metrics are the global
        batch's."""
        cfg = self.cfg
        lrs = self.scheduler.current_lrs(self.global_step)
        train_encoder = (self.encoder_on
                         and self.global_step >= cfg.encoder_finetune_after)
        if not train_encoder:
            lrs = dict(lrs, encoder=0.0)
        epsilon = teacher_forcing_epsilon(cfg, self.current_epoch)
        gen = self.step_generator()
        if "image_idx" in batch:
            idx = torch.as_tensor(batch["image_idx"]).to(self.device)
            images = self._staged_images.index_select(0, idx)
        else:
            images = torch.as_tensor(batch["images"]).to(self.device)
        caps, lens = (torch.as_tensor(batch[k]).to(self.device)
                      for k in ("captions", "lengths"))

        images = self.augment(gen, images)
        mb, b = cfg.microbatch // self.mesh.size, caps.shape[0]
        if not (mb and 0 < mb < b and b % mb == 0):
            metrics = self._forward(images, caps, lens, epsilon, gen, train_encoder)
            metrics["loss"].backward()
        else:
            metrics = self._chunked_backward(images, caps, lens, epsilon,
                                             train_encoder, mb)
        metrics = self._global(metrics)
        self.mesh.reduce_gradients(self.model.named_parameters(), self.vocab_sharded)
        if self.multisteps is None or self.multisteps.add(self.model.named_parameters()):
            clip_gradients(cfg, self.model.parameters(), self.mesh, self._sliced())
            apply_group_lrs(self.optimizer, lrs)
            step(self.optimizer)
        self.model.zero_grad(set_to_none=True)

        self.scheduler.on_train_batch_end(self.global_step)
        self.global_step += 1
        return {k: v.detach() for k, v in metrics.items()}

    def _global(self, shares: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The global batch's metrics from every rank's shares (one sum)."""
        keys = sorted(shares)
        total = self.mesh.sum(torch.stack([shares[k].detach() for k in keys]))
        return dict(zip(keys, total))

    def _sliced(self) -> List[torch.Tensor]:
        """The parameters that hold vocab TP slices."""
        if not self.vocab_sharded:
            return []
        return [p for n, p in self.model.named_parameters()
                if self.mesh.is_vocab_leaf(n.split("."), p)]

    def _forward(self, images: torch.Tensor, caps: torch.Tensor, lens: torch.Tensor,
                 epsilon: float, gen: torch.Generator, train_encoder: bool
                 ) -> Dict[str, torch.Tensor]:
        """The encoder and the grouped loss, on the weights cast to the
        step's type: the encoder without autograd while frozen, in eval mode
        there with ``frozen_encoder_eval``."""
        cfg = self.cfg
        with cast_weights(self.model, self.compute_dtype):
            if not train_encoder and cfg.frozen_encoder_eval:
                annots = self.model.encode(images)     # eval mode, running stats
            else:
                with torch.set_grad_enabled(train_encoder):
                    annots = self.model.encode(images, train=True, mesh=self.mesh)
            return train_forward_loss_grouped(self.model.decoder, cfg, annots, caps,
                                              lens, epsilon, gen, self.mesh)

    def _chunked_backward(self, images: torch.Tensor, caps: torch.Tensor,
                          lens: torch.Tensor, epsilon: float, train_encoder: bool,
                          mb: int) -> Dict[str, torch.Tensor]:
        """One forward and backward per chunk of ``mb`` rows, the gradients
        summed: chunk i's objective is its CE times its share of the batch's
        target tokens plus ``att_gamma`` times its attention term over the
        number of chunks; the metrics are the whole batch's (on a mesh, this
        rank's shares of them; chunk i is every rank's chunk i)."""
        cfg = self.cfg
        nchunks, num_steps = caps.shape[0] // mb, caps.shape[2] - 1
        valid = lambda ln: torch.clamp(self.mesh.sum(ln.clamp(0, num_steps).sum().float()),
                                       min=1.0)
        total_valid = valid(lens)
        rows = []
        for i in range(nchunks):
            sl = slice(i * mb, (i + 1) * mb)
            n_valid = valid(lens[sl])
            m = self._forward(images[sl], caps[sl], lens[sl], epsilon,
                              self.step_generator(chunk=i), train_encoder)
            (m["ce_loss"] * (n_valid / total_valid)
             + cfg.att_gamma * m["att_loss"] * (1.0 / nchunks)).backward()
            rows.append(torch.stack([m["ce_loss"] * n_valid, m["accuracy"] * n_valid,
                                     m["att_loss"]]).detach())
        rows = torch.stack(rows)
        ce, acc = rows[:, 0].sum() / total_valid, rows[:, 1].sum() / total_valid
        att = rows[:, 2].mean()
        return {"loss": ce + cfg.att_gamma * att, "ce_loss": ce, "att_loss": att,
                "accuracy": acc}

    def _n_updates(self) -> int:
        """The optimizer's updates so far (Adam's ``count``)."""
        return self.global_step if self.multisteps is None else self.multisteps.gradient_step

    def _flush(self, pending: List, epsilon: float, timer: StepTimer,
               rows: List[Dict[str, float]]) -> None:
        """Fetch the buffered steps' metrics at once; log each step with its
        own number, with ``epsilon_tf`` and, from the second fetch on,
        ``images_per_sec``."""
        if not pending:
            return
        keys = sorted(pending[0][0])
        table = torch.stack([torch.stack([m[k] for k in keys])
                             for m, _, _ in pending]).cpu().numpy()
        timer.tick(sum(n for _, _, n in pending))
        rate = timer.images_per_sec
        for (_, gs, _), vals in zip(pending, table):
            host = dict(zip(keys, (float(v) for v in vals)))
            host["epsilon_tf"] = float(epsilon)
            if rate:
                host["images_per_sec"] = rate
            if self.logger is not None:
                self.logger.train_step(host, gs)
            rows.append(host)
        pending.clear()

    def _staged_batch(self, idxs: List[int]) -> Dict[str, np.ndarray]:
        """The loader's batch ``idxs`` with dataset indices for pixels."""
        caps, lens = self.train_loader.captions_of(idxs)
        return {"image_idx": np.asarray(idxs, np.int64), "captions": caps, "lengths": lens}

    def train_epoch(self, batches: Optional[Iterable[Batch]] = None,
                    max_batches: Optional[int] = None) -> Dict[str, float]:
        """One epoch, stopping after ``max_batches`` steps where given;
        returns each logged metric's mean over the epoch's steps, then runs
        the scheduler's epoch hook and logs the epoch's means and the
        decoder's LR.

        ``batches=None`` takes the train loader at ``current_epoch``, whose
        counter ``fit`` keeps, as in JAX (with staged data its plan); a
        caller who hands its own
        batches drives the epochs through this call, which then advances
        ``current_epoch``.  ``last_train_timings`` holds the epoch's host
        seconds, its images, and the seconds spent waiting on the batches."""
        cfg = self.cfg
        own = batches is None
        if own:
            self.train_loader.set_epoch(self.current_epoch, self._resume_skip_batches)
            self._resume_skip_batches = 0
            batches = (map(self._staged_batch, (idxs for idxs, _, _ in self.train_loader.batch_plans()))
                       if self._staged_images is not None else self.train_loader)
        epsilon = teacher_forcing_epsilon(cfg, self.current_epoch)
        timer, pending, rows = StepTimer(), [], []
        flush_n = max(1, cfg.log_every)
        wait, images, done = 0.0, 0, 0
        t_start = time.perf_counter()
        it = iter(batches)
        while max_batches is None or done < max_batches:
            t0 = time.perf_counter()
            batch = next(it, None)
            wait += time.perf_counter() - t0
            if batch is None:
                break
            lr_dec = self.scheduler.current_lrs(self.global_step)["decoder"]
            n = len(batch["lengths"])
            pending.append((self.train_step(batch), self.global_step - 1, n))
            done, images = done + 1, images + n
            if len(pending) >= flush_n:
                self._flush(pending, epsilon, timer, rows)
            if self.restart_ckpt is not None:
                self.restart_ckpt.on_train_batch_end(
                    cfg, self._checkpoint_tree, self.global_step, lr_dec)
        if hasattr(it, "close"):
            it.close()
        self._flush(pending, epsilon, timer, rows)
        means = self._end_epoch(rows)
        self.last_train_timings = {"seconds": time.perf_counter() - t_start,
                                   "images": images, "data_wait": wait}
        if not own:
            self.current_epoch += 1
        return means

    def _end_epoch(self, rows: List[Dict[str, float]]) -> Dict[str, float]:
        """The epoch's means; the scheduler's epoch hook; the epoch's log."""
        means = {k: float(np.mean([r[k] for r in rows])) for k in rows[0]} if rows else {}
        self.scheduler.on_train_epoch_end(self.current_epoch)
        if self.logger is not None:
            self.logger.train_epoch(
                means, self.current_epoch,
                lr=self.scheduler.current_lrs(self.global_step)["decoder"])
        return means

    def _checkpoint_tree(self) -> Dict[str, Any]:
        """The checkpoint tree in JAX's layout, ``opt_state`` included;
        under vocab TP the slices gathered to the full tables (a collective:
        every rank calls)."""
        tree = model_to_jax_tree(self.model)
        opt_state = optax_state_dict(self.cfg, self.model, self.optimizer,
                                     self._n_updates(), self.multisteps)
        if self.vocab_sharded:
            tree["params"] = gather_tree(tree["params"], self.mesh)
            opt_state = gather_tree(opt_state, self.mesh)
        tree.update(
            opt_state=opt_state,
            step=self.global_step, epoch=self.current_epoch,
            scheduler=dict(self.scheduler.state_dict()),
            early_stop={"best": (self.early_stop_best
                                 if self.early_stop_best is not None
                                 else float("-inf")),
                        "count": self.early_stop_count},
            top_k=self.ckpt.state_dict() if self.ckpt is not None else {})
        return tree

    def validate(self) -> Dict[str, float]:
        """Decode ``val_percent`` of the val batches, score them, and take
        each metric's mean over the batches; then log them, run the plateau
        scheduler, the top-k / last checkpoint and early stopping.
        ``last_val_timings`` holds the seconds of each part.  On a mesh each
        rank decodes its rows, the results and references are gathered, and
        every rank scores the whole batch with the full embedding."""
        cfg = self.cfg
        if not self._route_reported:
            print(f"decode route: {self.model.decode_route()}", file=sys.stderr)
            self._route_reported = True
        limit = max(1, int(round(cfg.val_percent * len(self.val_loader))))
        tm = {"data": 0.0, "decode_fetch": 0.0, "score": 0.0}
        embedding = self.mesh.full_table(self.model.decoder.embedding.detach(), 0) \
            if self.vocab_sharded else self.model.decoder.embedding.detach()
        embedding = embedding.cpu().numpy()
        self.val_loader.set_epoch(self.current_epoch)
        batch_metrics = []
        if self._staged_val_images is None:
            batches = itertools.islice(iter(self.val_loader), limit)
        else:
            # pixels from the staged split; scoring reads the refs from the dataset
            ds = self.val_ds
            batches = ({"image_idx": idxs, "captions": ds.encoded_captions[idxs],
                        "lengths": ds.lengths[idxs]}
                       for idxs, _, _ in self.val_loader.batch_plans()[:limit])
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            tm["data"] += time.perf_counter() - t0
            if batch is None:
                break
            t0 = time.perf_counter()
            images = (batch["images"] if "images" in batch else self._staged_val_images[
                torch.as_tensor(batch["image_idx"], device=self.device)])
            res = _fetch_without_alphas(val_decode(self.model, cfg, images, self.mesh),
                                        self.mesh)
            refs = [self.mesh.fetch_global(torch.as_tensor(np.asarray(batch[k]))).numpy()
                    for k in ("captions", "lengths")]
            tm["decode_fetch"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            caps, _, _, ppl = unpack_beam_result(res, self.model.grid_hw)
            batch_metrics.append(score_captions(
                caps, *refs, embedding=embedding, perplexities=ppl))
            tm["score"] += time.perf_counter() - t0
        means = {k: float(np.mean([m[k] for m in batch_metrics]))
                 for k in batch_metrics[0]} if batch_metrics else {}
        self.logger.val_epoch(means, self.current_epoch)
        if cfg.plateau_monitor in means:
            self.scheduler.on_validation_end(means[cfg.plateau_monitor],
                                             self.global_step)
        t0 = time.perf_counter()
        self.ckpt.on_validation_end(cfg, self._checkpoint_tree, means,
                                    self.current_epoch, self.global_step)
        tm["ckpt"] = time.perf_counter() - t0
        self.last_val_timings = tm
        if cfg.early_stop_monitor is not None:
            v = means.get(cfg.early_stop_monitor, float("-inf"))
            if self.early_stop_best is None or v > self.early_stop_best:
                self.early_stop_best = v
                self.early_stop_count = 0
            else:
                self.early_stop_count += 1
                if self.early_stop_count >= cfg.early_stop_patience:
                    self.should_stop = True
        return means

    def fit(self) -> Dict[str, float]:
        """Train ``cfg.epochs`` epochs over the loader, validating every
        ``val_interval`` epochs, until early stopping; then write
        ``last.ckpt``.  Returns the last validation's means.
        ``epoch_timings`` gets one entry per epoch.  With ``profile_dir``
        the first epoch's training (not its validation) is traced there."""
        last_val: Dict[str, float] = {}
        first_epoch = self.current_epoch
        for epoch in range(first_epoch, self.cfg.epochs):
            self.current_epoch = epoch
            t0 = time.perf_counter()
            with maybe_profile(self.cfg.profile_dir if epoch == first_epoch else None,
                               self.device):
                train_means = self.train_epoch()
            val_t = None
            if (epoch + 1) % self.cfg.val_interval == 0:
                last_val = self.validate()
                val_t = dict(self.last_val_timings)
            dt = time.perf_counter() - t0
            self.epoch_timings.append({"epoch": epoch, "seconds": dt,
                                       "train": dict(self.last_train_timings),
                                       "val": val_t})
            print(f"epoch {epoch}: loss={train_means.get('loss', float('nan')):.4f} "
                  f"acc={train_means.get('accuracy', 0):.4f} "
                  f"bleu4={last_val.get('bleu4', 0):.4f} ({dt:.1f}s)")
            if self.should_stop:
                break
        tree = self._checkpoint_tree()
        if self.is_main:
            save_checkpoint(os.path.join(self.logdir, "last.ckpt"), self.cfg, tree)
        self.logger.close()
        return last_val
