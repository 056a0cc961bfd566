#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (sat_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (nonzero exit, no result line):

1. device: require CUDA; print the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives them;
2. build both CUDA sources from ``sat_tpu_torch/csrc`` (all nvcc processes at
   once) and print the build time and, for what it compiled, each kernel
   instance's registers and spills (``nvcc -Xptxas=-v``; a spill in a phase
   kernel of either source fails the run), and both launch plans at B = 64
   (``[design]``: each kernel's grid, threads and shared memory; each tiled
   product must fill 64 blocks);
3. hold each kernel against its plain PyTorch version on the card, float32,
   n64 weights, B = 64, at the shapes of the main path, then at other shapes
   that take the kernels' other code paths (B = 192 and 300 at n64, the
   golden checkpoint's narrow widths at B = 13, and the step in bfloat16);
4. greedy path: load the n64 checkpoint, encode 64 seeded 224 px images,
   greedy captioning through the loop kernel (default), the step kernel
   (``fused=True``) and the plain path (``fused=False``), with launch counts
   read around that run, captions, and agreement with the CPU;
5. beam path, the one users run: ``SATModel.caption`` at beamk 3, LN,
   f32, whose ``beam_search`` takes the step kernels at B k = 192 rows by
   default, with launch counts read around that run; ``beam_search`` with
   the kernels and with ``fused=False`` (result shapes, finite scores, best
   captions equal on >= 99 % of images, the first 4 equal to the CPU run's);
6. both paths in bfloat16, beam search at the serving setting (beamk 3, LN,
   early exit) (token agreement with float32 printed, not asserted);
7. times, with CUDA events after a warm-up, the median of several runs: each
   kernel and its plain version per call (the ``kernels`` line: the step at
   the beam path's 192 rows), and greedy and beam captioning end to end
   (encode + decode, images/s); beside them the busy device time per call
   from torch.profiler, each loop phase's busy time per decode and each step
   kernel's busy time per call at 64 and 192 rows;
8. training at the n64 configuration (the checkpoint header's settings at
   float32): (a) three ``Trainer.train_step`` calls (SGD, no momentum,
   epsilon 1, no augmentation, no dropout) from the checkpoint's weights on
   the card and on the CPU, whose losses, decoder parameters and BatchNorm
   statistics must agree; (b) 30 steps of the n64 settings (Adam, the norm
   clip, label smoothing, inverse-sigmoid teacher forcing, crop and noise,
   frozen encoder with train-mode BatchNorm) from ``SATModel.create`` on one
   fixed batch of 64 seeded scenes with random captions, whose loss must
   fall by 10 %; (c) ``model.caption`` with those weights, step kernels
   against the plain path; (d) three steps with the encoder finetuned from
   step 2; (e) each step's time (CUDA events), its busy device time split
   by part of the step (one profiler window), and the peak memory;
9. ``fit`` at the n64 configuration (the header's settings at float32 on
   the dataset below, decoded by the loader's default route: the C++ pool
   of ``sat_tpu_torch/native`` where it builds, else PIL; the route is
   printed): (a) the port's ``make_compositional_dataset`` writes
   512 / 128 / 8 images of the 64-noun grammar, whose vocabulary must be
   the checkpoint's; two passes of each loader (identical val batches, the
   cached second train pass decoding nothing); (b) ``Trainer.validate``
   with the checkpoint's weights over the whole val split (beam search,
   the step kernels, counted), whose BLEU-4 must be within 0.01 of the JAX
   package's float32 value on this split, and 15 of the first 16 val
   images' best captions equal to the CPU's; (c) the top-k and
   ``last.ckpt`` files it wrote, ``last.ckpt`` read back bit for bit and
   captioning as the model in memory; (d) the training CLI's ``main``
   (3 epochs, half the val batches), whose epoch-3 loss must be at most
   0.9 of epoch 1's, with ``last.ckpt`` at step 24, one top-k file and the
   logged points in the logger's files; (e) each epoch's times and one
   profiler window over epoch 2's train steps;
10. serving and evaluation at the n64 configuration, through the CLIs'
   ``main``, with whether the C++ decode pool built on this machine, its
   threads, and each run's decode route (the pool by default where it
   builds, else PIL, as the JAX package's serve does): (a) ``serve`` at f32
   (batch 64, beamk 3, LN) on 256 JPEGs of
   seeded scenes at 256 x 320 and one file that is not an image: 257
   records in path order, one error record, the step kernels counted, the
   first 16 records equal to the CPU's run through the same route
   (captions, scores and perplexities within 1e-4); (b) ``serve`` at its
   default bf16: 257
   records, finite scores, the share of captions equal to (a)'s (not
   gated); (c) the checkpoint written as a reference Lightning ``.ckpt`` by
   the port's exporter reads back bit for bit and serves (a)'s records;
   (d) ``evalx.evaluate`` on phase 9's val split, BLEU-1..4 and GLEU within
   0.01 of the JAX package's, the step kernels counted; (e)
   ``evalx.temperature`` within 1e-3 of JAX's T; (f) serve's images/s at
   f32 and bf16 (median of 3, JPEG decode included, with the host decode
   seconds) by the default route and, where the pool builds, again with
   it switched off (``native.shared_pool`` giving None), busy ms and idle share from one
   profiler window, and evaluate's seconds split into data, decode and
   score;
11. resume at the n64 configuration, on phase 9's dataset and header (2
   epochs of 8 steps, validation at each epoch's end as the header sets
   it): (a) the training CLI straight; (b) one epoch, whose validation
   writes ``last.ckpt``, then ``--resume last.ckpt --epochs 2`` through
   the CLI's ``main``; (c) 3 batches into epoch 2, a ``restart-11.ckpt``
   written by ``RestartCheckpointManager``, and ``Trainer`` resumed from it
   (the batches already trained skipped).  (b) and (c) must end at (a)'s
   step, epoch and LRs, their decoder weights and Adam moments within 1e-6
   of each tensor's largest magnitude (the largest gap and whether they are
   bit for bit are printed), the resumed validation must run the step
   kernels, and ``last.ckpt``'s ``opt_state`` must have optax's layout;
   the size of a checkpoint with ``opt_state`` and its write and read
   seconds are printed.

12. the trainer's settings at the n64 configuration, on phase 9's dataset
   and the checkpoint header's settings (which are bf16, staged data and
   64 steps per dispatch): (a) precision 16: three SGD steps at B = 8 from
   the checkpoint's weights on the card and on the CPU, whose losses and
   decoder weights must agree within ``BF16_LOSS_TOL`` / ``BF16_PARAM_TOL``,
   and whose losses must stand ``BF16_APART`` times that gap from the
   card's float32 steps' (so a step that ran float32 fails), the weights
   float32 throughout; 30 bf16 steps as phase 8 (b), whose loss must fall by 10 %;
   the bf16 step's ms, busy ms, idle share and peak memory beside phase 8
   (e)'s float32 step; (b) microbatch 16 at B = 64: with
   ``frozen_encoder_eval`` (SGD, no draws) three steps whose weights must be
   within 1e-5 of the full batch's; with train-mode BatchNorm the step's ms
   and peak memory, not gated; (c) accumulate 2 through the training CLI:
   a straight epoch, and a run stopped after step 3 (``opt_state`` must
   hold ``MultiSteps``' five keys, mid-accumulation) and resumed through
   ``--resume``, which must read the weights, ``acc_grads``, Adam moments
   and counters bit for bit and end bit for bit with the straight run;
   (d) ``device_resident_data`` at ``steps_per_dispatch`` 1 and 4, 2 epochs
   of 8 steps: the weights, the logged metrics and each validation's BLEU-4
   (from the staged pixels, the step kernels counted) equal to the host
   path's run; for the host path, 1 and 8 steps per dispatch, each epoch's
   wall s and training images/s, the idle share from a profiler window over
   epoch 2, and the staging seconds, not gated; (e) ``profile_dir``: the
   straight run of (c) writes one trace of its first epoch, which must list
   CUDA kernel events.

13. the ResNet configuration with the full augmentation: resnet50 at 224
   px, ``encoder_size`` 14 (the 7 x 7 map upsampled: L 196, D 2048), the
   default decoder widths, the header's settings with colour jitter 0.4 and
   optical strength 0.5, encoder weights from a seeded torchvision-layout
   state_dict written by the port's exporter (``--pretrained_weights``):
   (a) the nine ResNet-family encoders at B = 4 with seeded weights and
   BatchNorm statistics, eval and train mode, card against CPU (annotations
   within 1e-3 of their scale, running statistics within rtol 1e-3); both
   decode kernels against their plain versions at L 196, D 2048 and the
   reference's 4096-word vocabulary (a synthetic one): the step at N 64 and
   192, the loop at B 64, f32 and bf16, with both launch plans; (b) the
   augment (crop, flip, jitter, the three warps each on a third of the
   images, noise) on the card against the CPU on the CPU's draws, at f32,
   bf16 and bf16 without the warps; (c) three SGD steps at B = 8 card
   against CPU with the augment on the same draws (losses, decoder weights,
   BatchNorm statistics), then 30 steps at B = 64 on phase 9's first train
   batch, whose loss must fall by 10 %, the step's ms, busy ms by part and
   peak memory; (d) the
   training CLI for 2 epochs on phase 9's dataset, ``last.ckpt`` read back
   bit for bit, ``serve`` of it on phase 10's JPEGs with the first 16
   records equal to the CPU's, the checkpoint as a Lightning ``.ckpt`` read
   back bit for bit; the main path of the slice counted (greedy and beam
   captioning of the trained model); (e) encode, the step at N 192, the
   greedy loop, greedy and beam captioning, the augment with and without
   jitter and the warps: ms, busy ms and idle share, and both kernels'
   bounds at these shapes (two more entries of the ``kernels`` line).

14. ``BASELINE.json``'s first configuration: mobilenet_v3_small at 224 px,
   its native 7 x 7 map (L 49, D 576, no ``proj``), the default decoder
   widths, the header's settings at f32 with the encoder finetuned from
   step 1, encoder weights from a seeded torchvision-layout state_dict
   written by the port's exporter (``--pretrained_weights``): (a) the seven
   inverted-residual encoders (mobilenet_v2, mobilenet_v3_large/small,
   mnasnet0_5/0_75/1_0/1_3) at B = 4, eval and train mode, card against
   CPU as in 13 (a), and mobilenet_v3_small in bf16 (the model cast as
   ``serve`` casts it), card against CPU within 4 bf16 ulps of the largest
   value (the gap to the CPU's f32 printed); both decode kernels against their plain
   versions at L 49, D 576 and V 4096, the step at N 64 and 192 and the
   loop at B 64, f32 and bf16, and the step at N 192 at D 960
   (mobilenet_v3_large) and 1280 (mobilenet_v2), where the last 256-wide
   slice of ``attend`` is partial; (b) three SGD steps at B = 8 card
   against CPU (losses, decoder weights, BatchNorm statistics, and the
   encoder's update held against the CPU's float64 steps), then 30 steps at B = 64 on phase 9's first train batch, whose loss must
   fall by 10 %, the step's ms, busy ms by part and peak memory; (c) as
   13 (d): the CLI for 2 epochs, ``last.ckpt`` bit for bit, ``serve`` of
   it against the CPU, the Lightning ``.ckpt`` bit for bit, and the main
   path counted; (d) encode, the step at N 192, the greedy loop, greedy
   and beam captioning: ms, busy ms and idle share, and both kernels'
   bounds (two more entries of the ``kernels`` line).

15. the densenet121 configuration: densenet121 at 224 px, its native 7 x 7
   map (L 49, D 1024, no ``proj``), the default decoder widths, the
   header's settings at f32 with the encoder finetuned from step 1,
   encoder weights from a seeded torchvision-layout state_dict written by
   the port's exporter (``--pretrained_weights``); squeezenet1_1 (no
   BatchNorm, its native 13 x 13 map: L 169, D 512) beside it: (a) the six
   SqueezeNet and DenseNet encoders at B = 4, eval and train mode, card
   against CPU as in 13 (a), and densenet121 in bf16 as in 14 (a); both
   decode kernels against their plain versions at L 49, D 1024 and at L
   169, D 512 (V 4096), the step at N 64 and 192 and the loop at B 64, f32
   and bf16, and the step at N 192 at D 1664, 1920 and 2208 (densenet169,
   201, 161), where the last 256-wide slice of ``attend`` is partial; (b)
   as 14 (b) at densenet121; (c) as 14 (c) for densenet121 (2 epochs) and
   squeezenet1_1 (1 epoch: its empty ``batch_stats`` through the writer,
   the Lightning file and the serve), and a ``Trainer`` resumed from
   squeezenet1_1's ``last.ckpt`` with its weights bit for bit; the main
   path counted at both; (d) encode, the step at N 192, the greedy loop,
   greedy and beam captioning at both (four more entries of the
   ``kernels`` line); (e) ``python -m sat_tpu_torch.evalx.encoder_sweep``
   at its default bf16 over seven archs at batch 32 and 128, each row's
   features and attention equal to ``probe_encoder``'s and its rates finite
   and positive (the rates are printed, not gated).

``python3 chip_smoke.py --cpu-fit`` runs phase 9 (d) on the CPU and prints
its losses as JSON.

The last three lines of standard output are ``[report]`` with every number
of the run as JSON, the ``kernels`` JSON line and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(ROOT, "tests", "data", "best_n64_r4_serving.ckpt")
GOLDEN = os.path.join(ROOT, "tests", "data", "golden_v1.ckpt")
DEVICE = "cuda"
B, S = 64, 20
K_BEAM = 3     # beam width of the beam path (the serving default)
B_BEAM = B * K_BEAM   # beam search's B k rows: three 64-row tiles
B_WIDE = 300   # five 64-row tiles, more rows than an H100 has SMs
B_TRAIN, TRAIN_STEPS = 64, 30   # the n64 configuration's batch; steps of 8 (b)
B_TRAIN_CHECK = 8               # rows of the card-against-CPU steps, 8 (a)
# phase 9: the compositional split at 64 nouns, cut from 16,384 / 512 images
FIT_TRAIN, FIT_VAL, FIT_EPOCHS = 512, 128, 3
# JAX's float32 BLEU-4 of the n64 checkpoint on that val split (validate's
# decode: beamk 3, LN, early exit, 20 words), mean and per batch of 64
BLEU_JAX, BLEU_JAX_BATCHES = 0.2752, (0.2564, 0.2940)
# phase 10: JPEGs (quality 90) of seeded scenes, H x W, and one file that is
# not an image; the serving CLI's batch and beam
SERVE_N, SERVE_HW, SERVE_BATCH = 256, (256, 320), 64
# phase 11: epochs of the run that is interrupted and resumed, and the
# batches of its second epoch before the mid-epoch restart file
RESUME_EPOCHS, RESUME_MID = 2, 3
# JAX's values on phase 9's val split, from the JAX package's own CLIs on a
# CPU (the JSON's path is what the first command prints):
#   python -c "from sat_tpu.data.compositional import make_compositional_dataset as m;
#     print(m('n64', n_train=512, n_val=128, n_test=8, image_size=224, n_nouns=64, seed=0))"
#   JAX_PLATFORMS=cpu python -m sat_tpu.evalx.evaluate --checkpoint \
#     tests/data/best_n64_r4_serving.ckpt --json n64/compositional_64.json --split val \
#     --batch 64 --beamk 3 --max_gen_length 20
#   JAX_PLATFORMS=cpu python -m sat_tpu.evalx.temperature --checkpoint \
#     tests/data/best_n64_r4_serving.ckpt --json n64/compositional_64.json --split val \
#     --batch_size 16 --max_batches 8
EVAL_JAX = {"bleu1": 0.65975, "bleu2": 0.54325, "bleu3": 0.39089, "bleu4": 0.27459,
            "gleu": 0.3002}
TEMPERATURE_JAX = 0.7618
REFS, MAX_WORDS = 5, 18         # per image; the n64 header's max_cap_length
# phase 12 (a): bf16 steps, card against CPU, the largest gaps allowed (an
# H100 measured 1.8e-4 and 4.5e-5), both below the gaps of the card's bf16
# steps to its float32 ones (1.19e-3 and 1.25e-4), which must be at least
# BF16_APART times the loss's card-against-CPU gap: a step that ran float32
# on both sides agrees with the CPU and fails there
BF16_LOSS_TOL, BF16_PARAM_TOL, BF16_APART = 1e-3, 1e-4, 4
# host seconds a profiler window stays open before and after what it records,
# and the uncounted kernels (torch.cuda._sleep's) it opens with
PROFILER_PAD_S, PROFILER_HEAD = 0.05, 256
# phase 13: the ResNet configuration (224 px, the 7 x 7 map upsampled to
# encoder_size 14: L 196, D 2048), its augmentation, the encoders' batch,
# the augment check's batch, the reference's 4096-word vocabulary for the
# decode kernels, and the CLI's epochs on phase 9's dataset
RESNET_ARCH, RESNET_PX, RESNET_SIZE = "resnet50", 224, 14
AUG_JITTER, AUG_OPTICAL = 0.4, 0.5
B_ENC, AUG_B, V_REF, RESNET_EPOCHS = 4, 16, 4096, 2
# phase 14: BASELINE.json's first configuration (mobilenet_v3_small at 224
# px, its native 7 x 7 map: L 49, D 576), the seven inverted-residual
# encoders, the step kernels' other widths (D 960, 1280) and the CLI's epochs
MOBILE_ARCH, MOBILE_PX, MOBILE_D, MOBILE_EPOCHS = "mobilenet_v3_small", 224, 576, 2
MOBILE_ARCHS = ("mobilenet_v2", "mobilenet_v3_large", "mobilenet_v3_small", "mnasnet0_5",
                "mnasnet0_75", "mnasnet1_0", "mnasnet1_3")
MOBILE_WIDE = (("mobilenet_v3_large", 960), ("mobilenet_v2", 1280))
# phase 15: the densenet121 configuration (224 px, its native 7 x 7 map: L 49,
# D 1024), squeezenet1_1's native 13 x 13 map (L 169, D 512), the six
# encoders, the step kernels' other widths (D 1664, 1920, 2208), the CLI's
# epochs, and the encoder sweep's archs and batches
DENSE_ARCH, DENSE_PX, DENSE_D, DENSE_EPOCHS = "densenet121", 224, 1024, 2
SQUEEZE_ARCH, SQUEEZE_D = "squeezenet1_1", 512
DENSE_ARCHS = ("squeezenet1_0", "squeezenet1_1", "densenet121", "densenet169",
               "densenet201", "densenet161")
DENSE_WIDE = (("densenet169", 1664), ("densenet201", 1920), ("densenet161", 2208))
SWEEP_ARCHS = ("shufflenet_v2_x0_5", "mobilenet_v3_small", "squeezenet1_1", "resnet18",
               "resnet50", "densenet121", "wide_resnet50_2")
SWEEP_BATCHES = (32, 128)
TRAIN_PARTS = ("input copy", "augment", "encoder", "decoder forward",
               "backward", "optimizer")

# published peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}

# colour, shape and texture of the n64 checkpoint's training scenes (one
# colour, 8 shapes x 8 stripe textures on a grey 3x3 grid)
_RED = np.array((200, 40, 40), np.float32)


def _shape_mask(shape, r):
    y, x = np.mgrid[-r:r, -r:r] + 0.5
    rr = np.hypot(x, y)
    return [rr < r, np.maximum(abs(x), abs(y)) < r * 0.82,
            (y < r * 0.55) & (abs(x) < (y + r) * 0.55), abs(x) + abs(y) < r * 1.05,
            (rr < r) & (rr > r * 0.55), (abs(x) < r * 0.3) | (abs(y) < r * 0.3),
            abs(y) < r * 0.35, abs(x) < r * 0.35][shape]


def scenes(n, size=224, seed=0):
    """n seeded images (n, size, size, 3) in [0, 1]: one or two striped
    shapes in the cells of a 3x3 grid, grey background, pixel noise."""
    rng = np.random.default_rng(seed)
    cell = size // 3
    out = np.empty((n, size, size, 3), np.float32)
    for i in range(n):
        img = np.full((size, size, 3), 105, np.float32)
        for c in rng.choice(9, size=int(rng.integers(1, 3)), replace=False):
            r = max(2, min(int(cell * (0.22, 0.42)[rng.integers(0, 2)]), cell // 2 - 1))
            cy, cx = (c // 3) * cell + cell // 2, (c % 3) * cell + cell // 2
            jit = cell // 2 - r - 1
            if jit > 0:
                cy += int(rng.integers(-jit, jit + 1))
                cx += int(rng.integers(-jit, jit + 1))
            tex = int(rng.integers(0, 8))
            y, x = np.mgrid[-r:r, -r:r] + 0.5
            ang, freq = (tex % 4) * np.pi / 4, (1.6 if tex < 4 else 3.6) * np.pi / r
            field = 0.775 + 0.225 * np.sign(np.sin((x * np.cos(ang) + y * np.sin(ang)) * freq))
            mask = _shape_mask(int(rng.integers(0, 8)), r)
            patch = img[cy - r:cy + r, cx - r:cx + r]
            patch[mask] = (field[..., None] * _RED)[mask]
        img += rng.normal(0, 6.0, img.shape)
        out[i] = np.clip(img, 0, 255).astype(np.uint8) / 255.0
    return out


def caption_batch(vocab, n, seed):
    """n seeded images (uint8) with REFS random captions each over the
    vocabulary's non-special words: 4 to MAX_WORDS words, then <END>, in
    rows of T = MAX_WORDS + 2 (<START> first); lengths count the targets."""
    rng = np.random.default_rng(seed)
    special = {vocab.pad_idx, vocab.unk_idx, vocab.start_idx, vocab.end_idx}
    words = np.array([i for i in range(vocab.size) if i not in special])
    caps = np.full((n, REFS, MAX_WORDS + 2), vocab.pad_idx, np.int64)
    caps[..., 0] = vocab.start_idx
    lens = rng.integers(4, MAX_WORDS + 1, size=(n, REFS)) + 1
    for i in range(n):
        for r in range(REFS):
            k = lens[i, r] - 1
            caps[i, r, 1:k + 1] = rng.choice(words, k)
            caps[i, r, k + 1] = vocab.end_idx
    images = np.rint(scenes(n, 224, seed) * 255).astype(np.uint8)
    return {"images": images, "captions": caps, "lengths": lens}


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, calls=1, warmup=3, reps=10):
    """Milliseconds per call of fn(): CUDA events around ``calls`` calls in a
    row, after ``warmup`` calls; the median over ``reps`` such runs."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def host_ms(fn, calls=20, reps=5):
    """Milliseconds of host time per call of fn(), not waiting for the
    device: what the wrapper costs the host (checks, allocations,
    launches).  The median over ``reps`` runs of ``calls`` calls."""
    import torch
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


@contextlib.contextmanager
def device_window():
    """A ``torch.profiler`` window of device activity around the block, open
    ``PROFILER_PAD_S`` before it and after it (the block ends with a
    synchronize), whose first kernels are ``PROFILER_HEAD`` uncounted ones:
    a window whose own start or stop stalls can lose the kernels nearest
    its ends, and on an H100 windows over a few bf16 train steps now and
    then lost some of their first records (``profiler_windows.py``).  Read
    it with ``window_events``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILER_PAD_S)
        for _ in range(PROFILER_HEAD):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        yield prof
        time.sleep(PROFILER_PAD_S)


def window_events(prof, head=False):
    """The device events of a ``device_window`` in time order, without its
    uncounted head kernels (with them for ``head``)."""
    from torch.autograd import DeviceType
    return sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                   and (head or "spin_kernel" not in e.name)),
                  key=lambda e: e.time_range.start)


def device_times(fn, calls=10):
    """Busy device time per call of each kernel fn launches, in ms by kernel
    name, from one torch.profiler (CUPTI) window of ``calls`` calls; host
    gaps between launches are not counted.  Device activity only: host
    operations are not recorded (a beam decode runs thousands)."""
    import torch
    fn()
    torch.cuda.synchronize()
    with device_window() as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in window_events(prof):
        out[e.name] = out.get(e.name, 0.0) + e.device_time_total / calls / 1e3
    return out


def busy_of(times, name=None):
    """The busy ms of the kernels in ``times`` whose name contains ``name``
    (all of them for None); None where the profiler recorded none."""
    total = sum(ms for k, ms in times.items() if name is None or name in k)
    return total if total > 0 else None


def device_ms(fn, name=None, calls=10):
    """Busy device time per call of the kernels whose name contains
    ``name``, or of every kernel fn launches (``device_times``)."""
    return busy_of(device_times(fn, calls), name)


def marked_step_events(trainer, batch, steps=3, head=False):
    """The device events, in time order, of one torch.profiler window
    (``device_window``, device activity only) over ``steps`` calls of
    ``trainer.train_step`` after one outside it, with a one-element XOR on
    the stream (``is_mark``) where each part of a step starts (TRAIN_PARTS):
    wrappers around the trainer's augment, encode, loss, clip and update
    launch it, 6 marks per step.  ``head`` keeps the window's head kernels."""
    import torch
    from sat_tpu_torch.train import loop

    flag = torch.zeros(1, dtype=torch.int16, device=trainer.device)
    mark = lambda: flag.bitwise_xor_(1)          # no step runs an XOR

    def marked(fn, before=True, after=False):
        def wrapped(*a, **k):
            if before:
                mark()
            out = fn(*a, **k)
            if after:
                mark()
            return out
        return wrapped

    saved = (trainer.augment, loop.train_forward_loss_grouped,
             loop.clip_gradients, loop.step)
    trainer.augment = marked(trainer.augment)
    trainer.model.encode = marked(type(trainer.model).encode.__get__(trainer.model))
    loop.train_forward_loss_grouped = marked(saved[1], after=True)
    loop.clip_gradients = marked(saved[2])
    loop.step = marked(saved[3], before=False, after=True)
    try:
        trainer.train_step(batch)
        torch.cuda.synchronize()
        with device_window() as prof:
            for _ in range(steps):
                trainer.train_step(batch)
            torch.cuda.synchronize()
    finally:
        (trainer.augment, loop.train_forward_loss_grouped,
         loop.clip_gradients, loop.step) = saved
        del trainer.model.encode
    return window_events(prof, head)


def is_mark(event):
    return "xor" in event.name.lower()


def train_busy(trainer, batch, steps=3):
    """Busy device ms per train step, in all and per part of the step
    (TRAIN_PARTS), from ``marked_step_events``; the run fails where the
    profiler shows another count of marks than 6 per step."""
    events = marked_step_events(trainer, batch, steps)
    total = sum(e.device_time_total for e in events
                if not is_mark(e)) / steps / 1e3
    parts, part = dict.fromkeys(TRAIN_PARTS, 0.0), 0
    marks = 0
    for e in events:
        if is_mark(e):
            marks += 1
            part = marks % 6       # augment, encoder, forward, backward, optimizer, end
        else:
            parts[TRAIN_PARTS[part]] += e.device_time_total / steps / 1e3
    check(marks == 6 * steps, f"train (e): {marks} part marks in {steps} steps, "
          f"not {6 * steps}: a marked function of the train step was renamed")
    return total, parts


def ptxas_summary(log):
    """One (kernel, type, registers, spill line) per kernel instance of an
    ``nvcc -Xptxas=-v`` log; the type is the template argument."""
    out, inst, spill = [], ("?", "?"), ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"_ZN3sat\d+(\w+?)I(f|13__nv_bfloat16)E", line)
            inst = (m.group(1), "f32" if m.group(2) == "f" else "bf16") if m else ("?", "?")
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line:
            out.append((*inst, line.split(":", 1)[1].strip(), spill))
    return out


def spilled(spill_line):
    """Whether a ptxas ``... bytes spill stores, ... bytes spill loads`` line
    reports a spill."""
    return any(int(n) for n in re.findall(r"(\d+) bytes spill", spill_line))


def check(ok, what):
    """A failed check ends the run: nonzero exit, no result line."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def step_flops(L, D, A, H, E):
    """Multiply-adds x 2 of one decode step for one row (GEMVs, attention)."""
    return 2 * (H * A + L * A + L * D + H * D + (E + D + H) * 4 * H + H * E + D * E)


def bound(nbytes_moved, ops, dtype_name):
    t_bytes = nbytes_moved / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def agreement(a, b):
    """Rows whose tokens and lengths are identical, as a boolean mask."""
    return ((a.tokens[:, 0] == b.tokens[:, 0]).all(-1)
            & (a.lengths[:, 0] == b.lengths[:, 0]))


def same_share(a, b):
    """The share of images whose best captions are equal."""
    return sum(x == y for x, y in zip(a, b)) / len(a)


def max_rel_err(got, ref):
    """Max over the leaves of a state dict of max |got - ref| over the
    leaf's own scale (its max |ref|)."""
    out = {}
    for k, r in ref.items():
        if r.is_floating_point() and r.numel():
            r = r.double().cpu()
            out[k] = ((got[k].double().cpu() - r).abs().max()
                      / r.abs().max().clamp(min=1e-30)).item()
    return out


def bn_stats_err(got, ref, rtol=1e-4):
    """The BatchNorm running statistics of encoder ``got`` against ``ref``,
    each channel held at ``rtol``: a variance against the variance, a mean
    against the larger of its magnitude and its channel's standard
    deviation (the floor keeps means that are near zero, next to their
    spread, from dividing summation-order noise by almost nothing).
    Returns {"var"/"mean"/"mean_plain": the worst channel's error over its
    tolerance, or over ``rtol * |ref|`` for "mean_plain", with its leaf,
    channel, reference mean, standard deviation and difference}."""
    import torch
    from torch import nn
    refs = dict(ref.named_modules())
    worst = {}

    def keep(key, err, name, ch, mean, std, diff):
        if key not in worst or err > worst[key]["err"]:
            worst[key] = {"err": err, "leaf": name, "channel": ch, "ref_mean": mean,
                          "std": std, "diff": diff}

    for name, m in got.named_modules():
        if isinstance(m, nn.BatchNorm2d):
            r = refs[name]
            rm, rv = r.running_mean.double().cpu(), r.running_var.double().cpu()
            dm = (m.running_mean.double().cpu() - rm).abs()
            dv = (m.running_var.double().cpu() - rv).abs()
            std = rv.sqrt()
            tiny = torch.finfo(torch.float64).tiny
            for key, err, d in (
                    ("var", dv / (rtol * rv.abs()).clamp(min=tiny), dv),
                    ("mean", dm / (rtol * torch.maximum(rm.abs(), std)).clamp(min=tiny), dm),
                    ("mean_plain", dm / (rtol * rm.abs()).clamp(min=tiny), dm)):
                ch = int(err.argmax())
                keep(key, err[ch].item(), name, ch, rm[ch].item(), std[ch].item(),
                     d[ch].item())
    return worst


def check_step(label, args, rel=1e-4):
    """The step kernels against their plain version on ``args``: each
    output within ``rel`` of its own scale.  Returns the outputs and each
    one's max abs error."""
    import torch
    from sat_tpu_torch.kernels import decoder_step as KS
    got = KS.fused_decoder_step(*args)
    ref = KS.fused_decoder_step_plain(*args)
    torch.cuda.synchronize()
    errs = {}
    for name, g, r in zip(("t", "h", "c", "z", "alpha"), got, ref):
        check(g.shape == r.shape and torch.isfinite(g).all(),
              f"{label}: decoder_step {name} shape and finite values")
        err = (g.float() - r.float()).abs().max().item()
        tol = rel * max(1.0, r.float().abs().max().item())
        check(err <= tol, f"{label}: decoder_step {name}: {err} > {tol}")
        errs[name] = err
    print(f"[check] decoder_step kernels vs plain, {label}: max abs err "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()), flush=True)
    return got, errs


def check_loop(label, la, bf16=False):
    """The loop kernels against their plain version on ``la``: tokens and
    lengths equal on >= 99 % of rows at float32 (>= 90 % at bf16, where one
    rounding of a near tie changes a row's path), and on those rows scores
    and attention weights within 1e-3 (1e-1 at bf16: the scores sum up to
    S + 1 log-probs of logits reaching ~30; alphas are in [0, 1]).  Returns
    (agreement, max abs error, the kernel's outputs)."""
    import torch
    from sat_tpu_torch.kernels import greedy_loop as KL
    k = KL.greedy_loop(*la, max_gen_length=S)
    p = KL.greedy_loop_plain(*la, max_gen_length=S)
    torch.cuda.synchronize()
    same = (k[0] == p[0]).all(-1) & (k[3] == p[3]) & (k[4] == p[4])
    rate = same.float().mean().item()
    check(rate >= (0.9 if bf16 else 0.99), f"{label}: greedy_loop tokens agree on {rate:.3f}")
    err = max((k[2] - p[2])[same].abs().max().item(), (k[1] - p[1])[same].abs().max().item())
    check(err <= (1e-1 if bf16 else 1e-3), f"{label}: greedy_loop scores/alphas differ by {err}")
    check(torch.isfinite(k[1]).all() and torch.isfinite(k[2]).all(),
          f"{label}: greedy_loop alphas and scores are finite")
    print(f"[check] greedy_loop kernel vs plain, {label}: tokens and lengths agree on "
          f"{rate * 100:.1f}% of rows, max abs err of scores and alphas {err:.2e}", flush=True)
    return rate, err, k


def train_phase(ckpt_model, imgs, dev):
    """Phase 8: training at the n64 configuration (module docstring)."""
    import torch
    stamps = {"a": time.perf_counter()}
    from sat_tpu_torch.kernels import decoder_step as KS
    from sat_tpu_torch.train.checkpoints import read_checkpoint_config
    from sat_tpu_torch.train.loop import Trainer

    out = {}
    # the header's settings at float32, from this process's own start, on
    # the batches given here (no dataset)
    base = read_checkpoint_config(CKPT).replace(
        precision=32, resume=None, device_resident_data=False, json=None)
    vocab = ckpt_model.vocab

    # (a) card against CPU: 3 SGD steps from the checkpoint's weights
    cfg_a = base.replace(opt="sgd", momentum=0.0, decoder_tf="always",
                         aug_scale=1.0, aug_hflip=0.0, aug_noise_std=0.0,
                         dropout=0.0, embedding_dropout=0.0, batch=B_TRAIN_CHECK)
    batch_a = caption_batch(vocab, B_TRAIN_CHECK, seed=11)
    runs = {}
    for d in (dev, torch.device("cpu")):
        tr = Trainer(cfg_a, device=d)
        tr.model.load_state_dict(ckpt_model.state_dict())
        runs[d.type] = (tr, torch.stack([torch.stack([m["loss"], m["ce_loss"]])
                                         for m in (tr.train_step(batch_a)
                                                   for _ in range(3))]).cpu())
    (gpu, m_gpu), (cpu, m_cpu) = runs[dev.type], runs["cpu"]
    loss_rel = ((m_gpu - m_cpu).abs() / m_cpu.abs()).max().item()
    dec_err = max(max_rel_err(gpu.model.decoder.state_dict(),
                              cpu.model.decoder.state_dict()).values())
    bn = bn_stats_err(gpu.model.encoder, cpu.model.encoder)
    print(f"[train] (a) 3 SGD steps at B={B_TRAIN_CHECK}, card against CPU: losses "
          f"{m_gpu[:, 0].tolist()}, max rel err of loss and CE {loss_rel:.2e}, decoder "
          f"params {dec_err:.2e} of each leaf's scale", flush=True)
    for key, what in (("var", "running variances, |diff| / (1e-4 |ref|)"),
                      ("mean", "running means, |diff| / (1e-4 max(|ref|, std))"),
                      ("mean_plain", "running means without the floor, "
                                     "|diff| / (1e-4 |ref|), not a check")):
        w = bn[key]
        print(f"[train] (a) BatchNorm {what}: worst {w['err']:.3g} at {w['leaf']} "
              f"channel {w['channel']} (ref mean {w['ref_mean']:.6g}, std "
              f"{w['std']:.6g}, diff {w['diff']:.3g})", flush=True)
    check(loss_rel <= 1e-4, f"train (a): loss and CE agree within 1e-4 ({loss_rel})")
    check(dec_err <= 1e-5, f"train (a): decoder parameters within 1e-5 ({dec_err})")
    check(bn["var"]["err"] <= 1, f"train (a): BatchNorm running variances within "
          f"rtol 1e-4 ({bn['var']})")
    check(bn["mean"]["err"] <= 1, f"train (a): BatchNorm running means within rtol "
          f"1e-4, floor 1e-4 std ({bn['mean']})")
    out["a"] = {"losses": m_gpu[:, 0].tolist(), "loss_ce_rel_err": loss_rel,
                "decoder_param_err": dec_err, "bn_stats": bn}
    del runs, gpu, cpu

    # (b) the n64 settings, from SATModel.create with the header's seed
    stamps["b"] = time.perf_counter()
    batch = caption_batch(vocab, B_TRAIN, seed=12)
    held = torch.cuda.memory_allocated()       # what phases 1-7 still hold
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(base, device=dev)
    metrics = [tr.train_step(batch) for _ in range(TRAIN_STEPS)]
    keys = list(metrics[0])
    rows = torch.stack([torch.stack([m[k] for k in keys]) for m in metrics]).cpu()
    peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    loss = rows[:, keys.index("loss")]
    first, last = loss[:5].mean().item(), loss[-5:].mean().item()
    print(f"[train] (b) {TRAIN_STEPS} steps of the n64 settings at B={B_TRAIN}, "
          f"T={MAX_WORDS + 2}: loss {loss[0]:.4f} -> {loss[-1]:.4f}, mean of steps "
          f"1-5 {first:.4f}, of steps {TRAIN_STEPS - 4}-{TRAIN_STEPS} {last:.4f} "
          f"({last / first:.3f}); peak memory {peak:.3f} GiB above the {held / 2 ** 30:.3f} "
          "GiB held before", flush=True)
    check(torch.isfinite(rows).all(), "train (b): every metric is finite")
    check(last <= 0.9 * first, f"train (b): the loss falls by 10 % ({last} > 0.9 x {first})")
    out["b"] = {"loss": loss.tolist(), "first5": first, "last5": last,
                "metrics_last": dict(zip(keys, rows[-1].tolist())),
                "peak_memory_gib": peak, "held_before_gib": held / 2 ** 30}

    # (c) the trained weights on the serving path
    stamps["c"] = time.perf_counter()
    beam_kw = dict(beamk=K_BEAM, max_gen_length=S, rescore_method="LN")
    KS.launches = 0
    caps_k = tr.model.caption(imgs, **beam_kw)[0]
    torch.cuda.synchronize()
    launched = KS.launches
    caps_p = tr.model.caption(imgs, fused=False, **beam_kw)[0]
    agree = same_share(caps_k, caps_p)
    print(f"[train] (c) model.caption of the trained weights (beamk {K_BEAM}, LN): "
          f"{launched} step-kernel calls; best captions of the kernels and the plain "
          f"path agree on {agree * 100:.1f}% of images; first: "
          f"{' '.join(vocab.itos(t) for t in caps_k[0])}", flush=True)
    check(launched == S + 1, "train (c): caption ran the step kernels")
    check(agree >= 0.99, f"train (c): best captions agree on {agree:.3f} of images")
    out["c"] = {"step_calls": launched, "agreement": agree}

    # (e) times of the n64 step (further steps on the same batch)
    def times(trainer, warmup, reps):
        ms = cuda_ms(lambda: trainer.train_step(batch), warmup=warmup, reps=reps)
        busy, parts = train_busy(trainer, batch)
        return {"ms": ms, "imgs_per_s": B_TRAIN / ms * 1e3, "busy_ms": busy,
                "device_idle": 1 - busy / ms, "busy_parts_ms": parts}
    stamps["e (b)"] = time.perf_counter()
    out["step"] = times(tr, warmup=3, reps=10)
    del tr

    # (d) encoder finetuning: the encoder moves from step 2 on
    stamps["d"] = time.perf_counter()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(base.replace(encoder_finetune_after=1), device=dev)
    enc = lambda: [p.detach().clone() for p in tr.model.encoder.parameters()]
    snaps, ms_d = [enc()], []
    for _ in range(3):
        ms_d.append(torch.stack(list(tr.train_step(batch).values())))
        snaps.append(enc())
    moved = [any(not torch.equal(a, b) for a, b in zip(snaps[i], snaps[i + 1]))
             for i in range(3)]
    peak_d = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    print(f"[train] (d) encoder_finetune_after=1: encoder parameters moved at steps "
          f"1-3: {moved}; losses {torch.stack(ms_d)[:, 0].tolist()}; peak memory "
          f"{peak_d:.3f} GiB above the {held / 2 ** 30:.3f} GiB held before", flush=True)
    check(bool(torch.isfinite(torch.stack(ms_d)).all()), "train (d): finite metrics")
    check(moved == [False, True, True], "train (d): the encoder moves from step 2 on")
    out["d"] = {"moved": moved, "peak_memory_gib": peak_d}
    # steps 2-3 of (d) finetune already: with one more, 3 warm-ups
    stamps["e (d)"] = time.perf_counter()
    out["finetune_step"] = times(tr, warmup=1, reps=10)
    stamps["end"] = time.perf_counter()
    names = list(stamps)
    out["seconds"] = {a: stamps[b] - stamps[a] for a, b in zip(names, names[1:])}
    for label, t in (("n64 step (b)", out["step"]), ("finetuning step (d)",
                                                      out["finetune_step"])):
        parts = t["busy_parts_ms"]
        print(f"[time] train {label}, B={B_TRAIN}: {t['ms']:.3f} ms per step, "
              f"{t['imgs_per_s']:.0f} imgs/s, busy {t['busy_ms']:.3f} ms, device idle "
              f"{t['device_idle']:.1%}; busy by part: "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in parts.items()), flush=True)
    print("[time] seconds per part of phase 8: " + ", ".join(
        f"{k} {v:.1f}" for k, v in out["seconds"].items()), flush=True)
    return out


def logged_fit(argv, device):
    """Run the training CLI's ``main(argv, device)`` in this process;
    returns (its trainer, every logger ``scalar`` call as (tag, value,
    step), the profiler's window over epoch 2's train steps on a card)."""
    import torch
    from sat_tpu_torch.train import logging as port_logging
    from sat_tpu_torch.train import loop
    from sat_tpu_torch.train.__main__ import main as train_main

    seen, calls, window = {}, [], {}
    real = (loop.Trainer.fit, loop.Trainer.train_epoch, port_logging.MetricsLogger.scalar)

    def fit(self):
        seen["trainer"] = self
        return real[0](self)

    def train_epoch(self, batches=None, max_batches=None):
        if batches is not None or self.current_epoch != 1 or self.device.type != "cuda":
            return real[1](self, batches, max_batches)
        torch.cuda.synchronize()
        with device_window() as prof:
            t0 = time.perf_counter()
            means = real[1](self, batches, max_batches)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        busy = sum(e.device_time_total for e in window_events(prof)) / 1e3
        window.update(epoch=2, wall_ms=wall, busy_ms=busy, device_idle=1 - busy / wall,
                      steps=len(self.train_loader))
        return means

    def scalar(self, tag, value, step):
        calls.append((tag, float(value), int(step)))
        return real[2](self, tag, value, step)

    loop.Trainer.fit, loop.Trainer.train_epoch = fit, train_epoch
    port_logging.MetricsLogger.scalar = scalar
    try:
        train_main(argv, device=device)
    finally:
        (loop.Trainer.fit, loop.Trainer.train_epoch,
         port_logging.MetricsLogger.scalar) = real
    return seen["trainer"], calls, window


def points(calls, tag):
    return [(s, v) for t, v, s in calls if t == tag]


def written_points(logdir):
    """{tag: points} as the logger wrote them to ``logdir``: JSON lines, or
    TensorBoard events (read with tensorboard's own reader)."""
    counts = {}
    jsonl = os.path.join(logdir, "metrics.jsonl")
    if os.path.exists(jsonl):
        with open(jsonl) as f:
            for line in f:
                tag = json.loads(line)["tag"]
                counts[tag] = counts.get(tag, 0) + 1
        return counts
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator
    acc = EventAccumulator(logdir, size_guidance={"scalars": 0})
    acc.Reload()
    return {tag: len(acc.Scalars(tag)) for tag in acc.Tags()["scalars"]}


def fit_argv(cfg, log_root):
    """The CLI's argv for phase 9 (d): the n64 header's settings as
    ``args_from_config`` writes them, with 3 epochs, half of the val batches,
    float32, and ``cfg``'s dataset."""
    from sat_tpu_torch.config import args_from_config
    return args_from_config(cfg.replace(epochs=FIT_EPOCHS, val_percent=0.5)) + [
        "--log_root", log_root]


def fit_phase(dev, data_dir):
    """Phase 9: fit at the n64 configuration (module docstring); the
    dataset is written into ``data_dir``, where phase 10 reads it."""
    import torch
    from sat_tpu_torch import native
    from sat_tpu_torch.data import images as DI
    from sat_tpu_torch.data.compositional import make_compositional_dataset
    from sat_tpu_torch.decode.api import unpack_beam_result
    from sat_tpu_torch.kernels import decoder_step as KS
    from sat_tpu_torch.train import loop
    from sat_tpu_torch.train.checkpoints import (load_checkpoint,
                                                 load_model_from_checkpoint,
                                                 read_checkpoint_config,
                                                 save_checkpoint)

    out, stamps = {}, {"a": time.perf_counter()}
    route = native.route()
    print(f"[fit] the C++ decode pool builds: {native.available()}; PIL imports: "
          f"{DI.decode_route() == 'PIL'}; the loaders decode with {route} (the default "
          "route); (b)'s CPU reference captions the card's loader's images, so it "
          "reads the same pixels", flush=True)
    out["decode_route"] = route
    with tempfile.TemporaryDirectory(prefix="sat_fit_") as tmp:
        # (a) the dataset and its loaders
        t0 = time.perf_counter()
        js = make_compositional_dataset(data_dir, n_train=FIT_TRAIN, n_val=FIT_VAL,
                                        n_test=8, image_size=224, n_nouns=64, seed=0)
        out["json"] = js
        write_s = time.perf_counter() - t0
        header = read_checkpoint_config(CKPT)
        with open(js) as f:
            check(json.load(f)["vocab_stoi"] == header.vocab_stoi,
                  "fit (a): the dataset's vocabulary is the checkpoint's")
        cfg = header.replace(precision=32, device_resident_data=False, resume=None,
                             json=js)
        tr = loop.Trainer(cfg.replace(val_percent=1.0), log_root=os.path.join(tmp, "b"),
                          device=dev)
        rates = {}
        for what, ld in (("train", tr.train_loader), ("val", tr.val_loader)):
            passes = []
            for p in range(2):
                ld.set_epoch(0)
                t0, before = time.perf_counter(), ld.decoded
                batches = list(ld)
                n = sum(len(b["images"]) for b in batches)
                rates[f"{what}_{('cold', 'cached')[p]}_imgs_per_s"] = n / (time.perf_counter() - t0)
                passes.append((batches, ld.decoded - before))
            (first, dec0), (second, dec1) = passes
            check(dec1 == 0, f"fit (a): the second {what} pass decodes nothing ({dec1})")
            if what == "val":
                check(all(all(np.array_equal(a[k], b[k]) for k in a)
                          for a, b in zip(first, second)) and len(first) == len(second),
                      "fit (a): two val passes give identical batches")
                val_first = first[0]
        print(f"[fit] (a) {FIT_TRAIN}/{FIT_VAL}/8 images written in {write_s:.1f} s; "
              "vocabulary equals the checkpoint's; loader images/s: "
              + ", ".join(f"{k} {v:.0f}" for k, v in rates.items()), flush=True)
        out["a"] = dict(rates, write_s=write_s)

        # (b) the serving checkpoint through validate()
        stamps["b"] = time.perf_counter()
        ck, _ = load_model_from_checkpoint(CKPT, device=dev)
        tr.model.load_state_dict(ck.state_dict())
        real_score, per_batch = loop.score_captions, []
        loop.score_captions = lambda *a, **k: per_batch.append(real_score(*a, **k)) or per_batch[-1]
        KS.launches = 0
        try:
            means = tr.validate()
        finally:
            loop.score_captions = real_score
        torch.cuda.synchronize()
        val_calls = KS.launches
        bleu = [m["bleu4"] for m in per_batch]
        print(f"[fit] (b) validate() of the checkpoint, {len(per_batch)} batches of "
              f"{tr.val_loader.batch_size}: BLEU-4 {means['bleu4']:.4f} (JAX f32 on this "
              f"split: {BLEU_JAX:.4f}), per batch {[round(b, 4) for b in bleu]} (JAX: "
              f"{list(BLEU_JAX_BATCHES)}); {val_calls} step-kernel calls; means {means}; "
              f"seconds {tr.last_val_timings}", flush=True)
        check(all(np.isfinite(v) for v in means.values()), "fit (b): finite metrics")
        n_val = len(tr.val_loader)
        check(0 < val_calls <= n_val * (cfg.val_max_len + 1),
              f"fit (b): the step kernels ran ({val_calls} calls for {n_val} batches)")
        check(abs(means["bleu4"] - BLEU_JAX) <= 0.01,
              f"fit (b): BLEU-4 {means['bleu4']} within 0.01 of {BLEU_JAX}")
        imgs16 = val_first["images"][:16]
        cpu_model, _ = load_model_from_checkpoint(CKPT, device="cpu")
        best = lambda m: unpack_beam_result(loop.val_decode(m, cfg, imgs16), m.grid_hw)[0]
        on_card, on_cpu = best(tr.model), best(cpu_model)
        same16 = sum(a == b for a, b in zip(on_card, on_cpu))
        print(f"[fit] (b) best captions of the first 16 val images, card against CPU: "
              f"{same16}/16 equal", flush=True)
        check(same16 >= 15, f"fit (b): {same16}/16 captions agree with the CPU's")
        out["b"] = {"means": means, "bleu4_per_batch": bleu, "step_calls": val_calls,
                    "val_batches": n_val, "cpu_agreement_of_16": same16,
                    "seconds": tr.last_val_timings}

        # (c) the checkpoint round trip
        stamps["c"] = time.perf_counter()
        names = sorted(os.listdir(tr.logdir))
        top = [n for n in names if n.startswith("epoch=0-step=0-bleu4=")]
        check(len(top) == 1 and "last.ckpt" in names, f"fit (c): files {names}")
        last = os.path.join(tr.logdir, "last.ckpt")
        back, _ = load_model_from_checkpoint(last, device=dev)
        sd, back_sd = tr.model.state_dict(), back.state_dict()
        check(sd.keys() == back_sd.keys() and all(torch.equal(sd[k], back_sd[k]) for k in sd),
              "fit (c): last.ckpt gives every parameter and buffer bit for bit")
        x = torch.from_numpy(val_first["images"]).to(dev).float() / 255.0
        kw = dict(beamk=K_BEAM, max_gen_length=cfg.val_max_len, rescore_method="LN")
        check(back.caption(x, **kw)[0] == tr.model.caption(x, **kw)[0],
              "fit (c): the re-read model captions as the model in memory")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree = tr._checkpoint_tree()
        tree_s = time.perf_counter() - t0
        save_checkpoint(os.path.join(tmp, "again.ckpt"), tr.cfg, tree)
        write_ckpt_s = time.perf_counter() - t0 - tree_s
        size = os.path.getsize(last)
        print(f"[fit] (c) {top[0]} and last.ckpt written; last.ckpt ({size / 2 ** 20:.2f} "
              f"MiB) reads back bit for bit and captions the same; tree from the card "
              f"{tree_s * 1e3:.1f} ms, file write {write_ckpt_s * 1e3:.1f} ms", flush=True)
        out["c"] = {"top_k": top[0], "bytes": size, "tree_s": tree_s, "write_s": write_ckpt_s}
        del tr, ck, back, cpu_model

        # (d) fit from scratch through the CLI
        stamps["d"] = time.perf_counter()
        argv = fit_argv(cfg, os.path.join(tmp, "d"))
        print(f"[fit] (d) python -m sat_tpu_torch.train {' '.join(argv)}", flush=True)
        KS.launches = 0
        trainer, calls, window = logged_fit(argv, None)
        torch.cuda.synchronize()
        fit_calls = KS.launches
        epoch_loss = [v for _, v in points(calls, "loss/train_epoch")]
        train_loss = points(calls, "loss/train")
        ratio = epoch_loss[-1] / epoch_loss[0]
        _, tree = load_checkpoint(os.path.join(trainer.logdir, "last.ckpt"))
        files = sorted(os.listdir(trainer.logdir))
        written = written_points(trainer.logdir)
        called = {}
        for t, _, _ in calls:
            called[t] = called.get(t, 0) + 1
        counts = {t: written.get(t, 0) for t in ("loss/train", "loss/train_epoch",
                                                 "Learning Rate", "bleu4/val_epoch")}
        print(f"[fit] (d) epoch mean losses {epoch_loss} (epoch 3 / epoch 1 = {ratio:.4f}); "
              f"val BLEU-4 {[v for _, v in points(calls, 'bleu4/val_epoch')]}; files {files}; "
              f"points in the logger's files {counts}, {sum(written.values())} in all of "
              f"{len(calls)} logged; {fit_calls} step-kernel calls in the validations",
              flush=True)
        check(all(np.isfinite(v) for t, v, _ in calls if t.endswith(("/train", "/train_epoch"))),
              "fit (d): finite train metrics")
        check(ratio <= 0.9, f"fit (d): epoch 3 loss at most 0.9 x epoch 1 ({ratio})")
        check(int(tree["step"]) == FIT_EPOCHS * FIT_TRAIN // B_TRAIN
              and int(tree["epoch"]) == FIT_EPOCHS - 1,
              f"fit (d): last.ckpt step {tree['step']} epoch {tree['epoch']}")
        check(sum(f.startswith("epoch=") for f in files) == 1, f"fit (d): one top-k file {files}")
        check(counts == {"loss/train": FIT_EPOCHS * FIT_TRAIN // B_TRAIN,
                         "loss/train_epoch": FIT_EPOCHS, "Learning Rate": FIT_EPOCHS,
                         "bleu4/val_epoch": FIT_EPOCHS}, f"fit (d): logged points {counts}")
        check(written == called, "fit (d): the logger's files hold every logged point")
        check(0 < fit_calls <= FIT_EPOCHS * (cfg.val_max_len + 1),
              f"fit (d): the validations ran the step kernels ({fit_calls} calls)")
        out["d"] = {"argv": argv, "epoch_loss": epoch_loss, "ratio": ratio,
                    "step_calls": fit_calls,
                    "train_loss": [v for _, v in train_loss], "files": files,
                    "val_bleu4": [v for _, v in points(calls, "bleu4/val_epoch")]}

        # (e) times of (d)
        stamps["e"] = time.perf_counter()
        epochs = []
        for t in trainer.epoch_timings:
            tr_t = t["train"]
            epochs.append({"epoch": t["epoch"] + 1, "wall_s": t["seconds"],
                           "train_s": tr_t["seconds"],
                           "train_imgs_per_s": tr_t["images"] / tr_t["seconds"],
                           "data_wait_s": tr_t["data_wait"], "val_s": t["val"]})
        for e in epochs:
            print(f"[time] fit epoch {e['epoch']}: {e['wall_s']:.2f} s wall, train "
                  f"{e['train_s']:.2f} s ({e['train_imgs_per_s']:.0f} imgs/s with the loader, "
                  f"{e['data_wait_s']:.2f} s waiting on it), validation "
                  + ", ".join(f"{k} {v:.3f} s" for k, v in e["val_s"].items()), flush=True)
        print(f"[time] fit epoch 2 train steps under the profiler: {window}", flush=True)
        out["e"] = {"epochs": epochs, "profile": window}
    stamps["end"] = time.perf_counter()
    names = list(stamps)
    out["seconds"] = {a: stamps[b] - stamps[a] for a, b in zip(names, names[1:])}
    print("[time] seconds per part of phase 9: " + ", ".join(
        f"{k} {v:.1f}" for k, v in out["seconds"].items()), flush=True)
    return out


def write_jpegs(out_dir, n, seed):
    """n seeded scenes as JPEG (quality 90), each resized from 224 to 256
    px and padded with the scenes' grey to SERVE_HW, so that serving's
    resize (shorter side 256 -> 224) and centre crop both run; then one
    file that is not an image, last in path order."""
    from PIL import Image
    h, w = SERVE_HW
    imgs = np.rint(scenes(n, 224, seed) * 255).astype(np.uint8)
    for i, a in enumerate(imgs):
        canvas = Image.new("RGB", (w, h), (105, 105, 105))
        canvas.paste(Image.fromarray(a).resize((h, h), Image.BILINEAR), ((w - h) // 2, 0))
        canvas.save(os.path.join(out_dir, f"scene_{i:03d}.jpg"), quality=90)
    with open(os.path.join(out_dir, "zz_not_an_image.jpg"), "w") as f:
        f.write("not an image")


def serve_run(argv, out_path, device=None):
    """One ``python -m sat_tpu_torch.serve`` run: (records, step-kernel
    calls, wall seconds of the call, the CLI's own timings)."""
    import torch
    from sat_tpu_torch import serve
    from sat_tpu_torch.kernels import decoder_step as KS
    KS.launches = 0
    t0, tm = time.perf_counter(), {}
    check(serve.main(list(argv) + ["--output", out_path], device=device,
                     timings=tm) == 0, f"serve {argv[-2:]}: exit code 0")
    if device is None:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    calls = KS.launches
    with open(out_path) as f:
        return [json.loads(line) for line in f], calls, wall, tm


def serve_phase(dev, js, card):
    """Phase 10: serve and evaluate at the n64 configuration (module
    docstring)."""
    import io
    from unittest import mock

    import torch
    from sat_tpu_torch import native, serve
    from sat_tpu_torch.evalx import evaluate as EV
    from sat_tpu_torch.evalx import temperature as TP
    from sat_tpu_torch.kernels import decoder_step as KS
    from sat_tpu_torch.models import lightning_export
    from sat_tpu_torch.train.checkpoints import load_any_checkpoint

    out, stamps = {}, {"a": time.perf_counter()}
    pool = native.shared_pool()
    out["pool"] = {"builds": pool is not None,
                   "threads": None if pool is None else pool.n_threads,
                   "library": str(native.lib_path().relative_to(ROOT))}
    print(f"[serve] the C++ decode pool (sat_tpu_torch/native, g++) builds on this "
          f"machine: {out['pool']}; serve's default route is {native.route()}, as the JAX "
          "package's serve would take", flush=True)
    with tempfile.TemporaryDirectory(prefix="sat_serve_") as tmp:
        img_dir = os.path.join(tmp, "images")
        os.makedirs(img_dir)
        t0 = time.perf_counter()
        write_jpegs(img_dir, SERVE_N, seed=10)
        write_s = time.perf_counter() - t0
        paths = serve.gather_images([img_dir])
        n = len(paths)
        n_batches = -(-n // SERVE_BATCH)
        base = ["--checkpoint", CKPT, "--images", img_dir, "--batch", str(SERVE_BATCH),
                "--beamk", str(K_BEAM), "--rescore_method", "LN"]
        max_len = 32   # serve's default --max_gen_length
        res = lambda name: os.path.join(tmp, name)

        # (a) f32 on the card, the first 16 images against the CPU
        recs, calls, wall, tm = serve_run(base + ["--precision", "32"], res("a.jsonl"))
        errors = [r for r in recs if "error" in r]
        print(f"[serve] (a) {n} files ({SERVE_N} JPEGs of {SERVE_HW[0]}x{SERVE_HW[1]} "
              f"written in {write_s:.2f} s, one not an image), decoded by {tm['route']}: "
              f"{len(recs)} records, {len(errors)} error; {calls} step-kernel calls for "
              f"{n_batches} batches; {wall:.2f} s", flush=True)
        check(n == SERVE_N + 1 and [r["image"] for r in recs] == paths,
              f"serve (a): {len(recs)} records in path order")
        check(len(errors) == 1 and errors[0]["image"].endswith("zz_not_an_image.jpg"),
              "serve (a): exactly one error record, the file that is not an image")
        check(n_batches <= calls <= n_batches * (max_len + 1),
              f"serve (a): the step kernels ran ({calls} calls for {n_batches} batches)")
        cpu_recs, _, _, cpu_tm = serve_run(
            ["--checkpoint", CKPT, "--images", *paths[:16], "--batch", "16", "--beamk",
             str(K_BEAM), "--rescore_method", "LN", "--precision", "32"],
            res("a_cpu.jsonl"), device="cpu")
        check(cpu_tm["route"] == tm["route"],
              f"serve (a): the CPU run decodes by {cpu_tm['route']}, the card's by {tm['route']}")
        gaps = [max(abs(g["score"] - c["score"]), abs(g["perplexity"] - c["perplexity"]))
                for g, c in zip(recs[:16], cpu_recs)]
        same16 = sum(g["caption"] == c["caption"] for g, c in zip(recs[:16], cpu_recs))
        print(f"[serve] (a) first 16 records against the CPU run ({cpu_tm['route']} "
              f"too): {same16}/16 captions "
              f"equal, largest score or perplexity gap {max(gaps):.2e}; e.g. "
              f"{recs[0]['caption']!r}", flush=True)
        check(same16 == 16 and max(gaps) <= 1e-4,
              f"serve (a): {same16}/16 captions equal to the CPU's, gap {max(gaps)}")
        out["a"] = {"route": tm["route"], "records": len(recs), "step_calls": calls,
                    "batches": n_batches,
                    "cpu_captions_equal_of_16": same16, "cpu_max_gap": max(gaps),
                    "write_s": write_s, "captions": [r.get("caption") for r in recs[:8]]}

        # (b) the CLI's default precision, bf16
        stamps["b"] = time.perf_counter()
        recs16, calls16, _, _ = serve_run(base, res("b.jsonl"))
        finite = all(np.isfinite(r["score"]) and np.isfinite(r["perplexity"])
                     for r in recs16 if "error" not in r)
        share = sum(a.get("caption") == b.get("caption")
                    for a, b in zip(recs, recs16) if "error" not in a) / SERVE_N
        print(f"[serve] (b) --precision 16: {len(recs16)} records, scores finite: {finite}; "
              f"{calls16} step-kernel calls; captions equal to (a)'s: {share:.1%} "
              "(not gated: the bf16 encoder, ROADMAP.md §3)", flush=True)
        check(len(recs16) == n and finite, "serve (b): 257 records with finite scores")
        out["b"] = {"records": len(recs16), "step_calls": calls16,
                    "captions_equal_to_f32": share}

        # (c) the reference Lightning route
        stamps["c"] = time.perf_counter()
        lt = res("n64_lightning.ckpt")
        lightning_export.main(["--input", CKPT, "--output", lt])
        sat_sd = load_any_checkpoint(CKPT).state_dict()
        lt_sd = load_any_checkpoint(lt).state_dict()
        check(sat_sd.keys() == lt_sd.keys()
              and all(torch.equal(sat_sd[k], lt_sd[k]) for k in sat_sd),
              "serve (c): the Lightning file gives every leaf of the SATTPU1 file bit for bit")
        lt_recs, _, _, _ = serve_run(
            ["--checkpoint", lt, "--images", *paths[:SERVE_BATCH]] + base[4:]
            + ["--precision", "32"], res("c.jsonl"))
        print(f"[serve] (c) Lightning .ckpt ({os.path.getsize(lt) / 2 ** 20:.2f} MiB): "
              f"{len(sat_sd)} leaves bit for bit; serve on it gives (a)'s JSONL for the "
              f"first {SERVE_BATCH} images: {lt_recs == recs[:SERVE_BATCH]}", flush=True)
        check(lt_recs == recs[:SERVE_BATCH],
              "serve (c): serving the Lightning file gives (a)'s records")
        out["c"] = {"leaves": len(sat_sd), "bytes": os.path.getsize(lt)}

        # (d) evaluate on phase 9's val split
        stamps["d"] = time.perf_counter()
        ev_tm, real = {}, EV.evaluate
        EV.evaluate = lambda *a, **k: real(*a, timings=ev_tm, **k)
        KS.launches = 0
        t0 = time.perf_counter()
        try:
            metrics = EV.main(["--checkpoint", CKPT, "--json", js, "--split", "val",
                               "--batch", "64", "--beamk", str(K_BEAM),
                               "--max_gen_length", str(S)])
        finally:
            EV.evaluate = real
        torch.cuda.synchronize()
        ev_s, ev_calls = time.perf_counter() - t0, KS.launches
        gaps = {k: metrics[k] - v for k, v in EVAL_JAX.items()}
        print(f"[serve] (d) evaluate, val split ({FIT_VAL} images): "
              + ", ".join(f"{k} {metrics[k]:.5f} (JAX {v})" for k, v in EVAL_JAX.items())
              + f"; {ev_calls} step-kernel calls; {ev_s:.2f} s", flush=True)
        check(all(abs(g) <= 0.01 for g in gaps.values()),
              f"serve (d): BLEU-1..4 and GLEU within 0.01 of JAX's ({gaps})")
        ev_batches = -(-FIT_VAL // 64)
        check(ev_batches <= ev_calls <= ev_batches * (S + 1),
              f"serve (d): the step kernels ran ({ev_calls} calls)")
        out["d"] = {"metrics": metrics, "jax": EVAL_JAX, "step_calls": ev_calls,
                    "seconds": dict(ev_tm, total=ev_s)}

        # (e) temperature scaling
        stamps["e"] = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            temp = TP.main(["--checkpoint", CKPT, "--json", js, "--split", "val",
                            "--batch_size", "16", "--max_batches", "8"])
        print(f"[serve] (e) temperature {temp:.6f} (JAX {TEMPERATURE_JAX})", flush=True)
        check(abs(temp - TEMPERATURE_JAX) <= 1e-3,
              f"serve (e): temperature {temp} within 1e-3 of JAX's")
        out["e"] = {"temperature": temp, "jax": TEMPERATURE_JAX}

        # (f) times: (a) and (b) were the warm-ups; the default route, then,
        # where the pool builds, with it switched off as where it does not
        # build (PIL)
        stamps["f"] = time.perf_counter()
        rates = {}
        routes = [("default", contextlib.nullcontext)] + (
            [("pil", lambda: mock.patch.object(native, "shared_pool", lambda: None))]
            if pool else [])
        for (name, route_of), prec in [(r, p) for r in routes for p in ("32", "16")]:
            with route_of():
                runs = [serve_run(base + ["--precision", prec], res("f.jsonl"))
                        for _ in range(3)]
            key = prec if name == "default" else f"{prec}_pil"
            rates[key] = {
                "route": runs[0][3]["route"],
                "imgs_per_s": statistics.median(n / w for _, _, w, _ in runs),
                "loop_imgs_per_s": statistics.median(n / t["seconds"] for *_, t in runs),
                "decode_s": statistics.median(t["decode_s"] for *_, t in runs),
                "decode_wait_s": statistics.median(t["decode_wait_s"] for *_, t in runs)}
        profiled = []
        busy = busy_of(device_times(lambda: profiled.append(
            serve_run(base + ["--precision", "32"], res("p.jsonl"))), calls=1))
        loop_ms = profiled[-1][3]["seconds"] * 1e3     # the profiled run's
        window = {"busy_ms": busy, "loop_ms": loop_ms,
                  "device_idle": None if busy is None else 1 - busy / loop_ms}
        for key, r in rates.items():
            print(f"[time] serve --precision {key[:2]}, {r['route']}, {n} files, median of "
                  f"3 ({card}): "
                  f"{r['imgs_per_s']:.0f} imgs/s for the call (checkpoint read included), "
                  f"{r['loop_imgs_per_s']:.0f} imgs/s in the loop; host JPEG decode "
                  f"{r['decode_s']:.3f} s in the prefetch thread, {r['decode_wait_s']:.3f} s "
                  "waited on", flush=True)
        busy_s, idle_s = (("not measured",) * 2 if busy is None else
                          (f"{busy:.3f} ms", f"{window['device_idle']:.1%}"))
        print(f"[time] serve --precision 32 under the profiler ({card}): busy "
              f"{busy_s} in a {loop_ms:.1f} ms loop, device idle {idle_s}; "
              f"evaluate {ev_s:.3f} s: "
              + ", ".join(f"{k} {v:.3f} s" for k, v in ev_tm.items()), flush=True)
        out["f"] = {"serve": rates, "profile": window, "card": card}
    stamps["end"] = time.perf_counter()
    names = list(stamps)
    out["seconds"] = {a: stamps[b] - stamps[a] for a, b in zip(names, names[1:])}
    print("[time] seconds per part of phase 10: " + ", ".join(
        f"{k} {v:.1f}" for k, v in out["seconds"].items()), flush=True)
    return out


def fit_trainer(argv, device, on_start=None):
    """The training CLI's ``main(argv, device)``; returns its trainer.
    ``on_start(trainer)`` runs as ``fit`` starts, on the trainer as the CLI
    built it."""
    from sat_tpu_torch.train import loop
    from sat_tpu_torch.train.__main__ import main as train_main

    seen, real = {}, loop.Trainer.fit

    def fit(self):
        seen["trainer"] = self
        if on_start is not None:
            on_start(self)
        return real(self)
    loop.Trainer.fit = fit
    try:
        train_main(argv, device=device)
    finally:
        loop.Trainer.fit = real
    return seen["trainer"]


def training_state(trainer):
    """{name: tensor} of the decoder's weights and their Adam moments."""
    out = {}
    for n, p in trainer.model.decoder.named_parameters():
        out[n] = p.detach()
        for k, v in trainer.optimizer.state.get(p, {}).items():
            if k != "step":
                out[f"{n}/{k}"] = v
    return out


def state_gap(a, b):
    """(largest gap relative to each tensor's largest magnitude, bit for bit)."""
    check(a.keys() == b.keys() and any("exp_avg" in k for k in a),
          "resume: the same weights and Adam moments")
    return tensors_gap(a, b)


def tensors_gap(a, b):
    """``state_gap`` of two dicts of float tensors with the same keys."""
    check(a.keys() == b.keys(), "the same tensors on both sides")
    gaps = [float((a[k] - b[k]).abs().max() / b[k].abs().max().clamp_min(1e-30)) for k in a]
    return max(gaps), all(bool((a[k] == b[k]).all()) for k in a)


def resume_phase(dev, js):
    """Phase 11: resume at the n64 configuration (module docstring)."""
    import torch
    from sat_tpu_torch.config import args_from_config
    from sat_tpu_torch.kernels import decoder_step as KS
    from sat_tpu_torch.train import loop
    from sat_tpu_torch.train.checkpoints import (RestartCheckpointManager,
                                                 load_checkpoint,
                                                 read_checkpoint_config)
    from sat_tpu_torch.train.opt_state import flatten, layout, optax_state_dict

    out, stamps = {}, {"a": time.perf_counter()}
    cfg = read_checkpoint_config(CKPT).replace(precision=32, device_resident_data=False,
                                               resume=None, json=js, epochs=RESUME_EPOCHS)
    spe = FIT_TRAIN // B_TRAIN
    with tempfile.TemporaryDirectory(prefix="sat_resume_") as tmp:
        # (a) straight
        KS.launches = 0
        straight = fit_trainer(args_from_config(cfg) + ["--log_root", os.path.join(tmp, "a")],
                               None)
        torch.cuda.synchronize()
        out["a_step_calls"] = KS.launches
        ref = training_state(straight)

        # (b) one epoch (its validation writes last.ckpt), then the CLI's --resume
        stamps["b"] = time.perf_counter()
        half = loop.Trainer(cfg, log_root=os.path.join(tmp, "b"), device=dev)
        half.current_epoch = 0
        half.train_epoch()
        half.validate()
        last = os.path.join(half.logdir, "last.ckpt")
        t0 = time.perf_counter()
        _, raw = load_checkpoint(last)
        read_s = time.perf_counter() - t0
        argv = ["--resume", last, "--epochs", str(RESUME_EPOCHS), "--val_interval",
                str(cfg.val_interval), "--val_percent", str(cfg.val_percent),
                "--workers", str(cfg.workers), "--log_root", os.path.join(tmp, "b_cli")]
        print(f"[resume] (b) after epoch 1: python -m sat_tpu_torch.train {' '.join(argv)}",
              flush=True)
        KS.launches = 0
        resumed_b = fit_trainer(argv, None)
        torch.cuda.synchronize()
        out["b_step_calls"] = KS.launches

        # (c) 3 batches into epoch 2, a restart file as RestartCheckpointManager
        # writes one (at a rise of the LR), then resume from it
        stamps["c"] = time.perf_counter()
        half.current_epoch = 1
        half.train_epoch(max_batches=RESUME_MID)
        lr = half.scheduler.current_lrs(half.global_step)["decoder"]
        manager = RestartCheckpointManager(os.path.join(tmp, "c"), cfg.lr_warmup_steps)
        manager.prev_lr = lr / 2
        t0 = time.perf_counter()
        restart = manager.on_train_batch_end(cfg, half._checkpoint_tree, half.global_step, lr)
        torch.cuda.synchronize()
        write_s = time.perf_counter() - t0
        check(restart is not None and restart.endswith(f"restart-{spe + RESUME_MID}.ckpt"),
              f"resume (c): the restart file {restart}")
        resumed_c = loop.Trainer(cfg.replace(resume=restart), log_root=os.path.join(tmp, "c"),
                                 device=dev)
        check((resumed_c.global_step, resumed_c.current_epoch, resumed_c._resume_skip_batches)
              == (spe + RESUME_MID, 1, RESUME_MID),
              "resume (c): the restart file re-enters epoch 2 at its 4th batch")
        resumed_c.fit()
        torch.cuda.synchronize()

        # gates
        stamps["gates"] = time.perf_counter()
        end = (straight.global_step, straight.current_epoch,
               straight.scheduler.current_lrs(straight.global_step))
        check(end[:2] == (RESUME_EPOCHS * spe, RESUME_EPOCHS - 1),
              f"resume (a): the straight run ends at step {end[0]}, epoch {end[1]}")
        for name, tr in (("b", resumed_b), ("c", resumed_c)):
            got = (tr.global_step, tr.current_epoch, tr.scheduler.current_lrs(tr.global_step))
            gap, exact = state_gap(training_state(tr), ref)
            print(f"[resume] ({name}) ends at step {got[0]}, epoch {got[1] + 1}, LRs {got[2]} "
                  f"(straight: {end[0]}, {end[1] + 1}, {end[2]}); decoder weights and Adam "
                  f"moments: largest gap {gap:.3e} of each tensor's largest magnitude, bit "
                  f"for bit: {exact}", flush=True)
            check(got == end, f"resume ({name}): step, epoch and LRs {got} are {end}")
            check(gap <= 1e-6, f"resume ({name}): gap {gap} within 1e-6")
            out[name] = {"step": got[0], "epoch": got[1], "max_rel_gap": gap,
                         "bit_for_bit": exact}
        check(0 < out["b_step_calls"] <= cfg.val_max_len + 1,
              f"resume (b): the resumed run's validation ran the step kernels "
              f"({out['b_step_calls']} calls)")
        opt_lay = layout(raw["opt_state"])
        want = layout(optax_state_dict(half.cfg, half.model, half.optimizer, spe))
        counts = {k: int(v) for k, v in flatten(raw["opt_state"]).items() if k.endswith("count")}
        print(f"[resume] last.ckpt's opt_state: {len(opt_lay)} leaves, "
              f"{sum(v != {} for v in opt_lay.values())} arrays, counts {sorted(set(counts.values()))} "
              f"over {len(counts)} labels; the layout of optax's tree: {opt_lay == want}", flush=True)
        check(opt_lay == want and set(counts.values()) == {spe} and len(counts) == 5,
              "resume: last.ckpt's opt_state has optax's layout and counts")
        size = os.path.getsize(restart)
        print(f"[resume] a checkpoint with opt_state: {size / 2 ** 20:.2f} MiB; written "
              f"(tree from the card + file) in {write_s:.3f} s, read in {read_s:.3f} s",
              flush=True)
        out.update(bytes=size, write_s=write_s, read_s=read_s, opt_state_leaves=len(opt_lay))
    stamps["end"] = time.perf_counter()
    names = list(stamps)
    out["seconds"] = {a: stamps[b] - stamps[a] for a, b in zip(names, names[1:])}
    print("[time] seconds per part of phase 11: " + ", ".join(
        f"{k} {v:.1f}" for k, v in out["seconds"].items()), flush=True)
    return out


def accumulated_state(trainer):
    """A copy of ``training_state`` with ``MultiSteps``' running mean of the
    gradients (every leaf), and its counters with Adam's count."""
    out = training_state(trainer)
    out.update({f"acc_grads/{n}": t for n, t in trainer.multisteps.acc.items()})
    out = {k: v.clone() for k, v in out.items()}
    steps = sorted({float(st["step"]) for st in trainer.optimizer.state.values() if "step" in st})
    return out, [trainer.multisteps.mini_step, trainer.multisteps.gradient_step, steps]


def trace_kernels(profile_dir):
    """(trace files in ``profile_dir``, CUDA kernel events in them)."""
    files = [os.path.join(profile_dir, f) for f in sorted(os.listdir(profile_dir))
             if f.endswith(".pt.trace.json")] if os.path.isdir(profile_dir) else []
    kernels = 0
    for f in files:
        with open(f) as fh:
            kernels += sum(e.get("cat") == "kernel" for e in json.load(fh)["traceEvents"])
    return files, kernels


def settings_phase(dev, js, step_f32):
    """Phase 12: the trainer's settings at the n64 configuration (module
    docstring); ``step_f32`` is phase 8 (e)'s float32 step."""
    import torch
    from sat_tpu_torch.config import args_from_config
    from sat_tpu_torch.kernels import decoder_step as KS
    from sat_tpu_torch.train import loop
    from sat_tpu_torch.train.checkpoints import (load_checkpoint, load_model_from_checkpoint,
                                                 read_checkpoint_config, save_checkpoint)

    out, stamps = {}, {"a": time.perf_counter()}
    header = read_checkpoint_config(CKPT).replace(resume=None)
    base = header.replace(precision=32, device_resident_data=False, json=None)  # phase 8's
    ckpt_model, _ = load_model_from_checkpoint(CKPT, device="cpu")
    vocab = ckpt_model.vocab
    exact = dict(opt="sgd", momentum=0.0, decoder_tf="always", aug_scale=1.0, aug_hflip=0.0,
                 aug_noise_std=0.0, dropout=0.0, embedding_dropout=0.0)

    # (a) precision 16: 3 SGD steps from the checkpoint's weights, card against
    # CPU (and against the card's float32 steps, for scale)
    cfg_a = base.replace(precision=16, batch=B_TRAIN_CHECK, **exact)
    batch_a = caption_batch(vocab, B_TRAIN_CHECK, seed=11)
    runs = {}
    for name, d, c in (("card", dev, cfg_a), ("cpu", torch.device("cpu"), cfg_a),
                       ("card f32", dev, cfg_a.replace(precision=32))):
        tr = loop.Trainer(c, device=d)
        tr.model.load_state_dict(ckpt_model.state_dict())
        runs[name] = (tr, torch.stack([torch.stack([m["loss"], m["ce_loss"]])
                                       for m in (tr.train_step(batch_a) for _ in range(3))]).cpu())

    def gap(a, b):
        (ta, ma), (tb, mb) = runs[a], runs[b]
        return (((ma - mb).abs() / mb.abs()).max().item(),
                max(max_rel_err(ta.model.decoder.state_dict(),
                                tb.model.decoder.state_dict()).values()))
    (loss_rel, dec_err), (loss_f32, dec_f32) = gap("card", "cpu"), gap("card", "card f32")
    print(f"[settings] (a) 3 bf16 SGD steps at B={B_TRAIN_CHECK}, card against CPU: losses "
          f"{runs['card'][1][:, 0].tolist()}, max rel err of loss and CE {loss_rel:.2e}, "
          f"decoder params {dec_err:.2e} of each leaf's scale (tolerances {BF16_LOSS_TOL:g}, "
          f"{BF16_PARAM_TOL:g}); bf16 against f32 on the card: {loss_f32:.2e}, {dec_f32:.2e}",
          flush=True)
    check(all(p.dtype == torch.float32 for p in runs["card"][0].model.parameters()),
          "settings (a): the weights stay float32 at precision 16")
    check(loss_rel <= BF16_LOSS_TOL, f"settings (a): bf16 loss and CE, card against CPU, "
          f"within {BF16_LOSS_TOL} ({loss_rel})")
    check(dec_err <= BF16_PARAM_TOL, f"settings (a): bf16 decoder parameters, card against "
          f"CPU, within {BF16_PARAM_TOL} ({dec_err})")
    check(loss_f32 >= BF16_APART * loss_rel, f"settings (a): the bf16 losses {loss_f32} from "
          f"float32's on the card, not {BF16_APART} x their gap to the CPU's ({loss_rel})")
    out["a"] = {"losses": runs["card"][1][:, 0].tolist(), "loss_ce_rel_err": loss_rel,
                "decoder_param_err": dec_err, "vs_f32": {"loss": loss_f32, "decoder": dec_f32}}
    del runs

    batch = caption_batch(vocab, B_TRAIN, seed=12)

    def peak_since(held):
        return (torch.cuda.max_memory_allocated() - held) / 2 ** 30

    def step_times(trainer, warmup=3):
        ms = cuda_ms(lambda: trainer.train_step(batch), warmup=warmup, reps=10)
        busy, parts = train_busy(trainer, batch)
        return {"ms": ms, "imgs_per_s": B_TRAIN / ms * 1e3, "busy_ms": busy,
                "device_idle": 1 - busy / ms, "busy_parts_ms": parts}

    # (a) 30 steps of the n64 settings at bf16, then the step's times
    stamps["a (30 steps)"] = time.perf_counter()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tr = loop.Trainer(base.replace(precision=16), device=dev)
    loss = torch.stack([tr.train_step(batch)["loss"] for _ in range(TRAIN_STEPS)]).cpu()
    peak = peak_since(held)
    first, last = loss[:5].mean().item(), loss[-5:].mean().item()
    print(f"[settings] (a) {TRAIN_STEPS} bf16 steps of the n64 settings at B={B_TRAIN}: "
          f"loss {loss[0]:.4f} -> {loss[-1]:.4f}, mean of steps 1-5 {first:.4f}, of the "
          f"last 5 {last:.4f} ({last / first:.3f}); peak memory {peak:.3f} GiB (f32: "
          f"{step_f32['peak_memory_gib']:.3f})", flush=True)
    check(bool(torch.isfinite(loss).all()), "settings (a): every bf16 loss is finite")
    check(last <= 0.9 * first, f"settings (a): the bf16 loss falls by 10 % ({last} > 0.9 x {first})")
    out["a"].update(loss=loss.tolist(), first5=first, last5=last, peak_memory_gib=peak,
                    step=step_times(tr))
    del tr

    # (b) microbatch 16 at B 64: with the eval-mode frozen encoder (SGD, no
    # draws) chunking changes nothing; with train-mode BatchNorm, times only
    stamps["b"] = time.perf_counter()
    cfg_b = base.replace(frozen_encoder_eval=True, batch=B_TRAIN, **exact)
    full = loop.Trainer(cfg_b, device=dev)
    chunked = loop.Trainer(cfg_b.replace(microbatch=B_TRAIN // 4), device=dev)
    chunked.model.load_state_dict(full.model.state_dict())
    mf, mc = zip(*[(full.train_step(batch), chunked.train_step(batch)) for _ in range(3)])
    stack = lambda ms: torch.stack([torch.stack([m[k] for k in sorted(m)]) for m in ms]).cpu()
    metric_rel = ((stack(mc) - stack(mf)).abs() / stack(mf).abs().clamp_min(1e-30)).max().item()
    w_err = max(max_rel_err(chunked.model.state_dict(), full.model.state_dict()).values())
    del full, chunked
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tr = loop.Trainer(base.replace(batch=B_TRAIN, microbatch=B_TRAIN // 4), device=dev)
    t_mb = {"ms": cuda_ms(lambda: tr.train_step(batch), warmup=3, reps=10)}
    t_mb.update(imgs_per_s=B_TRAIN / t_mb["ms"] * 1e3, peak_memory_gib=peak_since(held))
    del tr
    print(f"[settings] (b) microbatch {B_TRAIN // 4} at B={B_TRAIN}, frozen_encoder_eval, 3 SGD steps: "
          f"weights within {w_err:.2e} of the full step (each leaf's scale), metrics "
          f"{metric_rel:.2e}; with train-mode BatchNorm {t_mb['ms']:.3f} ms per step, peak "
          f"{t_mb['peak_memory_gib']:.3f} GiB (the full f32 step: {step_f32['ms']:.3f} ms, "
          f"{step_f32['peak_memory_gib']:.3f} GiB)", flush=True)
    check(w_err <= 1e-5, f"settings (b): microbatch weights within 1e-5 of the full step ({w_err})")
    out["b"] = {"weights_err": w_err, "metrics_rel_err": metric_rel, "train_bn_step": t_mb}

    with tempfile.TemporaryDirectory(prefix="sat_settings_") as tmp:
        # (c) accumulate 2 with the header's settings (bf16, staged data in
        # chunks): the CLI straight (with (e)'s profile_dir), and a run stopped
        # after step 3, between two mini steps, resumed through --resume
        stamps["c"] = time.perf_counter()
        cfg_c = header.replace(json=js, epochs=1, accumulate=2)
        prof_dir = os.path.join(tmp, "profile")
        straight = fit_trainer(args_from_config(cfg_c.replace(profile_dir=prof_dir))
                               + ["--log_root", os.path.join(tmp, "c")], None)
        half = loop.Trainer(cfg_c, log_root=os.path.join(tmp, "c_half"), device=dev)
        half.current_epoch = 0
        half.train_epoch(max_batches=3)
        mid = os.path.join(tmp, "mid.ckpt")
        save_checkpoint(mid, half.cfg, half._checkpoint_tree())
        _, raw = load_checkpoint(mid)
        loaded = {}
        resumed = fit_trainer(["--resume", mid, "--epochs", "1", "--log_root",
                               os.path.join(tmp, "c_cli")], None,
                              on_start=lambda t: loaded.update(state=accumulated_state(t)))
        torch.cuda.synchronize()
        keys = set(raw["opt_state"])
        at_mid, ref_mid = loaded["state"], accumulated_state(half)
        (gap_mid, exact_mid), (gap_end, exact_end) = (
            state_gap(at_mid[0], ref_mid[0]), state_gap(*(accumulated_state(t)[0]
                                                          for t in (resumed, straight))))
        counters = [accumulated_state(t)[1] for t in (resumed, straight)]
        print(f"[settings] (c) accumulate 2: opt_state keys {sorted(keys)}, mini_step "
              f"{int(raw['opt_state']['mini_step'])} after step 3; --resume read it bit for "
              f"bit: {exact_mid and at_mid[1] == ref_mid[1]} (gap {gap_mid:.2e}); the resumed "
              f"run ends at step {resumed.global_step}, counters {counters[0]} (straight "
              f"{counters[1]}), weights, acc_grads and Adam moments bit for bit: {exact_end} "
              f"(gap {gap_end:.2e})", flush=True)
        check(keys == {"mini_step", "gradient_step", "inner_opt_state", "acc_grads",
                       "skip_state"} and int(raw["opt_state"]["mini_step"]) == 1,
              f"settings (c): opt_state has MultiSteps' five keys, mid-accumulation ({keys})")
        check(exact_mid and at_mid[1] == ref_mid[1], "settings (c): --resume reads the "
              "weights, acc_grads, moments and counters bit for bit")
        check(exact_end and counters[0] == counters[1] and resumed.global_step ==
              straight.global_step == len(straight.train_loader),
              "settings (c): the resumed run ends bit for bit with the straight run")
        out["c"] = {"keys": sorted(keys), "bit_for_bit_at_load": exact_mid,
                    "bit_for_bit_at_end": exact_end, "gap_end": gap_end,
                    "counters": counters[0]}

        # (e) profile_dir: the straight run's first epoch
        files, n_kernels = trace_kernels(prof_dir)
        print(f"[settings] (e) profile_dir: {len(files)} trace file(s), "
              f"{sum(os.path.getsize(f) for f in files) / 2 ** 20:.1f} MiB, "
              f"{n_kernels} CUDA kernel events", flush=True)
        check(len(files) == 1 and n_kernels > 0, "settings (e): fit's trace lists CUDA kernels")
        out["e"] = {"trace_files": len(files), "kernel_events": n_kernels}
        del straight, half, resumed

        # (d) device_resident_data, 2 epochs of 8 steps: the host path, then the
        # staged data per step and in chunks of 4 (bit for bit with the host
        # path) and of 8 (timed); epoch 2 of each timed run in a profiler window
        stamps["d"] = time.perf_counter()
        cfg_d = header.replace(json=js, epochs=2)
        runs = {}
        for tag, kw in (("host", dict(device_resident_data=False)),
                        ("spd 1", dict(device_resident_data=True, steps_per_dispatch=1)),
                        ("spd 4", dict(device_resident_data=True, steps_per_dispatch=4)),
                        ("spd 8", dict(device_resident_data=True, steps_per_dispatch=8))):
            tr = loop.Trainer(cfg_d.replace(**kw), log_root=os.path.join(tmp, "d"),
                              device=dev)
            logged, real = [], tr.logger.scalar
            tr.logger.scalar = lambda t, v, st, real=real, logged=logged: (
                logged.append((t, float(v), st)) if "images_per_sec" not in t else None,
                real(t, v, st))
            epochs = []
            for epoch in range(2):
                tr.current_epoch = epoch
                window = epoch == 1 and tag != "spd 4"
                torch.cuda.synchronize()
                with device_window() if window else contextlib.nullcontext() as prof:
                    t0 = time.perf_counter()
                    tr.train_epoch()
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                busy = (sum(e.device_time_total for e in window_events(prof)) / 1e6
                        if window else None)
                KS.launches = 0
                val = tr.validate()
                torch.cuda.synchronize()
                tm = tr.last_train_timings
                epochs.append({"wall_s": wall, "imgs_per_s": tm["images"] / tm["seconds"],
                               "busy_s": busy, "device_idle": busy and 1 - busy / wall,
                               "bleu4": val["bleu4"], "step_calls": KS.launches})
            runs[tag] = (tr.model.state_dict(), logged, epochs, dict(tr.staging_seconds))
            del tr
        ref = runs["host"]
        for tag in ("spd 1", "spd 4"):
            state, logged, epochs, _ = runs[tag]
            gap_w, exact_w = tensors_gap(
                {k: v for k, v in state.items() if v.is_floating_point()},
                {k: v for k, v in ref[0].items() if v.is_floating_point()})
            same_log = len(logged) == len(ref[1]) and all(
                a[0] == b[0] and a[2] == b[2] and abs(a[1] - b[1]) <= 1e-6 * max(1, abs(b[1]))
                for a, b in zip(logged, ref[1]))
            bleu = [e["bleu4"] for e in epochs]
            print(f"[settings] (d) {tag} against the host path: weights and statistics bit "
                  f"for bit: {exact_w} (gap {gap_w:.2e}); {len(logged)} logged points equal: "
                  f"{same_log}; BLEU-4 {bleu} (host {[e['bleu4'] for e in ref[2]]}); step "
                  f"calls in validation {[e['step_calls'] for e in epochs]}", flush=True)
            check(gap_w <= 1e-6, f"settings (d) {tag}: weights within 1e-6 of the host path")
            check(same_log, f"settings (d) {tag}: the logged metrics are the host path's")
            check(bleu == [e["bleu4"] for e in ref[2]], f"settings (d) {tag}: BLEU-4 {bleu}")
            check(all(e["step_calls"] > 0 for e in epochs),
                  f"settings (d) {tag}: the staged validation ran the step kernels")
            out.setdefault("d", {})[tag] = {"bit_for_bit": exact_w, "gap": gap_w,
                                            "bleu4": bleu}
        for tag in ("host", "spd 1", "spd 8"):
            _, _, epochs, staging = runs[tag]
            print(f"[time] settings (d) {tag}: " + "; ".join(
                f"epoch {i + 1} {e['wall_s']:.2f} s wall, {e['imgs_per_s']:.0f} training "
                f"imgs/s" + (f", busy {e['busy_s']:.3f} s, device idle {e['device_idle']:.1%} "
                             "(profiled)" if e["busy_s"] is not None else "")
                for i, e in enumerate(epochs)) + (
                f"; staging {staging['train']:.2f} s train, {staging['val']:.2f} s val"
                if staging else ""), flush=True)
            out["d"][tag] = dict(out["d"].get(tag, {}), epochs=epochs, staging_s=staging)
    stamps["end"] = time.perf_counter()
    names = list(stamps)
    out["seconds"] = {a: stamps[b] - stamps[a] for a, b in zip(names, names[1:])}
    t16 = out["a"]["step"]
    print(f"[time] train step at bf16, B={B_TRAIN}: {t16['ms']:.3f} ms, {t16['imgs_per_s']:.0f} "
          f"imgs/s, busy {t16['busy_ms']:.3f} ms, device idle {t16['device_idle']:.1%}, peak "
          f"{out['a']['peak_memory_gib']:.3f} GiB; at f32 (phase 8 (e)) {step_f32['ms']:.3f} ms, "
          f"busy {step_f32['busy_ms']:.3f} ms, idle {step_f32['device_idle']:.1%}, peak "
          f"{step_f32['peak_memory_gib']:.3f} GiB; bf16 busy by part: " + ", ".join(
              f"{k} {v:.3f} ms" for k, v in t16["busy_parts_ms"].items()), flush=True)
    print("[time] seconds per part of phase 12: " + ", ".join(
        f"{k} {v:.1f}" for k, v in out["seconds"].items()), flush=True)
    return out


def randomise_bn(module, generator):
    """Draw every BatchNorm's scale U(0.5, 1.5), bias N(0, 0.1), running
    mean N(0, 0.1) and variance U(0.5, 2), in place."""
    import torch
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5, generator=generator)
                m.bias.normal_(0.0, 0.1, generator=generator)
                m.running_mean.normal_(0.0, 0.1, generator=generator)
                m.running_var.uniform_(0.5, 2.0, generator=generator)
    return module


def seeded_encoder(arch, seed, device, px):
    """The port's ``arch`` encoder at ``px`` on ``device`` with flax's
    initialisers and random BatchNorm statistics, drawn there from ``seed``."""
    import torch
    from sat_tpu_torch.config import SATConfig
    from sat_tpu_torch.models.backbones import flax_init_
    from sat_tpu_torch.models.encoder import encoder_from_config
    g = torch.Generator(device).manual_seed(seed)
    enc = encoder_from_config(SATConfig(encoder_arch=arch, input_size=px))
    return randomise_bn(flax_init_(enc.to(device), g), g)


def write_torchvision_weights(arch, px, path, seed, device):
    """A seeded torchvision-layout ``arch`` state_dict (random BatchNorm
    statistics) written to ``path`` by the port's exporter, the file a user
    passes as ``--pretrained_weights``; returns its number of keys."""
    import torch
    from sat_tpu_torch.models.jax_import import encoder_to_jax
    from sat_tpu_torch.models.lightning_export import export_backbone
    params, stats = encoder_to_jax(seeded_encoder(arch, seed, device, px))
    sd = export_backbone(arch, params["backbone"], stats.get("backbone"))
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, path)
    return len(sd)


def vocab_config(v, arch, px, size, dim):
    """``arch`` at ``px`` with ``encoder_size`` ``size`` and D ``dim``, the
    default decoder widths and a vocabulary of v synthetic words (the 4
    specials last, <PAD> 0)."""
    from sat_tpu_torch.config import SATConfig
    stoi = {f"w{i}": i for i in range(1, v - 3)}
    stoi.update({"<UNK>": v - 3, "<START>": v - 2, "<END>": v - 1, "<PAD>": 0})
    return SATConfig(encoder_arch=arch, input_size=px, encoder_size=size,
                     encoder_dim=dim, embed_dim=256, attention_dim=128, decoder_dim=512,
                     deep_output=True, vocab_size=v, vocab_stoi=stoi)


def timed(fn, name=None, calls=1, warmup=3, reps=10, profiled=3, parts=()):
    """{ms: CUDA events per call, busy_ms: the profiler's busy device time
    per call of the kernels whose name holds ``name`` (all for None),
    device_idle: 1 - busy / ms, and for each of ``parts`` the busy ms of
    the kernels whose name holds ``name`` + part}."""
    ms = cuda_ms(fn, calls=calls, warmup=warmup, reps=reps)
    dt = device_times(fn, calls=profiled)
    busy = busy_of(dt, name)
    out = {"ms": ms, "busy_ms": busy,
           "device_idle": None if busy is None else 1 - busy / ms}
    if parts:
        out["busy_parts_ms"] = {p: busy_of(dt, name + p) for p in parts}
    return out


def fmt_time(label, t, extra=""):
    busy = "not measured" if t["busy_ms"] is None else f"{t['busy_ms']:.3f} ms"
    idle = "not measured" if t["device_idle"] is None else f"{t['device_idle']:.1%}"
    return f"{label}: {t['ms']:.3f} ms{extra}, busy {busy}, device idle {idle}"


def encoders_card_vs_cpu(archs, dev, px, img_seed, w_seed, tag):
    """Each of ``archs``' encoders at B_ENC and ``px`` with seeded weights
    and BatchNorm statistics, eval and train mode, card against CPU:
    annotations within 1e-3 of their scale (float32 convolutions summed in
    other orders, cuDNN's and oneDNN's: ~1e-5 of the scale measured through
    18 to 152 layers), running statistics within rtol 1e-3.  Returns each
    arch's errors."""
    import torch
    from sat_tpu_torch.config import SATConfig
    from sat_tpu_torch.models.encoder import probe_encoder
    x = torch.from_numpy(scenes(B_ENC, px, seed=img_seed))
    enc_err = {}
    for i, arch in enumerate(archs):
        on_card = seeded_encoder(arch, w_seed + i, dev, px)
        on_cpu = copy.deepcopy(on_card).cpu()
        d, (h, w) = probe_encoder(SATConfig(encoder_arch=arch, input_size=px))
        errs = {}
        for mode in ("eval", "train"):
            with torch.no_grad():
                ref = on_cpu.train(mode == "train")(x)
                got = on_card.train(mode == "train")(x.to(dev)).cpu()
            scale = ref.abs().max().item()
            errs[mode] = (got - ref).abs().max().item() / max(1.0, scale)
            check(got.shape == ref.shape == (B_ENC, h * w, d)
                  and torch.isfinite(got).all(), f"{tag}: {arch} {mode} annotations")
        check(errs["eval"] <= 1e-3 and errs["train"] <= 1e-3,
              f"{tag}: {arch} annotations within 1e-3 of their scale ({errs})")
        bn = bn_stats_err(on_card, on_cpu, rtol=1e-3)
        if bn:    # squeezenet has no BatchNorm
            errs["bn_var"], errs["bn_mean"] = bn["var"]["err"], bn["mean"]["err"]
            check(bn["var"]["err"] <= 1 and bn["mean"]["err"] <= 1,
                  f"{tag}: {arch} running statistics within rtol 1e-3 ({bn})")
        enc_err[arch] = errs
        del on_cpu, on_card
    print(f"[{tag}] {len(archs)} encoders at B={B_ENC}, {px} px, card against "
          "CPU, max |diff| / max(1, max |ref|) in eval and train mode, and the running "
          "statistics' worst error over rtol 1e-3: " + "; ".join(
              f"{a} " + ", ".join(f"{k} {v:.1e}" for k, v in e.items())
              for a, e in enc_err.items()), flush=True)
    return enc_err


def bf16_encoder_card_vs_cpu(arch, dev, px, w_seed, img_seed, tag):
    """The seeded ``arch`` encoder in bf16 (the model cast as ``serve``
    casts it) at B_ENC, card against CPU: within 4 bf16 ulps of the
    largest value; the relative gaps, and the CPU's bf16 against its f32,
    printed and returned."""
    import torch
    enc = seeded_encoder(arch, w_seed, dev, px).eval()
    x = torch.from_numpy(scenes(B_ENC, px, seed=img_seed))
    with torch.no_grad():
        f32 = enc.cpu()(x)
        enc = enc.to(torch.bfloat16)
        ref = enc(x.to(torch.bfloat16))
        got = enc.to(dev)(x.to(dev, torch.bfloat16)).cpu()
    rel = lambda a, b: ((a.float() - b.float()).norm() / b.float().norm()).item()
    top_ulp = 2.0 ** (np.floor(np.log2(ref.float().abs().max().item())) - 7)
    bf16 = {"card_vs_cpu": rel(got, ref), "cpu_bf16_vs_f32": rel(ref, f32),
            "card_vs_cpu_max_abs": (got.float() - ref.float()).abs().max().item(),
            "top_ulp": float(top_ulp)}
    print(f"[{tag}] {arch} in bf16 at B={B_ENC}, card against CPU: relative "
          f"Frobenius gap {bf16['card_vs_cpu']:.3e}, max abs {bf16['card_vs_cpu_max_abs']:.3g} "
          f"({bf16['card_vs_cpu_max_abs'] / top_ulp:.2f} bf16 ulps of the largest value); "
          f"the CPU's bf16 against its f32 {bf16['cpu_bf16_vs_f32']:.3e}", flush=True)
    check(got.dtype == torch.bfloat16 and got.shape == ref.shape and torch.isfinite(got).all(),
          f"{tag}: bf16 annotations, type, shape, finite")
    # the two bf16 runs differ where a float32 sum (cuDNN's, oneDNN's) lands
    # on the other side of a bf16 rounding, and the difference travels on
    # through the blocks: an H100 measured 2^-7 at mobilenet_v3_small (PERF.md)
    check(bf16["card_vs_cpu_max_abs"] <= 4 * top_ulp,
          f"{tag}: bf16 card within 4 bf16 ulps of the CPU's ({bf16})")
    return bf16


def decode_kernel_checks(model, imgs, rows, tag, loop=True):
    """Both decode kernels of ``model`` against their plain versions on its
    annotations of ``imgs``: the step at each of ``rows`` rows and, where
    ``loop``, the loop at B rows, f32 and bf16, with the launch plans
    printed and each tiled product filling 64 blocks.  Returns {"L", "D",
    "plans", "args": the step's arguments by rows (f"{n}_bf16" for bf16),
    "step_err": likewise, and with ``loop`` "la": the loop's f32 arguments,
    "loop": (agreement, max error, outputs), "loop_bf16": (agreement, max
    error)}."""
    import torch
    from sat_tpu_torch.kernels import decoder_step as KS
    from sat_tpu_torch.kernels import greedy_loop as KL
    from sat_tpu_torch.models import decoder as TD
    params, vcfg = model.decoder, model.cfg
    an_all = model.encode(imgs)
    L, D = an_all.shape[1:]
    H, E, A, V = vcfg.decoder_dim, vcfg.embed_dim, vcfg.attention_dim, vcfg.vocab_size
    plans = {"decoder step kernels": KS.step_plan(max(rows), L, D, A, H, E)}
    if loop:
        plans["greedy loop phases"] = KL.loop_plan(B, L, D, A, H, E, V)
    for what, plan in plans.items():
        print(f"[design] {what}, f32 L={L} D={D} V={V}: " + "; ".join(
            f"{k} grid {g} x {n} threads, smem {dyn} B dynamic + {st} B static"
            for k, (g, n, dyn, st) in plan.items()), flush=True)
        for k in ("hside", "gates", "deepout"):
            check(plan[k][0][0] * plan[k][0][1] * plan[k][0][2] >= 64,
                  f"{tag} {what}: {k} fills 64 blocks")
    bf = lambda t: t.to(torch.bfloat16).contiguous()
    args, errs = {}, {}
    for n in rows:
        an = an_all[:n].contiguous()
        ae = TD.attention_precompute(params, an)
        h0, c0 = (t[0].contiguous() for t in TD.init_lstm_state(params, an, vcfg))
        ids = torch.from_numpy(np.random.default_rng(15).integers(1, V - 3, size=n)).to(an.device)
        e = TD.embed_tokens(params, ids, vcfg).contiguous()
        args[n] = (KS.step_weights(params, vcfg), vcfg, e, h0, c0, an, ae)
        args[f"{n}_bf16"] = (KS.step_weights(params, vcfg, torch.bfloat16), vcfg,
                             *map(bf, (e, h0, c0, an, ae)))
        errs[n] = check_step(f"{tag} L={L} D={D} N={n} f32", args[n])[1]
        errs[f"{n}_bf16"] = check_step(f"{tag} L={L} D={D} N={n} bf16", args[f"{n}_bf16"],
                                       rel=1e-2)[1]
    out = {"L": L, "D": D, "plans": plans, "args": args, "step_err": errs}
    if loop:
        _, _, e, h0, c0, an, ae = args[B]
        la = (*KL.loop_weights(params, vcfg, torch.float32), vcfg, an, ae, h0, c0)
        la16 = (*KL.loop_weights(params, vcfg, torch.bfloat16), vcfg, *map(bf, (an, ae, h0, c0)))
        out.update(la=la, loop=check_loop(f"{tag} L={L} D={D} V={V} B={B} f32", la),
                   loop_bf16=check_loop(f"{tag} L={L} D={D} V={V} B={B} bf16", la16,
                                        bf16=True)[:2])
    return out


def steps_card_vs_cpu(cfg_c, dev, draw_seed, tag):
    """Three ``Trainer.train_step`` calls at B_TRAIN_CHECK with ``cfg_c`` on
    the CPU and on the card from the CPU's initial weights, the augment fed
    the same CPU draws: losses and CE within 1e-4, decoder parameters within
    1e-5 of each leaf's scale, BatchNorm statistics within rtol 1e-3.  The
    encoder's update (its weights less the initial ones) is 0 on both where
    it is frozen; where it is finetuned, the same steps run on the CPU in
    float64 too, and the card's update must lie no farther from that one
    than twice the CPU's float32 update does: the float32 update through
    train-mode BatchNorm is ill-conditioned (on an H100 the card's and the
    CPU's differed by 1.4e-2 of its norm, and on the CPU float32 lay 5.6e-2
    from float64), so neither a leaf's scale nor a fixed bound measures it.
    Returns the errors and the card's losses."""
    import torch
    from sat_tpu_torch.data import transforms as TT
    from sat_tpu_torch.train import loop
    from sat_tpu_torch.vocab import Vocab
    cpu, real_draws = torch.device("cpu"), TT._draws
    batch = caption_batch(Vocab(cfg_c.vocab_stoi), B_TRAIN_CHECK, seed=18)
    hw = (cfg_c.input_size, cfg_c.input_size)
    step_draws = [real_draws(torch.Generator().manual_seed(draw_seed + i), B_TRAIN_CHECK,
                             hw, cfg_c, cpu) for i in range(3)]
    finetuned = cfg_c.encoder_finetune_after > 0
    runs, start = {}, None
    for name, d in (("cpu", cpu), ("card", dev)) + ((("cpu f64", cpu),) if finetuned else ()):
        fed = iter(step_draws)
        TT._draws = lambda g, b, hw, c, device: {k: v.to(device) for k, v in next(fed).items()}
        try:
            tr = loop.Trainer(cfg_c, device=d)
            if start is None:         # the CPU's initial weights, for all
                start = copy.deepcopy(tr.model.state_dict())
            else:
                tr.model.load_state_dict(start)
            if name == "cpu f64":
                tr.model.double()
                tr.augment = lambda g, x, aug=tr.augment: aug(g, x).double()
            runs[name] = (tr, torch.stack([torch.stack([m["loss"], m["ce_loss"]])
                                           for m in (tr.train_step(batch)
                                                     for _ in range(3))]).double().cpu())
        finally:
            TT._draws = real_draws
    (gpu, m_gpu), (ctr, m_cpu) = runs["card"], runs["cpu"]
    loss_rel = ((m_gpu - m_cpu).abs() / m_cpu.abs()).max().item()
    dec_err = max(max_rel_err(gpu.model.decoder.state_dict(),
                              ctr.model.decoder.state_dict()).values())
    update = {name: torch.cat([(p.detach().double().cpu() - start["encoder." + k].double()).flatten()
                               for k, p in tr.model.encoder.named_parameters()])
              for name, (tr, _) in runs.items()}
    norm = update["cpu f64" if finetuned else "cpu"].norm().item()
    gap = lambda a, b: (update[a] - update[b]).norm().item() / max(norm, 1e-300)
    enc = {"update_norm": norm, "card_vs_cpu": gap("card", "cpu")}
    if finetuned:
        enc.update(card_vs_f64=gap("card", "cpu f64"), cpu_vs_f64=gap("cpu", "cpu f64"))
    bn = bn_stats_err(gpu.model.encoder, ctr.model.encoder, rtol=1e-3)
    print(f"[{tag}] 3 {cfg_c.opt.upper()} steps at B={B_TRAIN_CHECK} on the same draws, "
          f"encoder finetuned from step {cfg_c.encoder_finetune_after} (0: frozen), card "
          f"against CPU: losses {m_gpu[:, 0].tolist()}, max rel err of loss and CE "
          f"{loss_rel:.2e}, decoder params {dec_err:.2e} of each leaf's scale, the "
          f"encoder's update over its norm {enc}, BatchNorm statistics' worst error over "
          f"rtol 1e-3: var {bn['var']['err']:.3g}, mean {bn['mean']['err']:.3g}", flush=True)
    check(loss_rel <= 1e-4, f"{tag}: loss and CE agree within 1e-4 ({loss_rel})")
    check(dec_err <= 1e-5, f"{tag}: decoder parameters within 1e-5 ({dec_err})")
    if finetuned:
        check(norm > 0 and enc["card_vs_f64"] <= 2 * enc["cpu_vs_f64"],
              f"{tag}: the card's encoder update within twice the CPU's float32 gap "
              f"to float64 ({enc})")
    else:
        check(norm == 0 and enc["card_vs_cpu"] == 0, f"{tag}: the frozen encoder stays ({enc})")
    check(bn["var"]["err"] <= 1 and bn["mean"]["err"] <= 1,
          f"{tag}: BatchNorm statistics within rtol 1e-3 ({bn})")
    return {"losses": m_gpu[:, 0].tolist(), "loss_ce_rel_err": loss_rel,
            "decoder_param_err": dec_err, "encoder_update": enc,
            "bn_var_err": bn["var"]["err"], "bn_mean_err": bn["mean"]["err"]}


def steps_on_one_batch(cfg, js, log_dir, dev, tag):
    """TRAIN_STEPS steps at B_TRAIN on the first batch of phase 9's train
    split, whose loss must fall by 10 % (random words over the locations
    leave the loss almost nothing to fall to: the attention term starts at
    its floor, the CE at ln V for words drawn uniformly, so the dataset's
    own captions), then the step's ms, busy ms by part and peak memory."""
    import torch
    from sat_tpu_torch.train import loop
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tr = loop.Trainer(cfg.replace(json=js), log_root=log_dir, device=dev)
    tr.train_loader.set_epoch(0)
    batch = next(iter(tr.train_loader))
    check(len(batch["images"]) == B_TRAIN, f"{tag}: a full batch")
    metrics = [tr.train_step(batch) for _ in range(TRAIN_STEPS)]
    loss = torch.stack([m["loss"] for m in metrics]).cpu()
    peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    first, last = loss[:5].mean().item(), loss[-5:].mean().item()
    print(f"[{tag}] {TRAIN_STEPS} steps at B={B_TRAIN} on phase 9's first batch "
          f"({cfg.encoder_arch}, encoder_size {cfg.encoder_size}, encoder finetuned from "
          f"step {cfg.encoder_finetune_after} (0: frozen), jitter {cfg.aug_color_jitter}, "
          f"optical {cfg.aug_optical_strength}): loss {loss[0]:.4f} -> {loss[-1]:.4f}, "
          f"mean of steps 1-5 {first:.4f}, of the last 5 {last:.4f} ({last / first:.3f}); "
          f"peak memory {peak:.3f} GiB above the {held / 2 ** 30:.3f} GiB held", flush=True)
    check(torch.isfinite(loss).all(), f"{tag}: finite losses")
    check(last <= 0.9 * first, f"{tag}: the loss falls by 10 % ({last} > 0.9 x {first})")
    step_ms = cuda_ms(lambda: tr.train_step(batch), warmup=2, reps=5)
    busy, parts = train_busy(tr, batch)
    return {"loss": loss.tolist(), "first5": first, "last5": last, "peak_memory_gib": peak,
            "step": {"ms": step_ms, "imgs_per_s": B_TRAIN / step_ms * 1e3,
                     "busy_ms": busy, "device_idle": 1 - busy / step_ms,
                     "busy_parts_ms": parts}}


def cli_serve_lightning(cfg, js, tmp, epochs, n_keys, dev, tag):
    """The training CLI with ``cfg`` for ``epochs`` epochs on phase 9's
    dataset, ``last.ckpt`` read back bit for bit; ``serve`` of it on phase
    10's JPEGs, the first 16 records equal to the CPU's; the checkpoint as
    a Lightning ``.ckpt`` read back bit for bit.  Returns (the report's
    entries, the model of ``last.ckpt`` on the card)."""
    import torch
    from sat_tpu_torch import serve
    from sat_tpu_torch.config import args_from_config
    from sat_tpu_torch.kernels import decoder_step as KS
    from sat_tpu_torch.models import lightning_export
    from sat_tpu_torch.train.checkpoints import load_any_checkpoint, load_model_from_checkpoint
    argv = args_from_config(cfg.replace(json=js, epochs=epochs)) + [
        "--log_root", os.path.join(tmp, "cli")]
    print(f"[{tag}] python -m sat_tpu_torch.train {' '.join(argv)}", flush=True)
    KS.launches = 0
    trainer, calls, window = logged_fit(argv, None)
    torch.cuda.synchronize()
    fit_calls = KS.launches
    epoch_loss = [v for _, v in points(calls, "loss/train_epoch")]
    last_ckpt = os.path.join(trainer.logdir, "last.ckpt")
    model, _ = load_model_from_checkpoint(last_ckpt, device=dev)
    sd, back = trainer.model.state_dict(), model.state_dict()
    exact = sd.keys() == back.keys() and all(torch.equal(sd[k], back[k]) for k in sd)
    steps = FIT_TRAIN // B_TRAIN * epochs
    print(f"[{tag}] {epochs} epochs: epoch mean losses {epoch_loss}, val "
          f"BLEU-4 {[v for _, v in points(calls, 'bleu4/val_epoch')]}, {fit_calls} "
          f"step-kernel calls in the validations, step {trainer.global_step}; last.ckpt "
          f"({os.path.getsize(last_ckpt) / 2 ** 20:.1f} MiB) reads back bit for bit: "
          f"{exact}", flush=True)
    check(all(np.isfinite(v) for v in epoch_loss) and len(epoch_loss) == epochs,
          f"{tag}: finite epoch losses")
    check(trainer.global_step == steps, f"{tag}: {trainer.global_step} steps")
    check(fit_calls > 0, f"{tag}: the validations ran the step kernels")
    check(exact, f"{tag}: last.ckpt gives every parameter and buffer bit for bit")
    out = {"argv": argv, "epoch_loss": epoch_loss, "step_calls": fit_calls,
           "profile_epoch_2": window, "last_ckpt": last_ckpt,
           "epochs": [{"wall_s": t["seconds"], "train_s": t["train"]["seconds"]}
                      for t in trainer.epoch_timings]}
    del trainer

    img_dir = os.path.join(tmp, "images")
    os.makedirs(img_dir)
    write_jpegs(img_dir, SERVE_N, seed=10)        # phase 10's files
    paths = serve.gather_images([img_dir])
    base = ["--checkpoint", last_ckpt, "--images", img_dir, "--batch", str(SERVE_BATCH),
            "--beamk", str(K_BEAM), "--rescore_method", "LN", "--precision", "32"]
    recs, calls_s, wall_s, tm = serve_run(base, os.path.join(tmp, "serve.jsonl"))
    cpu_recs, _, _, cpu_tm = serve_run(
        ["--checkpoint", last_ckpt, "--images", *paths[:16], "--batch", "16"] + base[6:],
        os.path.join(tmp, "serve_cpu.jsonl"), device="cpu")
    same16 = sum(g["caption"] == c["caption"] for g, c in zip(recs[:16], cpu_recs))
    gaps = [max(abs(g["score"] - c["score"]), abs(g["perplexity"] - c["perplexity"]))
            for g, c in zip(recs[:16], cpu_recs)]
    print(f"[{tag}] serve of last.ckpt on phase 10's {len(paths)} files ({tm['route']}): "
          f"{len(recs)} records, {calls_s} step-kernel calls, {wall_s:.2f} s; first 16 "
          f"against the CPU ({cpu_tm['route']}): {same16}/16 captions equal, largest score "
          f"or perplexity gap {max(gaps):.2e}; e.g. {recs[0].get('caption')!r}", flush=True)
    check(len(recs) == SERVE_N + 1 and sum("error" in r for r in recs) == 1,
          f"{tag}: serve gives a record per file, one error")
    check(calls_s > 0, f"{tag}: serve ran the step kernels")
    check(cpu_tm["route"] == tm["route"] and same16 == 16 and max(gaps) <= 1e-4,
          f"{tag}: {same16}/16 captions equal to the CPU's, gap {max(gaps)}")
    lt = os.path.join(tmp, "lightning.ckpt")
    lightning_export.main(["--input", last_ckpt, "--output", lt])
    a_sd, b_sd = load_any_checkpoint(last_ckpt).state_dict(), load_any_checkpoint(lt).state_dict()
    lt_exact = a_sd.keys() == b_sd.keys() and all(torch.equal(a_sd[k], b_sd[k]) for k in a_sd)
    print(f"[{tag}] the Lightning .ckpt ({os.path.getsize(lt) / 2 ** 20:.1f} MiB, "
          f"{n_keys} backbone keys in the torchvision file it started from) reads back "
          f"bit for bit: {lt_exact}", flush=True)
    check(lt_exact, f"{tag}: the Lightning file gives every leaf bit for bit")
    out.update(serve_records=len(recs), serve_step_calls=calls_s,
               serve_cpu_equal_of_16=same16, serve_cpu_max_gap=max(gaps),
               lightning_bit_for_bit=lt_exact)
    return out, model


def main_path_and_times(model, imgs, kc, train, card, tag, extra=None):
    """The slice's main path, counted: greedy and beam captioning of
    ``model`` on ``imgs`` (encode, then the loop kernel; encode, then the
    step kernels at B k rows); then the times of encode, the step at N =
    B_BEAM and the loop on ``kc``'s arguments (``decode_kernel_checks``),
    greedy and beam captioning and ``extra``'s functions; the train step
    ``train`` (``steps_on_one_batch``) where given; both kernels' bounds and
    their entries of the ``kernels`` line."""
    import torch
    from sat_tpu_torch.decode.beam import greedy_decode
    from sat_tpu_torch.kernels import decoder_step as KS
    from sat_tpu_torch.kernels import greedy_loop as KL
    KS.launches = KL.launches = 0
    res = greedy_decode(model.decoder, model.cfg, model.encode(imgs), max_gen_length=S)
    caps = model.caption(imgs, beamk=K_BEAM, max_gen_length=S, rescore_method="LN")[0]
    torch.cuda.synchronize()
    launches = {"decoder_step": KS.launches, "greedy_loop": KL.launches}
    print(f"[{tag}] main path launches (greedy, then beam captioning of {B} images): "
          f"{launches}", flush=True)
    check(launches == {"decoder_step": S + 1, "greedy_loop": 1},
          f"{tag}: the main path ran the loop kernel once and the step kernels per step")
    check(res.tokens.shape == (B, 1, S + 2) and len(caps) == B, f"{tag}: result shapes")

    la, a192 = kc["la"], kc["args"][B_BEAM]
    times = {
        "encode": timed(lambda: model.encode(imgs)),
        "decoder_step_192": timed(lambda: KS.fused_decoder_step(*a192),
                                  "decoder_step_", calls=20, profiled=10,
                                  parts=KS.KERNELS),
        "decoder_step_192_plain": timed(lambda: KS.fused_decoder_step_plain(*a192),
                                        calls=20, profiled=10),
        "greedy_loop": timed(lambda: KL.greedy_loop(*la, max_gen_length=S), "greedy_loop_",
                             parts=KL.PHASES),
        "greedy_loop_plain": timed(lambda: KL.greedy_loop_plain(*la, max_gen_length=S)),
        "greedy_captioning": timed(lambda: greedy_decode(
            model.decoder, model.cfg, model.encode(imgs), max_gen_length=S)),
        "beam_captioning": timed(lambda: model.caption(
            imgs, beamk=K_BEAM, max_gen_length=S, rescore_method="LN"), reps=5),
    }
    times.update({k: timed(fn) for k, fn in (extra or {}).items()})
    for k, t in times.items():
        rate = f" per batch of {B}, {B / t['ms'] * 1e3:.0f} imgs/s" if "captioning" in k \
            or k == "encode" else ""
        parts = t.get("busy_parts_ms")
        tail = "" if not parts else "; busy by kernel: " + ", ".join(
            f"{p} {'not measured' if v is None else f'{v * 1e3:.1f} us'}"
            for p, v in parts.items())
        print(f"[time] {tag} ({card}) " + fmt_time(k, t, rate) + tail, flush=True)
    if train is not None:
        st = train["step"]
        print(f"[time] {tag} ({card}) train step at B={B_TRAIN}: {st['ms']:.3f} ms, "
              f"{st['imgs_per_s']:.0f} imgs/s, busy {st['busy_ms']:.3f} ms, device idle "
              f"{st['device_idle']:.1%}, peak memory {train['peak_memory_gib']:.3f} GiB; "
              "busy by part: " + ", ".join(f"{k} {v:.3f} ms"
                                           for k, v in st["busy_parts_ms"].items()),
              flush=True)
    # bounds: inputs read once, outputs written once; this run's operations
    vcfg, (L, D) = la[-5], (kc["L"], kc["D"])
    H, E, A, V = vcfg.decoder_dim, vcfg.embed_dim, vcfg.attention_dim, vcfg.vocab_size
    step_out = KS.fused_decoder_step(*a192)
    step_bound, step_by = bound(nbytes(*a192[0], *a192[2:], *step_out),
                                B_BEAM * step_flops(L, D, A, H, E), "float32")
    kl = kc["loop"][2]
    steps_run = torch.where(kl[4], kl[3] + 1, S + 1).sum().item()
    loop_bound, loop_by = bound(nbytes(*la[-4:], *la[0], *la[1:-5], *kl),
                                steps_run * (step_flops(L, D, A, H, E) + 2 * E * V), "float32")
    print(f"[time] {tag} bounds: step at N={B_BEAM} {step_bound:.4f} ms ({step_by}); "
          f"greedy loop at B={B}, V={V}, {steps_run} row-steps {loop_bound:.4f} ms "
          f"({loop_by})", flush=True)
    kernels = [
        {"name": f"decoder_step_L{L}_D{D}", "route": "cuda",
         "source": "sat_tpu_torch/csrc/decoder_step.cu",
         "replaces": "sat_tpu/kernels/decoder_step.py:72",
         "launches": launches["decoder_step"], "rows": B_BEAM,
         "max_abs_err": max(kc["step_err"][B_BEAM].values()),
         "ms": times["decoder_step_192"]["ms"],
         "plain_ms": times["decoder_step_192_plain"]["ms"],
         "bound_ms": step_bound, "bound_by": step_by, "library_ms": None},
        {"name": f"greedy_loop_L{L}_D{D}_V{V}", "route": "cuda",
         "source": "sat_tpu_torch/csrc/greedy_loop.cu",
         "replaces": "sat_tpu/kernels/greedy_loop.py:42",
         "launches": launches["greedy_loop"], "rows": B, "max_abs_err": kc["loop"][1],
         "ms": times["greedy_loop"]["ms"], "plain_ms": times["greedy_loop_plain"]["ms"],
         "bound_ms": loop_bound, "bound_by": loop_by, "library_ms": None},
    ]
    return {"launches": launches, "times": times, "kernels": kernels,
            "bounds": dict(step_bound_ms=step_bound, step_bound_by=step_by,
                           loop_bound_ms=loop_bound, loop_bound_by=loop_by,
                           loop_rows_steps=steps_run)}


def phase_seconds(stamps, n):
    stamps["end"] = time.perf_counter()
    names = list(stamps)
    out = {a: stamps[b] - stamps[a] for a, b in zip(names, names[1:])}
    print(f"[time] seconds per part of phase {n}: " + ", ".join(
        f"{k} {v:.1f}" for k, v in out.items()), flush=True)
    return out


def resnet_phase(dev, js, card):
    """Phase 13: the ResNet configuration with the full augmentation
    (module docstring); ``js`` is phase 9's dataset."""
    import torch
    from sat_tpu_torch.data import transforms as TT
    from sat_tpu_torch.models.backbones import RESNET_ARCHS
    from sat_tpu_torch.models.model import SATModel
    from sat_tpu_torch.train.checkpoints import read_checkpoint_config

    out, stamps = {}, {"a encoders": time.perf_counter()}
    cpu = torch.device("cpu")
    # (a) every ResNet-family encoder, card against CPU, eval and train mode
    out["a_encoders"] = encoders_card_vs_cpu(RESNET_ARCHS, dev, RESNET_PX, 13, 40, "resnet (a)")

    # (a) the decode kernels at L 196, D 2048, V 4096
    stamps["a kernels"] = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="sat_resnet_")
    weights = os.path.join(tmp, f"{RESNET_ARCH}_torchvision.pt")
    n_keys = write_torchvision_weights(RESNET_ARCH, RESNET_PX, weights, 50, dev)
    vcfg = vocab_config(V_REF, RESNET_ARCH, RESNET_PX, RESNET_SIZE, 2048).replace(
        pretrained=True, pretrained_weights=weights)
    ref_model = SATModel.create(vcfg, torch.Generator(dev).manual_seed(51)).eval()
    imgs192 = torch.from_numpy(scenes(B_BEAM, RESNET_PX, seed=14)).to(dev)
    kc = decode_kernel_checks(ref_model, imgs192, (B, B_BEAM), "resnet (a)")
    check((kc["L"], kc["D"]) == (RESNET_SIZE ** 2, 2048),
          f"resnet (a): annotations {kc['L']} x {kc['D']}")
    out["plans"] = kc["plans"]
    out["a_kernels"] = {"step_err": kc["step_err"], "loop_agreement": kc["loop"][0],
                        "loop_err": kc["loop"][1], "loop_agreement_bf16": kc["loop_bf16"][0],
                        "loop_err_bf16": kc["loop_bf16"][1]}

    # (b) the augment, card against CPU on the CPU's draws
    stamps["b augment"] = time.perf_counter()
    real_draws = TT._draws
    header = read_checkpoint_config(CKPT)
    u8 = torch.from_numpy(np.rint(scenes(AUG_B, RESNET_PX, seed=16) * 255).astype(np.uint8))
    aug_err = {}
    for label, kw in (("f32", dict(precision=32)), ("bf16", dict(precision=16)),
                      ("bf16 jitter only", dict(precision=16, aug_optical_strength=0.0))):
        acfg = header.replace(input_size=RESNET_PX, aug_hflip=0.5, aug_color_jitter=AUG_JITTER,
                              aug_optical_strength=AUG_OPTICAL).replace(**kw)
        d = real_draws(torch.Generator().manual_seed(17), AUG_B, (RESNET_PX, RESNET_PX), acfg, cpu)
        if "choice" in d:     # each warp on a third of the images
            d["choice"] = torch.arange(AUG_B) % 3
        TT._draws = lambda g, b, hw, c, device: {k: v.to(device) for k, v in d.items()}
        try:
            aug = TT.build_train_augment(acfg)
            ref = aug(torch.Generator(), u8)
            got = aug(torch.Generator(dev), u8.to(dev)).cpu()
        finally:
            TT._draws = real_draws
        check(got.dtype == ref.dtype and got.shape == ref.shape and torch.isfinite(got).all(),
              f"resnet (b) {label}: type, shape, finite")
        diff = (got.float() - ref.float()).abs()
        if got.dtype == torch.bfloat16:
            # the card's and the CPU's bf16 operations round their float
            # results alike, but not every intermediate: where the hue h
            # (in [0, 1)) lands one bf16 step (2^-8) apart, the sector
            # fraction 6 h - floor(6 h) moves 6 times that, and a channel by
            # up to that plus a rounding at 1: 2^-5 in all
            ulp = torch.exp2(torch.floor(torch.log2(ref.float().abs().clamp_min(1e-30))) - 7)
            worst = diff.max().item()
            print(f"[resnet] (b) {label}: {int((diff > 0).sum())} of {diff.numel()} values "
                  f"differ, by up to {(diff / ulp).max().item():.0f} of their own bf16 ulps, "
                  f"{worst:.3g} in all", flush=True)
            check(worst <= 2 ** -5, f"resnet (b) {label}: within 2^-5 ({worst})")
        else:
            # the homographies differ by a float32 rounding (sin, cos, tan and
            # the 8 x 8 solve are the card's and the CPU's own): coordinates up
            # to 224 px move by ~1e-5 px, values by that times the image's slope
            worst = diff.max().item()
            check(worst <= 2e-4, f"resnet (b) {label}: within 2e-4 ({worst})")
        aug_err[label] = {"dtype": str(got.dtype), "max_err": worst}
    print(f"[resnet] (b) augment at B={AUG_B}, {RESNET_PX} px, jitter {AUG_JITTER}, optical "
          f"{AUG_OPTICAL}, crop {header.aug_scale}, flip 0.5, noise {header.aug_noise_std}, "
          f"each warp on a third of the images, card against CPU on the CPU's draws: "
          f"{aug_err} (max abs)", flush=True)
    out["b"] = aug_err

    # (c) training steps at the slice's configuration
    stamps["c train"] = time.perf_counter()
    cfg13 = header.replace(precision=32, device_resident_data=False, resume=None, json=None,
                           input_size=RESNET_PX, batch=B_TRAIN, encoder_arch=RESNET_ARCH, encoder_size=RESNET_SIZE,
                           encoder_dim=None, pretrained=True, pretrained_weights=weights,
                           aug_color_jitter=AUG_JITTER, aug_optical_strength=AUG_OPTICAL)
    out["c"] = steps_card_vs_cpu(
        cfg13.replace(opt="sgd", momentum=0.0, decoder_tf="always", dropout=0.0,
                      embedding_dropout=0.0, batch=B_TRAIN_CHECK), dev, 60, "resnet (c)")
    out["c"].update(steps_on_one_batch(cfg13, js, os.path.join(tmp, "c"), dev, "resnet (c)"))

    # (d) the training CLI, serve and the Lightning file
    stamps["d cli"] = time.perf_counter()
    out["d"], model = cli_serve_lightning(cfg13, js, tmp, RESNET_EPOCHS, n_keys, dev,
                                        "resnet (d)")
    check(model.grid_hw == (RESNET_SIZE, RESNET_SIZE), f"resnet (d): grid {model.grid_hw}")

    # the slice's main path, counted, and (e) times with the augment's
    stamps["main path, e times"] = time.perf_counter()
    u64 = torch.from_numpy(np.rint(scenes(B_TRAIN, RESNET_PX, seed=20) * 255).astype(np.uint8)).to(dev)
    extra = {}
    for label, c in (("crop + noise", header.replace(precision=32, input_size=RESNET_PX)),
                     ("crop + noise + jitter + optical", cfg13)):
        aug, g = TT.build_train_augment(c), torch.Generator(dev).manual_seed(0)
        extra[f"augment {label}"] = lambda aug=aug, g=g: aug(g, u64)
    run = main_path_and_times(model, imgs192[:B], kc, out["c"], card, "resnet", extra)
    out.update(launches=run["launches"], kernels=run["kernels"], e=dict(run["times"], **run["bounds"]))
    shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = phase_seconds(stamps, 13)
    return out


def mobilenet_phase(dev, js, card):
    """Phase 14: ``BASELINE.json``'s first configuration (module
    docstring); ``js`` is phase 9's dataset."""
    import torch
    from sat_tpu_torch.models.model import SATModel
    from sat_tpu_torch.train.checkpoints import read_checkpoint_config

    out, stamps = {}, {"a encoders": time.perf_counter()}
    # (a) the seven inverted-residual encoders, card against CPU, eval and train
    out["a_encoders"] = encoders_card_vs_cpu(MOBILE_ARCHS, dev, MOBILE_PX, 21, 70,
                                             "mobilenet (a)")
    out["a_bf16"] = bf16_encoder_card_vs_cpu(MOBILE_ARCH, dev, MOBILE_PX, 77, 23, "mobilenet (a)")

    # (a) the decode kernels at L 49, D 576 (V 4096), and the step at D 960, 1280
    stamps["a kernels"] = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="sat_mobilenet_")
    weights = os.path.join(tmp, f"{MOBILE_ARCH}_torchvision.pt")
    n_keys = write_torchvision_weights(MOBILE_ARCH, MOBILE_PX, weights, 80, dev)
    vcfg = vocab_config(V_REF, MOBILE_ARCH, MOBILE_PX, None, MOBILE_D).replace(
        pretrained=True, pretrained_weights=weights)
    ref_model = SATModel.create(vcfg, torch.Generator(dev).manual_seed(81)).eval()
    imgs192 = torch.from_numpy(scenes(B_BEAM, MOBILE_PX, seed=22)).to(dev)
    kc = decode_kernel_checks(ref_model, imgs192, (B, B_BEAM), "mobilenet (a)")
    check((kc["L"], kc["D"]) == ((MOBILE_PX // 32) ** 2, MOBILE_D),
          f"mobilenet (a): annotations {kc['L']} x {kc['D']}")
    out["plans"] = kc["plans"]
    out["a_kernels"] = {"step_err": kc["step_err"], "loop_agreement": kc["loop"][0],
                        "loop_err": kc["loop"][1], "loop_agreement_bf16": kc["loop_bf16"][0],
                        "loop_err_bf16": kc["loop_bf16"][1]}
    for i, (arch, d) in enumerate(MOBILE_WIDE):
        m = SATModel.create(vocab_config(V_REF, arch, MOBILE_PX, None, d),
                            torch.Generator(dev).manual_seed(82 + i)).eval()
        wk = decode_kernel_checks(m, imgs192, (B_BEAM,), f"mobilenet (a) {arch}", loop=False)
        check(wk["D"] == d, f"mobilenet (a): {arch} D {wk['D']}")
        out["a_kernels"][f"step_err_D{d}"] = wk["step_err"]
        del m, wk

    # (b) training steps with the encoder finetuned from step 1
    stamps["b train"] = time.perf_counter()
    header = read_checkpoint_config(CKPT)
    cfg14 = header.replace(precision=32, device_resident_data=False, resume=None, json=None,
                           input_size=MOBILE_PX, batch=B_TRAIN, encoder_arch=MOBILE_ARCH,
                           encoder_size=None, encoder_dim=None, pretrained=True,
                           pretrained_weights=weights, encoder_finetune_after=1)
    check(cfg14.encoder_lr > 0, "mobilenet (b): the encoder trains")
    out["b"] = steps_card_vs_cpu(
        cfg14.replace(opt="sgd", momentum=0.0, decoder_tf="always", dropout=0.0,
                      embedding_dropout=0.0, batch=B_TRAIN_CHECK), dev, 90, "mobilenet (b)")
    out["b"].update(steps_on_one_batch(cfg14, js, os.path.join(tmp, "b"), dev, "mobilenet (b)"))

    # (c) the training CLI, serve and the Lightning file
    stamps["c cli"] = time.perf_counter()
    out["c"], model = cli_serve_lightning(cfg14, js, tmp, MOBILE_EPOCHS, n_keys, dev,
                                        "mobilenet (c)")
    check(model.grid_hw == (MOBILE_PX // 32,) * 2, f"mobilenet (c): grid {model.grid_hw}")

    # the slice's main path, counted, and (d) times
    stamps["main path, d times"] = time.perf_counter()
    run = main_path_and_times(model, imgs192[:B], kc, out["b"], card, "mobilenet")
    out.update(launches=run["launches"], kernels=run["kernels"], d=dict(run["times"], **run["bounds"]))
    shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = phase_seconds(stamps, 14)
    return out


def densenet_phase(dev, js, card):
    """Phase 15: the densenet121 configuration, with squeezenet1_1 beside
    it (module docstring); ``js`` is phase 9's dataset."""
    import torch
    from sat_tpu_torch.config import SATConfig
    from sat_tpu_torch.evalx import encoder_sweep
    from sat_tpu_torch.models.encoder import probe_encoder
    from sat_tpu_torch.models.model import SATModel
    from sat_tpu_torch.train import loop
    from sat_tpu_torch.train.checkpoints import read_checkpoint_config

    out, stamps = {}, {"a encoders": time.perf_counter()}
    # (a) the six SqueezeNet and DenseNet encoders, card against CPU, eval and
    # train; densenet121 in bf16, cast as serve casts the model
    out["a_encoders"] = encoders_card_vs_cpu(DENSE_ARCHS, dev, DENSE_PX, 31, 100,
                                             "densenet (a)")
    out["a_bf16"] = bf16_encoder_card_vs_cpu(DENSE_ARCH, dev, DENSE_PX, 107, 33, "densenet (a)")

    # (a) the decode kernels at L 49, D 1024 and at squeezenet1_1's L 169, D 512
    # (V 4096), and the step at D 1664, 1920, 2208
    stamps["a kernels"] = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="sat_densenet_")
    imgs192 = torch.from_numpy(scenes(B_BEAM, DENSE_PX, seed=32)).to(dev)
    weights_of, kcs, n_keys = {}, {}, {}
    for i, (arch, d) in enumerate(((DENSE_ARCH, DENSE_D), (SQUEEZE_ARCH, SQUEEZE_D))):
        weights = os.path.join(tmp, f"{arch}_torchvision.pt")
        n_keys[arch] = write_torchvision_weights(arch, DENSE_PX, weights, 110 + i, dev)
        vcfg = vocab_config(V_REF, arch, DENSE_PX, None, d).replace(
            pretrained=True, pretrained_weights=weights)
        ref_model = SATModel.create(vcfg, torch.Generator(dev).manual_seed(112 + i)).eval()
        kc = decode_kernel_checks(ref_model, imgs192, (B, B_BEAM), f"densenet (a) {arch}")
        _, (h, w) = probe_encoder(vcfg)
        check((kc["L"], kc["D"]) == (h * w, d), f"densenet (a): {arch} annotations "
              f"{kc['L']} x {kc['D']}")
        kcs[arch], weights_of[arch] = kc, weights
        out[f"a_kernels_{arch}"] = {
            "plans": kc["plans"], "step_err": kc["step_err"], "loop_agreement": kc["loop"][0],
            "loop_err": kc["loop"][1], "loop_agreement_bf16": kc["loop_bf16"][0],
            "loop_err_bf16": kc["loop_bf16"][1]}
        del ref_model
    for i, (arch, d) in enumerate(DENSE_WIDE):
        m = SATModel.create(vocab_config(V_REF, arch, DENSE_PX, None, d),
                            torch.Generator(dev).manual_seed(114 + i)).eval()
        wk = decode_kernel_checks(m, imgs192, (B_BEAM,), f"densenet (a) {arch}", loop=False)
        check(wk["D"] == d, f"densenet (a): {arch} D {wk['D']}")
        out[f"a_step_err_D{d}"] = wk["step_err"]
        del m, wk

    # (b) training steps with the encoder finetuned from step 1
    stamps["b train"] = time.perf_counter()
    header = read_checkpoint_config(CKPT)
    cfg15 = {arch: header.replace(
        precision=32, device_resident_data=False, resume=None, json=None,
        input_size=DENSE_PX, batch=B_TRAIN, encoder_arch=arch, encoder_size=None,
        encoder_dim=None, pretrained=True, pretrained_weights=weights_of[arch],
        encoder_finetune_after=1) for arch in (DENSE_ARCH, SQUEEZE_ARCH)}
    c15 = cfg15[DENSE_ARCH]
    check(c15.encoder_lr > 0, "densenet (b): the encoder trains")
    out["b"] = steps_card_vs_cpu(
        c15.replace(opt="sgd", momentum=0.0, decoder_tf="always", dropout=0.0,
                    embedding_dropout=0.0, batch=B_TRAIN_CHECK), dev, 120, "densenet (b)")
    out["b"].update(steps_on_one_batch(c15, js, os.path.join(tmp, "b"), dev, "densenet (b)"))

    # (c) the training CLI, serve and the Lightning file: densenet121 for
    # DENSE_EPOCHS, squeezenet1_1 (no BatchNorm: empty batch_stats) for 1;
    # squeezenet1_1's last.ckpt resumes in a Trainer bit for bit
    stamps["c cli"] = time.perf_counter()
    cli_models = {}
    for arch, epochs in ((DENSE_ARCH, DENSE_EPOCHS), (SQUEEZE_ARCH, 1)):
        sub = os.path.join(tmp, f"c_{arch}")
        os.makedirs(sub)
        res, cli_models[arch] = cli_serve_lightning(cfg15[arch], js, sub, epochs, n_keys[arch],
                                                    dev, f"densenet (c) {arch}")
        _, (h, w) = probe_encoder(cfg15[arch])
        check(cli_models[arch].grid_hw == (h, w), f"densenet (c): {arch} grid "
              f"{cli_models[arch].grid_hw}")
        out[f"c_{arch}"] = res
    sq = cli_models[SQUEEZE_ARCH]
    check(not any(isinstance(m, torch.nn.BatchNorm2d) for m in sq.modules()),
          "densenet (c): squeezenet1_1 has no BatchNorm")
    last = out[f"c_{SQUEEZE_ARCH}"]["last_ckpt"]
    resumed = loop.Trainer(cfg15[SQUEEZE_ARCH].replace(json=js, resume=last),
                           log_root=os.path.join(tmp, "c_resume"), device=dev)
    a_sd, b_sd = sq.state_dict(), resumed.model.state_dict()
    moments = [st for st in resumed.optimizer.state.values() if st]
    resume_exact = a_sd.keys() == b_sd.keys() and all(torch.equal(a_sd[k], b_sd[k]) for k in a_sd)
    print(f"[densenet (c)] {SQUEEZE_ARCH}'s last.ckpt resumed: step {resumed.global_step}, "
          f"epoch {resumed.current_epoch}, weights bit for bit {resume_exact}, "
          f"{len(moments)} parameters with optimizer state", flush=True)
    check(resume_exact and resumed.global_step == FIT_TRAIN // B_TRAIN and len(moments) > 0,
          f"densenet (c): {SQUEEZE_ARCH} resumes from its last.ckpt")
    out["c_resume"] = {"step": resumed.global_step, "bit_for_bit": resume_exact,
                       "params_with_state": len(moments)}
    del resumed

    # the slice's main path, counted, and (d) times, at both shapes
    stamps["main path, d times"] = time.perf_counter()
    out["kernels"], out["launches"] = [], {}
    for arch, tag, train in ((DENSE_ARCH, "densenet", out["b"]),
                             (SQUEEZE_ARCH, "squeezenet", None)):
        run = main_path_and_times(cli_models[arch], imgs192[:B], kcs[arch], train, card, tag)
        out["kernels"] += run["kernels"]
        out["launches"][arch] = run["launches"]
        out[f"d_{arch}"] = dict(run["times"], **run["bounds"])
    del cli_models, sq

    # (e) the encoder sweep at its default bf16, B 32 and 128
    stamps["e sweep"] = time.perf_counter()
    out["e"] = {}
    for batch in SWEEP_BATCHES:
        argv = ["--archs", *SWEEP_ARCHS, "--batch", str(batch), "--input_size", str(DENSE_PX)]
        print(f"[densenet (e)] python -m sat_tpu_torch.evalx.encoder_sweep {' '.join(argv)} "
              f"({card})", flush=True)
        rows = encoder_sweep.main(argv)
        check([r["arch"] for r in rows] == list(SWEEP_ARCHS), "densenet (e): a row per arch")
        for row in rows:
            d, (h, w) = probe_encoder(SATConfig(encoder_arch=row["arch"], input_size=DENSE_PX))
            check((row["features"], row["attention"]) == (d, h * w),
                  f"densenet (e): {row['arch']} {row['features']} x {row['attention']}")
            check(all(0 < row[k] < float("inf") for k in
                      ("latency_ms", "batches_per_sec", "imgs_per_sec")),
                  f"densenet (e): {row['arch']} rates finite and positive ({row})")
        out["e"][batch] = rows
    shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = phase_seconds(stamps, 15)
    return out


def cpu_fit():
    """Phase 9 (d) on the CPU (``--cpu-fit``): the same dataset and CLI
    run, printing the epoch-3 / epoch-1 loss ratio."""
    sys.path.insert(0, ROOT)
    from sat_tpu_torch.data.compositional import make_compositional_dataset
    from sat_tpu_torch.train.checkpoints import read_checkpoint_config

    with tempfile.TemporaryDirectory(prefix="sat_fit_") as tmp:
        js = make_compositional_dataset(tmp, n_train=FIT_TRAIN, n_val=FIT_VAL,
                                        n_test=8, image_size=224, n_nouns=64, seed=0)
        cfg = read_checkpoint_config(CKPT).replace(
            precision=32, device_resident_data=False, resume=None, json=js)
        t0 = time.perf_counter()
        trainer, calls, _ = logged_fit(fit_argv(cfg, os.path.join(tmp, "d")), "cpu")
        loss = [v for _, v in points(calls, "loss/train_epoch")]
        print(json.dumps({"cpu_fit": {"epoch_loss": loss, "ratio": loss[-1] / loss[0],
                                      "val_bleu4": [v for _, v in points(calls, "bleu4/val_epoch")],
                                      "seconds": time.perf_counter() - t0}}))
    return 0


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from sat_tpu_torch.decode.api import unpack_beam_result
    from sat_tpu_torch.decode.beam import beam_search, greedy_decode
    from sat_tpu_torch.kernels import _build
    from sat_tpu_torch.kernels import decoder_step as KS
    from sat_tpu_torch.kernels import greedy_loop as KL
    from sat_tpu_torch.models import decoder as TD
    from sat_tpu_torch.train.checkpoints import load_model_from_checkpoint

    report, stamps = {}, {"device": time.perf_counter()}
    dev = torch.device(DEVICE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. device ------------------------------------------------------------
    card = card_line()
    print(card)
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {kind}, {torch.cuda.device_count()} visible, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    report["card"] = card

    # -- 2. build ---------------------------------------------------------------
    stamps["build"] = time.perf_counter()
    t0 = time.perf_counter()
    for k, log in _build.build().items():
        for kern, typ, regs, spill in ptxas_summary(log):
            print(f"[ptxas] {k} {kern} {typ}: {regs}; {spill}")
            check(not (kern.startswith(("greedy_loop_", "decoder_step_"))
                       and spilled(spill)), f"{kern} {typ} spills")
    for name in _build.SOURCES:
        _build.load(name)
    report["build_s"] = time.perf_counter() - t0
    print(f"[build] {', '.join(_build.SOURCES)} built and loaded in "
          f"{report['build_s']:.1f} s", flush=True)

    # -- 3. kernels against their plain versions --------------------------------
    stamps["kernels"] = time.perf_counter()
    model, _ = load_model_from_checkpoint(CKPT)       # device defaults to cuda
    cfg, params = model.cfg, model.decoder
    imgs = torch.from_numpy(scenes(B, cfg.input_size, seed=0)).to(dev)
    annots = model.encode(imgs)
    L, D = annots.shape[1:]
    att_enc = TD.attention_precompute(params, annots)
    h0, c0 = TD.init_lstm_state(params, annots, cfg)
    h0, c0 = h0[0].contiguous(), c0[0].contiguous()
    fw = KS.pack_fused_weights(params, cfg, torch.float32)
    sw = KS.pack_loop_weights(fw)
    H, E, A, V = cfg.decoder_dim, cfg.embed_dim, cfg.attention_dim, cfg.vocab_size
    plans = {"greedy loop phases": KL.loop_plan(B, L, D, A, H, E, V),
             "decoder step kernels": KS.step_plan(B, L, D, A, H, E)}
    report["loop_plan"], report["step_plan"] = plans.values()
    for what, plan in plans.items():
        print(f"[design] {what}, f32 B={B}: " + "; ".join(
            f"{k} grid {g} x {n} threads, smem {dyn} B dynamic + {st} B static"
            for k, (g, n, dyn, st) in plan.items()), flush=True)
        for k in ("hside", "gates", "deepout"):
            check(plan[k][0][0] * plan[k][0][1] * plan[k][0][2] >= 64,
                  f"{what}: {k} fills 64 blocks")
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        1, cfg.vocab_size, size=B)).to(dev)
    e = TD.embed_tokens(params, ids, cfg).contiguous()

    # float32 sums taken in another order: ~1e-6 of the operands' scale;
    # 1e-4 of each output's own scale leaves two orders of margin (z
    # carries the annotations' scale, ~200 at n64)
    step_args = (sw, cfg, e, h0, c0, annots, att_enc)
    got, step_err = check_step(f"f32 B={B}", step_args)
    # bfloat16: outputs may differ by one rounding step of the output type
    bf = lambda x: x.to(torch.bfloat16).contiguous()
    step_args16 = (KS.step_weights(params, cfg, torch.bfloat16), cfg,
                   *map(bf, (e, h0, c0, annots, att_enc)))
    _, step_err16 = check_step(f"bf16 B={B}", step_args16, rel=1e-2)

    lw = KL.loop_weights(params, cfg, torch.float32)
    loop_args = (*lw, cfg, annots, att_enc, h0, c0)
    rate, loop_err, kl = check_loop(f"f32 B={B} S={S}", loop_args)

    # other shapes: several 64-row tiles (B_BEAM, B_WIDE), and the golden
    # checkpoint's narrow widths (H 12, A 8, E 8, V 24, L 1) for the ragged
    # tiles and the scalar GEMV paths
    golden, _ = load_model_from_checkpoint(GOLDEN)
    for label, m, n in ((f"n64 B={B_BEAM}", model, B_BEAM),
                        (f"n64 B={B_WIDE}", model, B_WIDE), ("golden B=13", golden, 13)):
        x = torch.from_numpy(scenes(n, m.cfg.input_size, seed=2)).to(dev)
        an = m.encode(x)
        ae = TD.attention_precompute(m.decoder, an)
        hh, cc = TD.init_lstm_state(m.decoder, an, m.cfg)
        hh, cc = hh[0].contiguous(), cc[0].contiguous()
        ee = TD.embed_tokens(m.decoder, torch.full((n,), 3, device=dev), m.cfg)
        args = (KS.step_weights(m.decoder, m.cfg), m.cfg, ee, hh, cc, an, ae)
        got_n, err_n = check_step(label, args)
        if n == B_BEAM and m is model:
            beam_step_args, beam_step_out, beam_step_err = args, got_n, err_n
        check_loop(label, (*KL.loop_weights(m.decoder, m.cfg, torch.float32), m.cfg,
                           an, ae, hh, cc))

    # -- 4. greedy path -------------------------------------------------------------
    stamps["greedy"] = time.perf_counter()
    KS.launches = KL.launches = 0
    model, _ = load_model_from_checkpoint(CKPT)
    annots = model.encode(imgs)
    res_loop = greedy_decode(model.decoder, model.cfg, annots, max_gen_length=S)
    res_step = greedy_decode(model.decoder, model.cfg, annots, max_gen_length=S,
                             fused=True)
    res_plain = greedy_decode(model.decoder, model.cfg, annots, max_gen_length=S,
                              fused=False)
    captions, scores, alphas, _ = unpack_beam_result(res_loop, model.grid_hw)
    torch.cuda.synchronize()
    launches = {"decoder_step": KS.launches, "greedy_loop": KL.launches}
    print(f"[main] launches in the main path: {launches}", flush=True)
    check(launches["greedy_loop"] > 0 and launches["decoder_step"] > 0,
          "both kernels launched on the main path")
    words = [" ".join(model.vocab.itos(t) for t in c) for c in captions]
    for w in words[:4]:
        print(f"[main] caption: {w}")
    for r in (res_loop, res_step, res_plain):
        check(r.tokens.shape == (B, 1, S + 2) and r.alphas.shape == (B, 1, S + 1, L),
              "result shapes")
        check(torch.isfinite(r.scores).all() and torch.isfinite(r.alphas).all(),
              "scores and alphas are finite")
    agree = {"loop_vs_plain": agreement(res_loop, res_plain).float().mean().item(),
             "step_vs_plain": agreement(res_step, res_plain).float().mean().item()}
    check(min(agree.values()) >= 0.99, f"token agreement {agree}")
    check(all(len(a) == len(c) for a, c in zip(alphas, captions)),
          "one attention map per caption word")
    n_done = int((res_loop.lengths < S).sum())
    print(f"[main] token agreement {agree}; {n_done}/{B} captions end before "
          f"max_gen_length", flush=True)
    # reference on a small input: the same images through the port on the CPU
    cpu_model, _ = load_model_from_checkpoint(CKPT, device="cpu")
    ref = greedy_decode(cpu_model.decoder, cpu_model.cfg,
                        cpu_model.encode(imgs[:4].cpu()), max_gen_length=S)
    check(torch.equal(ref.tokens, res_loop.tokens[:4].cpu()), "GPU tokens equal the CPU's")
    print("[main] first 4 captions equal the CPU run's", flush=True)

    # -- 5. beam path -------------------------------------------------------------------
    stamps["beam"] = time.perf_counter()
    beam_kw = dict(beamk=K_BEAM, max_gen_length=S, rescore_method="LN")
    KS.launches = KL.launches = 0
    beam_caps = model.caption(imgs, **beam_kw)[0]
    torch.cuda.synchronize()
    beam_launches = {"decoder_step": KS.launches, "greedy_loop": KL.launches}
    print(f"[beam] launches in model.caption (beamk {K_BEAM}, LN): {beam_launches}",
          flush=True)
    check(beam_launches["decoder_step"] == S + 1 and beam_launches["greedy_loop"] == 0,
          "model.caption ran the step kernels once per step")
    res_bk = beam_search(model.decoder, model.cfg, annots, **beam_kw)
    res_bp = beam_search(model.decoder, model.cfg, annots, fused=False, **beam_kw)
    torch.cuda.synchronize()
    for r in (res_bk, res_bp):
        check(r.tokens.shape == (B, K_BEAM, S + 2)
              and r.alphas.shape == (B, K_BEAM, S + 1, L), "beam result shapes")
        check(torch.isfinite(r.scores).all() and torch.isfinite(r.raw_scores).all(),
              "beam scores are finite")
    best_k = unpack_beam_result(res_bk, model.grid_hw)[0]
    best_p = unpack_beam_result(res_bp, model.grid_hw)[0]
    check(best_k == beam_caps, "model.caption equals beam_search + unpack")
    beam_agree = same_share(best_k, best_p)
    check(beam_agree >= 0.99, f"beam best captions agree on {beam_agree:.3f} of images")
    ref_b = beam_search(cpu_model.decoder, cpu_model.cfg,
                        cpu_model.encode(imgs[:4].cpu()), **beam_kw)
    check(unpack_beam_result(ref_b, cpu_model.grid_hw)[0] == best_k[:4],
          "beam: GPU best captions equal the CPU's")
    beam_words = [" ".join(model.vocab.itos(t) for t in c) for c in best_k]
    for w in beam_words[:4]:
        print(f"[beam] caption: {w}")
    beam_done = int((res_bk.lengths < S).sum())
    print(f"[beam] best captions of the step kernels and the plain path agree on "
          f"{beam_agree * 100:.1f}% of images; first 4 equal the CPU run's; "
          f"{beam_done}/{B * K_BEAM} hypotheses end before max_gen_length",
          flush=True)

    # -- 6. bfloat16 -----------------------------------------------------------------
    stamps["bf16"] = time.perf_counter()
    m16 = copy.deepcopy(model).to(torch.bfloat16)
    a16 = m16.encode(imgs)
    r16_loop = greedy_decode(m16.decoder, m16.cfg, a16, max_gen_length=S)
    r16_step = greedy_decode(m16.decoder, m16.cfg, a16, max_gen_length=S, fused=True)
    lw16 = KL.loop_weights(m16.decoder, m16.cfg, torch.bfloat16)
    h16, c16 = TD.init_lstm_state(m16.decoder, a16, m16.cfg)
    la16 = (*lw16, m16.cfg, a16, TD.attention_precompute(m16.decoder, a16),
            h16[0].contiguous(), c16[0].contiguous())
    k16, p16 = KL.greedy_loop(*la16, max_gen_length=S), KL.greedy_loop_plain(*la16, max_gen_length=S)
    r16_dec = greedy_decode(m16.decoder, m16.cfg, annots.to(torch.bfloat16),
                            max_gen_length=S)
    bf16 = {"loop_vs_f32_plain": agreement(r16_loop, res_plain).float().mean().item(),
            "loop_on_f32_annotations_vs_f32_plain":
                agreement(r16_dec, res_plain).float().mean().item(),
            "step_vs_f32_plain": agreement(r16_step, res_plain).float().mean().item(),
            "loop_kernel_vs_plain": ((k16[0] == p16[0]).all(-1) & (k16[3] == p16[3]))
            .float().mean().item()}
    serve_kw = dict(beam_kw, early_exit=True)
    r16_beam = beam_search(m16.decoder, m16.cfg, a16, **serve_kw)
    bf16["beam_serving_vs_f32_kernels"] = same_share(
        unpack_beam_result(r16_beam, m16.grid_hw)[0], best_k)
    bf16["beam_serving_finite"] = bool(torch.isfinite(r16_beam.scores).all())
    print(f"[bf16] token agreement: {bf16}", flush=True)

    # -- 7. timing ----------------------------------------------------------------------
    stamps["timing"] = time.perf_counter()
    f32 = "float32"
    calls = {  # name: (function, calls per timed run, kernel name for the profiler)
        "decoder_step": (lambda: KS.fused_decoder_step(*step_args), 20, "decoder_step_"),
        "decoder_step_plain": (lambda: KS.fused_decoder_step_plain(*step_args), 20, None),
        "decoder_step_bf16": (lambda: KS.fused_decoder_step(*step_args16), 20,
                              "decoder_step_"),
        "decoder_step_192": (lambda: KS.fused_decoder_step(*beam_step_args), 20,
                             "decoder_step_"),
        "decoder_step_192_plain": (lambda: KS.fused_decoder_step_plain(*beam_step_args),
                                   20, None),
        "greedy_loop": (lambda: KL.greedy_loop(*loop_args, max_gen_length=S), 1,
                        "greedy_loop_"),
        "greedy_loop_plain": (lambda: KL.greedy_loop_plain(*loop_args, max_gen_length=S),
                              1, None),
        "greedy_loop_bf16": (lambda: KL.greedy_loop(*la16, max_gen_length=S), 1,
                             "greedy_loop_"),
    }
    for label, mm in (("", model), ("_bf16", m16)):
        calls["encode" + label] = (lambda mm=mm: mm.encode(imgs), 1, None)
    for label, fused, mm in (("loop", None, model), ("step", True, model),
                             ("plain", False, model), ("loop_bf16", None, m16)):
        calls["captioning_" + label] = (
            lambda mm=mm, fused=fused: greedy_decode(
                mm.decoder, mm.cfg, mm.encode(imgs), max_gen_length=S, fused=fused),
            1, None)
    for label, fused, mm, kw in (("kernels", None, model, beam_kw),
                                 ("plain", False, model, beam_kw),
                                 ("kernels_bf16_serving", None, m16, serve_kw)):
        calls["beam_captioning_" + label] = (
            lambda mm=mm, fused=fused, kw=kw: beam_search(
                mm.decoder, mm.cfg, mm.encode(imgs), fused=fused, **kw), 1, None)
    ms = {k: cuda_ms(fn, calls=n) for k, (fn, n, _) in calls.items()}
    # one profiler window per entry; a beam decode records thousands of events
    dev_times = {k: device_times(fn, calls=3 if k.startswith("beam_") else 10)
                 for k, (fn, _, _) in calls.items()}
    busy = {k: busy_of(dev_times[k], name) for k, (_, _, name) in calls.items()}
    print(f"[time] per call, CUDA events (B={B}): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items()), flush=True)
    print("[time] busy device time per call, torch.profiler: "
          + ", ".join(f"{k} {'not measured' if v is None else f'{v:.3f} ms'}"
                      for k, v in busy.items()), flush=True)
    phase_busy = {f"{ph}{label}": busy_of(dev_times["greedy_loop" + label], "greedy_loop_" + ph)
                  for label in ("", "_bf16") for ph in KL.PHASES}
    step_busy = {f"{k}{label}": busy_of(dev_times["decoder_step" + label], "decoder_step_" + k)
                 for label in ("", "_bf16", "_192") for k in KS.KERNELS}
    print(f"[time] step kernels (B={B}; _192: B={B_BEAM}), busy device time per call, "
          "torch.profiler: "
          + ", ".join(f"{k} {'not measured' if v is None else f'{v * 1e3:.1f} us'}"
                      for k, v in step_busy.items()), flush=True)
    step_host = {k: host_ms(calls[k][0]) for k in ("decoder_step", "decoder_step_bf16")}
    print("[time] step wrapper, host time per call (checks, 9 allocations, 6 "
          "launches): " + ", ".join(f"{k} {v:.3f} ms" for k, v in step_host.items()),
          flush=True)
    batch_steps = int(torch.where(kl[4], kl[3] + 1, S + 1).max())
    print(f"[time] loop phases ({batch_steps} of {S + 1} steps run before every row "
          "finished), busy device time per decode, torch.profiler: "
          + ", ".join(f"{k} {'not measured' if v is None else f'{v:.3f} ms'}"
                      for k, v in phase_busy.items()), flush=True)
    e2e = {}
    for k in ms:
        if k.startswith("beam_captioning_"):
            e2e[k] = {"ms": ms[k], "imgs_per_s": B / ms[k] * 1e3,
                      "device_idle": None if busy[k] is None else 1 - busy[k] / ms[k]}
            idle = e2e[k]["device_idle"]
            print(f"[time] beam captioning ({k[16:]}, beamk {K_BEAM}, LN): "
                  f"{ms[k]:.3f} ms / batch of {B}, {e2e[k]['imgs_per_s']:.0f} imgs/s, "
                  f"busy {'not measured' if busy[k] is None else f'{busy[k]:.3f} ms'}, "
                  f"device idle {'not measured' if idle is None else f'{idle:.1%}'}",
                  flush=True)
        if k.startswith("captioning_"):
            e2e[k] = {"ms": ms[k], "imgs_per_s": B / ms[k] * 1e3,
                      "device_idle": None if busy[k] is None else 1 - busy[k] / ms[k]}
            idle = e2e[k]["device_idle"]
            print(f"[time] greedy captioning ({k[11:]}): {ms[k]:.3f} ms / batch of "
                  f"{B}, {e2e[k]['imgs_per_s']:.0f} imgs/s, device idle "
                  f"{'not measured' if idle is None else f'{idle:.1%}'}", flush=True)

    # bounds: inputs read once, outputs written once; operations of this run
    step_bytes = nbytes(e, h0, c0, annots, att_enc, *fw, *got)
    step_bound, step_by = bound(step_bytes, B * step_flops(L, D, A, H, E), f32)
    beam_bytes = nbytes(*beam_step_args[2:], *fw, *beam_step_out)
    beam_bound, beam_by = bound(beam_bytes, B_BEAM * step_flops(L, D, A, H, E), f32)
    beam_calls = {"step_calls_per_batch": beam_launches["decoder_step"],
                  "kernel_launches_per_batch": beam_launches["decoder_step"] * len(KS.KERNELS),
                  "step_ms_192": ms["decoder_step_192"],
                  "step_busy_ms_192": busy["decoder_step_192"],
                  "step_bound_ms_192": beam_bound, "step_bound_by_192": beam_by}
    print(f"[time] beam path: {beam_calls}", flush=True)
    steps_run = torch.where(kl[4], kl[3] + 1, S + 1).sum().item()
    loop_bytes = nbytes(annots, att_enc, h0, c0, *fw, *lw[1:], *kl)
    loop_ops = steps_run * (step_flops(L, D, A, H, E) + 2 * E * V)
    loop_bound, loop_by = bound(loop_bytes, loop_ops, f32)

    kernels = [
        # at the beam path's rows, with its launch count (model.caption)
        {"name": "decoder_step", "route": "cuda",
         "source": "sat_tpu_torch/csrc/decoder_step.cu",
         "replaces": "sat_tpu/kernels/decoder_step.py:72",
         "launches": beam_launches["decoder_step"], "rows": B_BEAM,
         "max_abs_err": max(beam_step_err.values()),
         "ms": ms["decoder_step_192"], "plain_ms": ms["decoder_step_192_plain"],
         "bound_ms": beam_bound, "bound_by": beam_by, "library_ms": None},
        {"name": "greedy_loop", "route": "cuda",
         "source": "sat_tpu_torch/csrc/greedy_loop.cu",
         "replaces": "sat_tpu/kernels/greedy_loop.py:42",
         "launches": launches["greedy_loop"], "rows": B, "max_abs_err": loop_err,
         "ms": ms["greedy_loop"], "plain_ms": ms["greedy_loop_plain"],
         "bound_ms": loop_bound, "bound_by": loop_by, "library_ms": None},
    ]
    report.update(kernels=kernels, step_err=step_err, loop_agreement=rate,
                  greedy_launches=launches, beam_launches=beam_launches,
                  beam_agreement=beam_agree, beam=beam_calls,
                  beam_captions=beam_words[:8], beam_finished=beam_done,
                  step_64={"ms": ms["decoder_step"], "plain_ms": ms["decoder_step_plain"],
                           "bound_ms": step_bound, "bound_by": step_by},
                  main_agreement=agree, bf16=bf16, e2e=e2e, call_ms=ms, busy_ms=busy,
                  loop_phase_busy_ms=phase_busy, step_kernel_busy_ms=step_busy,
                  step_host_ms=step_host,
                  step_err_bf16=step_err16,
                  kernel_launches_per_call={"decoder_step": len(KS.KERNELS),
                                            "greedy_loop": len(KL.PHASES) * (S + 1)},
                  loop_batch_steps=batch_steps,
                  loop_rows_steps=steps_run,
                  captions=words[:8], finished=n_done, batch=B, max_gen_length=S)

    # -- 8. training at the n64 configuration -------------------------------------------
    stamps["train"] = time.perf_counter()
    report["train"] = train_phase(model, imgs, dev)

    with tempfile.TemporaryDirectory(prefix="sat_data_") as data_dir:
        # -- 9. fit at the n64 configuration --------------------------------------------
        stamps["fit"] = time.perf_counter()
        report["fit"] = fit_phase(dev, data_dir)

        # -- 10. serve and evaluate at the n64 configuration -----------------------------
        stamps["serve"] = time.perf_counter()
        report["serve"] = serve_phase(dev, report["fit"]["json"], card)

        # -- 11. resume at the n64 configuration -------------------------------------------
        stamps["resume"] = time.perf_counter()
        report["resume"] = resume_phase(dev, report["fit"]["json"])
        # -- 12. the trainer's settings at the n64 configuration ----------------------------
        stamps["settings"] = time.perf_counter()
        report["settings"] = settings_phase(dev, report["fit"]["json"],
                                            dict(report["train"]["step"],
                                                 peak_memory_gib=report["train"]["b"][
                                                     "peak_memory_gib"]))
        # -- 13. the ResNet configuration with the full augmentation --------------------
        stamps["resnet"] = time.perf_counter()
        report["resnet"] = resnet_phase(dev, report["fit"]["json"], card)
        kernels += report["resnet"]["kernels"]
        # -- 14. BASELINE.json's first configuration: mobilenet_v3_small ---------------
        stamps["mobilenet"] = time.perf_counter()
        report["mobilenet"] = mobilenet_phase(dev, report["fit"]["json"], card)
        kernels += report["mobilenet"]["kernels"]
        # -- 15. the densenet121 configuration, squeezenet1_1 and the sweep ----------
        stamps["densenet"] = time.perf_counter()
        report["densenet"] = densenet_phase(dev, report["fit"]["json"], card)
        kernels += report["densenet"]["kernels"]
    kernels[0].update(launches_serve=report["serve"]["a"]["step_calls"],
                      launches_evaluate=report["serve"]["d"]["step_calls"],
                      launches_resumed_fit=report["resume"]["b_step_calls"])
    stamps["end"] = time.perf_counter()
    names = list(stamps)
    report["phase_s"] = {a: stamps[b] - stamps[a] for a, b in zip(names, names[1:])}
    print("[time] seconds per phase of this script: " + ", ".join(
        f"{k} {v:.1f}" for k, v in report["phase_s"].items()), flush=True)
    print("[report] " + json.dumps(report))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(cpu_fit() if sys.argv[1:] == ["--cpu-fit"] else main())
