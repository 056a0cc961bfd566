#!/usr/bin/env python3
"""How often a torch.profiler window on one NVIDIA GPU loses the records of
kernels it was open for, for the two windows the port counts kernels in,
with and without what each does against it.

    python3 profiler_windows.py [--out DIR] [STEP_WINDOWS [TRAIN_WINDOWS]]

* ``step``: ``tests/test_torch_cuda_kernels.py::device_kernels``' window
  (host and device activity, one uncounted kernel, a synchronize, one call
  of the step kernels at the n64 checkpoint's widths, B = 64, a
  synchronize), with 2,000 small kernels run between windows, unpadded and
  padded with 0.05 s of host time at both ends as that function pads it;
  STEP_WINDOWS (default 1000) windows each, counting those that miss any of
  the six step kernels.
* ``train``: ``chip_smoke.marked_step_events``' window over 3 marked bf16
  train steps of the n64 settings on one batch of 64, then 256 small
  uncounted kernels inside the window (they made a window lose its first
  records most of the time), opening with no uncounted kernels and with
  ``chip_smoke.PROFILER_HEAD`` of them; TRAIN_WINDOWS (default 20) windows
  each, counting those short of the 18 part marks, the head kernels lost,
  and the other records lost at the window's head, at its tail and in
  between, against the way's longest window.

Prints one JSON line per way and, with ``--out``, writes every window to
``DIR/profiler_windows.json``.
"""

import argparse
import contextlib
import json
import os
import sys
import time


def where_lost(names, ref):
    """(records missing before, after and inside the window's run of
    records that matches ``ref``)."""
    head = 0
    while head < len(names) and names[head] == ref[head]:
        head += 1
    tail = 0
    while (tail < len(names) - head
           and names[len(names) - 1 - tail] == ref[len(ref) - 1 - tail]):
        tail += 1
    lost = len(ref) - len(names)
    if head == len(names):
        return {"head": 0, "tail": lost, "inside": 0}
    if tail == len(names):
        return {"head": lost, "tail": 0, "inside": 0}
    return {"head": 0, "tail": 0, "inside": lost}


def main():
    import torch
    if not torch.cuda.is_available():
        print("profiler_windows: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from sat_tpu_torch.kernels import _build
    from sat_tpu_torch.kernels import decoder_step as KS
    from sat_tpu_torch.models import decoder as TD
    from sat_tpu_torch.train import loop
    from sat_tpu_torch.train.checkpoints import (load_model_from_checkpoint,
                                                 read_checkpoint_config)

    ap = argparse.ArgumentParser()
    ap.add_argument("--out")
    ap.add_argument("step_windows", nargs="?", type=int, default=1000)
    ap.add_argument("train_windows", nargs="?", type=int, default=20)
    args = ap.parse_args()
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    summary, rows = [], {}

    # step: the card test's window
    _build.build(["decoder_step"])
    model, _ = load_model_from_checkpoint(cs.CKPT, device=dev)
    cfg, params = model.cfg, model.decoder
    g = torch.Generator(device="cpu").manual_seed(1)
    annots = torch.randn(cs.B, 49, cfg.encoder_dim, generator=g).to(dev)
    att_enc = TD.attention_precompute(params, annots)
    h0, c0 = (x[0].contiguous() for x in TD.init_lstm_state(params, annots, cfg))
    e = TD.embed_tokens(params, torch.randint(1, cfg.vocab_size, (cs.B,), generator=g)
                        .to(dev), cfg).contiguous()
    sw = KS.pack_loop_weights(KS.pack_fused_weights(params, cfg, torch.float32))
    filler = torch.zeros(1, device=dev)
    for pad in (0.0, 0.05):
        way = f"step, pad {pad} s"
        rows[way] = []
        for _ in range(args.step_windows):
            for _ in range(2000):
                filler.add_(1)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                time.sleep(pad)
                torch.ones(1, device="cuda").add_(1)
                torch.cuda.synchronize()
                KS.fused_decoder_step(sw, cfg, e, h0, c0, annots, att_enc)
                torch.cuda.synchronize()
                time.sleep(pad)
            rows[way].append(sum("decoder_step_" in x.name for x in prof.events()
                                 if x.device_type == DeviceType.CUDA))
        summary.append({"way": way, "windows": len(rows[way]),
                        "missing_step_kernels": sum(n < len(KS.KERNELS) for n in rows[way]),
                        "empty": sum(n == 0 for n in rows[way])})
        print(json.dumps(summary[-1]), flush=True)

    # train: chip_smoke's marked window of the bf16 step
    base = read_checkpoint_config(cs.CKPT).replace(
        resume=None, precision=16, device_resident_data=False, json=None)
    trainer = loop.Trainer(base, device=dev)
    trainer.model.load_state_dict(model.state_dict())
    batch = cs.caption_batch(model.vocab, cs.B_TRAIN, seed=12)
    window, head_default = cs.device_window, cs.PROFILER_HEAD

    @contextlib.contextmanager
    def with_tail():
        with window() as prof:
            yield prof
            for _ in range(256):
                filler.add_(1)
            torch.cuda.synchronize()

    cs.device_window = with_tail
    for head in (0, head_default):
        way = f"train, bf16, head {head}, tail"
        cs.PROFILER_HEAD = head
        runs, heads = [], []
        for _ in range(args.train_windows):
            names = [x.name for x in cs.marked_step_events(trainer, batch, head=True)]
            heads.append(sum("spin_kernel" in n for n in names))
            runs.append([n for n in names if "spin_kernel" not in n])
        ref = max(runs, key=len)
        rows[way] = [dict(where_lost(r, ref), events=len(r), head_kept=h,
                          marks=sum("xor" in n.lower() for n in r))
                     for r, h in zip(runs, heads)]
        short = [r for r in rows[way] if r["events"] < len(ref)]
        summary.append({"way": way, "windows": len(runs), "longest": len(ref),
                        "marks_in_longest": sum("xor" in n.lower() for n in ref),
                        "short_of_marks": sum(r["marks"] < 18 for r in rows[way]),
                        "head_lost": [head - h for h in heads if h < head],
                        "lost_head": [r["head"] for r in short if r["head"]],
                        "lost_tail": [r["tail"] for r in short if r["tail"]],
                        "lost_inside": [r["inside"] for r in short if r["inside"]]})
        print(json.dumps(summary[-1]), flush=True)
    cs.PROFILER_HEAD, cs.device_window = head_default, window
    if args.out:
        with open(os.path.join(args.out, "profiler_windows.json"), "w") as f:
            json.dump({"summary": summary, "windows": rows}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
