"""Temperature scaling calibration, ported from
``sat_tpu/evalx/temperature.py`` (Guo et al. 2017; reference:
temperature_scaling.py:10-61): collect teacher-forced logits/targets over the
val split (epsilon=1), then fit a scalar temperature T by SGD(momentum=0.8,
nesterov, lr=1e-2) on the cross entropy of logits/T for 70 steps.

    python -m sat_tpu_torch.evalx.temperature --checkpoint last.ckpt

``main(argv, device="cpu")`` runs on the CPU; by default it runs on the CUDA
card and raises without one."""

from __future__ import annotations

import argparse
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch


@torch.no_grad()
def collect_logits(model, ds, batch_size: int = 16, max_batches: int = 41
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """(logits (N, V) float32, targets (N,)) of the valid positions of every
    reference caption of the first ``max_batches`` batches: the eval-mode
    encoder and ``models/sat.py::train_forward`` with epsilon 1 (always
    teacher-forced, temperature_scaling.py:37), on the model's device."""
    from ..data.dataset import CaptionLoader
    from ..data.transforms import val_preprocess
    from ..models.sat import (flatten_caption_batch, repeat_annotations,
                              train_forward)

    loader = CaptionLoader(ds, batch_size, model.cfg.input_size, shuffle=False,
                           train=False, drop_last=True)
    dev = next(model.parameters()).device
    all_logits, all_targets = [], []
    for i, batch in enumerate(loader):
        if i >= max_batches:
            break
        annots = model.encode(val_preprocess(torch.from_numpy(batch["images"]).to(dev)))
        caps_f, lens_f, r = flatten_caption_batch(
            torch.from_numpy(batch["captions"]).to(dev),
            torch.from_numpy(batch["lengths"]).to(dev))
        logits, targets, _ = train_forward(
            model.decoder, model.cfg, repeat_annotations(annots, r), caps_f,
            lens_f, 1.0)
        logits, targets = logits.cpu().numpy(), targets.cpu().numpy()
        # pack: keep only valid positions (the reference uses packed data)
        for row_l, row_t, l in zip(logits, targets, lens_f.tolist()):
            all_logits.append(row_l[:l])
            all_targets.append(row_t[:l])
    return np.concatenate(all_logits), np.concatenate(all_targets)


def fit_temperature(logits, targets, steps: int = 70, lr: float = 1e-2,
                    momentum: float = 0.8, init: float = 1.5,
                    verbose: bool = False) -> float:
    """SGD+nesterov on CE(logits/T, targets) (temperature_scaling.py:50-61),
    the gradient by autograd, on the device of ``logits`` (numpy: the
    CPU)."""
    logits = torch.as_tensor(logits)
    targets = torch.as_tensor(targets, device=logits.device).long()
    t, buf = float(init), 0.0
    for i in range(steps):
        temp = torch.tensor(t, dtype=logits.dtype, device=logits.device,
                            requires_grad=True)
        lp = torch.log_softmax(logits / temp, dim=-1)
        ce = -lp.gather(1, targets[:, None]).mean()
        g = float(torch.autograd.grad(ce, temp)[0])
        buf = momentum * buf + g
        g_nesterov = g + momentum * buf
        t = t - lr * g_nesterov
        if verbose:
            print(f"step {i}: T={t:.4f}")
    return t


def main(argv: Optional[Sequence[str]] = None,
         device: Union[str, torch.device, None] = None) -> float:
    from ..data.dataset import CaptionDataset
    from ..train.checkpoints import load_any_checkpoint

    p = argparse.ArgumentParser(description="temperature scaling calibration")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--json", default=None)
    p.add_argument("--split", default="val")
    p.add_argument("--batch_size", default=16, type=int)
    p.add_argument("--max_batches", default=41, type=int)
    p.add_argument("--steps", default=70, type=int)
    a = p.parse_args(argv)
    model = load_any_checkpoint(a.checkpoint, device=device)
    ds = CaptionDataset(a.json or model.cfg.json, a.split)
    logits, targets = collect_logits(model, ds, a.batch_size, a.max_batches)
    dev = next(model.parameters()).device
    t = fit_temperature(torch.from_numpy(logits).to(dev), targets,
                        steps=a.steps, verbose=True)
    print(f"temperature = {t:.4f}")
    return t


if __name__ == "__main__":
    main()
