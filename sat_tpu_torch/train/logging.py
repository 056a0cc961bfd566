"""Metrics logging, the port's copy of ``sat_tpu/train/logging.py``:
auto-versioned ``{save_dir}/{name}/version_N`` directories and a logger with
the JAX package's tags and steps (``{k}/train`` per step, ``{k}/train_epoch``
and ``Learning Rate`` at epoch + 1, ``{k}/val_epoch`` at epoch + 1).  It
writes TensorBoard events where ``torch.utils.tensorboard`` imports, else
JSON lines to ``metrics.jsonl``."""

from __future__ import annotations

import json
import os
from typing import Dict, Optional


def next_version_dir(save_dir: str, name: str, create: bool = True) -> str:
    """Auto-versioned {save_dir}/{name}/version_N; create=False computes the
    path without touching the filesystem."""
    base = os.path.join(save_dir, name)
    if create:
        os.makedirs(base, exist_ok=True)
    versions = [int(d.split("_")[1]) for d in os.listdir(base)
                if d.startswith("version_") and d.split("_")[1].isdigit()] \
        if os.path.isdir(base) else []
    v = max(versions) + 1 if versions else 0
    path = os.path.join(base, f"version_{v}")
    if create:
        os.makedirs(path, exist_ok=True)
    return path


class MetricsLogger:
    """``enabled=False`` (a rank other than 0) touches no file."""

    def __init__(self, logdir: str, enabled: bool = True):
        self.logdir = logdir
        self.enabled = enabled
        self._tb = None
        if not enabled:
            return
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._tb = SummaryWriter(log_dir=logdir)
        except ImportError:
            self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")

    def scalar(self, tag: str, value: float, step: int) -> None:
        if not self.enabled:
            return
        if self._tb is not None:
            self._tb.add_scalar(tag, value, global_step=step)
        else:
            self._jsonl.write(json.dumps({"tag": tag, "value": float(value),
                                          "step": int(step)}) + "\n")
            self._jsonl.flush()

    def train_step(self, metrics: Dict[str, float], step: int) -> None:
        for k, v in metrics.items():
            self.scalar(f"{k}/train", float(v), step)

    def train_epoch(self, metrics: Dict[str, float], epoch: int,
                    lr: Optional[float] = None) -> None:
        for k, v in metrics.items():
            self.scalar(f"{k}/train_epoch", float(v), epoch + 1)
        if lr is not None:
            self.scalar("Learning Rate", lr, epoch + 1)

    def val_epoch(self, metrics: Dict[str, float], epoch: int) -> None:
        for k, v in metrics.items():
            self.scalar(f"{k}/val_epoch", float(v), epoch + 1)

    def close(self) -> None:
        if not self.enabled:
            return
        if self._tb is not None:
            self._tb.flush()
            self._tb.close()
        else:
            self._jsonl.close()
