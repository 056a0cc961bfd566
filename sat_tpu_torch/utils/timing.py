"""Step timing and profiling, ported from ``sat_tpu/utils/timing.py``: a
``StepTimer`` of steps/s and images/s over a sliding window, and
``maybe_profile``, a ``torch.profiler`` trace of a block (``fit``'s first
train epoch at ``cfg.profile_dir``) where JAX takes a ``jax.profiler``
trace."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional, Union

import torch


class StepTimer:
    """Tracks steps/sec and images/sec over a sliding window."""

    def __init__(self, window: int = 50):
        self.window = window
        self._stamps = []
        self._images = []

    def tick(self, n_images: int = 0) -> None:
        self._stamps.append(time.time())
        self._images.append(n_images)
        if len(self._stamps) > self.window:
            self._stamps.pop(0)
            self._images.pop(0)

    @property
    def steps_per_sec(self) -> float:
        if len(self._stamps) < 2:
            return 0.0
        dt = self._stamps[-1] - self._stamps[0]
        return (len(self._stamps) - 1) / dt if dt > 0 else 0.0

    @property
    def images_per_sec(self) -> float:
        if len(self._stamps) < 2:
            return 0.0
        dt = self._stamps[-1] - self._stamps[0]
        return sum(self._images[1:]) / dt if dt > 0 else 0.0


@contextlib.contextmanager
def maybe_profile(logdir: Optional[str],
                  device: Union[str, torch.device, None] = None):
    """A ``torch.profiler`` trace of the block, written into ``logdir`` as
    ``{host}_{pid}.{time}.pt.trace.json`` (``tensorboard_trace_handler``:
    TensorBoard's profiler plugin and Perfetto read it), with the host's
    operations and, on a CUDA ``device``, the card's kernels; a no-op
    without ``logdir``.  A profiler that fails fails the block."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler
    activities = [ProfilerActivity.CPU]
    if torch.device(device or "cpu").type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield
