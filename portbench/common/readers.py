"""What the per-layer readers share: the traced window of a run and the
device time of the operations launched inside the harness's host ranges.

A run's record (the driver's) holds, when traced, ``ops`` and ``spans``
(``profwin.window_events``) and ``traced_requests``; the traced window runs
from the first ``request`` range's start to the last one's end, and each
layer's busy time is the union of its operations' intervals in it."""

from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional, Tuple

from portbench.common import profwin

METRICS = Path(__file__).resolve().parent.parent / "metrics"


def window(rec: Dict) -> Optional[Tuple[int, int]]:
    """The traced window (ns), or None for an untraced run."""
    if "spans" not in rec:
        return None
    return profwin.window_bounds(rec["spans"], "request")


def clipped(rec: Dict, names: Optional[Iterable[str]] = None, kernels_only: bool = False):
    """The traced operations inside the window, of the ranges ``names``
    (all for None), clipped to it."""
    w = window(rec)
    if w is None:
        return []
    t0, t1 = w
    names = None if names is None else set(names)
    out = []
    for o in rec["ops"]:
        if o.end_ns <= t0 or o.start_ns >= t1:
            continue
        if names is not None and o.span not in names:
            continue
        if kernels_only and not o.kernel:
            continue
        out.append(o._replace(start_ns=max(o.start_ns, t0), end_ns=min(o.end_ns, t1)))
    return out


def busy_s(rec: Dict, names: Optional[Iterable[str]] = None) -> Optional[float]:
    """Device-busy seconds in the traced window of the ranges ``names``."""
    if window(rec) is None:
        return None
    return profwin.busy_ns(clipped(rec, names)) / 1e9


def window_s(rec: Dict) -> Optional[float]:
    w = window(rec)
    return None if w is None else (w[1] - w[0]) / 1e9


def per_request(rec: Dict, value: Optional[float]) -> Optional[float]:
    """``value`` per traced request."""
    n = rec.get("traced_requests")
    return None if value is None or not n else value / n


def share(num: Optional[float], den: Optional[float]) -> Optional[float]:
    """num / den in percent; None where either is missing or num is 0 (a
    share of a roofline or a peak is never reported as 0)."""
    if num is None or den is None or den <= 0 or num <= 0:
        return None
    return 100.0 * num / den


def same_as(name: str) -> Callable:
    """The reader of the metric ``name`` (``metrics/<name>.py``), for a metric
    that reads the same quantity in cells that report another end-to-end
    metric."""
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + name.replace(".", "_"), METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
