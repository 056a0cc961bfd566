"""A profiler window over part of a run, and what the harness reads from it.

``device_window`` and ``window_events`` are frozen copies of
``chip_smoke.py``'s (``:557-591``, with ``PROFILER_PAD_S`` and
``PROFILER_HEAD`` from ``:387-389``): the window opens with uncounted
``torch.cuda._sleep`` kernels, because a window whose own start stalls can
lose its first records, and it is read from the profiler's own records
(``kineto_results``), which is about 0.1 ms an event faster than
``prof.events()``.  The harness adds host ranges: ``span(name)`` opens a
``record_function`` range named ``pb.<name>`` from the harness's own files,
and ``window_events`` gives each device operation the innermost range
whose interval holds the host call that launched it, by the profiler's
correlation ids.  Kernel names play no part."""

from __future__ import annotations

import bisect
import collections
import contextlib
import time
from typing import Iterator, List, Optional, Tuple

PROFILER_PAD_S, PROFILER_HEAD = 0.05, 256
SPAN_PREFIX = "pb."
HEAD_KERNEL = "spin_kernel"     # torch.cuda._sleep's kernel

# a device operation of a window: name, start and end (ns), the host range
# its launch fell in ("" for none), and whether it is a kernel
DeviceOp = collections.namedtuple("DeviceOp", "name start_ns end_ns span kernel")
# a host range opened by ``span``: name without the prefix, start, end (ns)
HostSpan = collections.namedtuple("HostSpan", "name start_ns end_ns")


@contextlib.contextmanager
def device_window() -> Iterator[object]:
    """A ``torch.profiler`` window around the block, open ``PROFILER_PAD_S``
    before and after it, whose first kernels are ``PROFILER_HEAD``
    uncounted ones; the block ends with a synchronize.  It records the host
    side too, which the ranges need; without a card (the harness's CPU
    tests), only that."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    card = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    with profile(activities=acts) as prof:
        time.sleep(PROFILER_PAD_S)
        if card:
            for _ in range(PROFILER_HEAD):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
        yield prof
        if card:
            torch.cuda.synchronize()
        time.sleep(PROFILER_PAD_S)


def span(name: str):
    """A host range ``pb.<name>`` the window records."""
    from torch.profiler import record_function
    return record_function(SPAN_PREFIX + name)


def _is_launch(name: str) -> bool:
    return name.startswith(("cuda", "cu")) and "Synchronize" not in name


def window_events(prof) -> Tuple[List[DeviceOp], List[HostSpan]]:
    """The device operations of a ``device_window`` in time order, without
    its head kernels, each with its host range; and the host ranges."""
    from torch.autograd import DeviceType
    spans, launches, device = [], {}, []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            # the host ranges' own marks on the device timeline are not work
            if HEAD_KERNEL in name or name.startswith(SPAN_PREFIX):
                continue
            device.append(e)
        elif name.startswith(SPAN_PREFIX):
            spans.append(HostSpan(name[len(SPAN_PREFIX):], e.start_ns(),
                                  e.start_ns() + e.duration_ns()))
        elif _is_launch(name):
            launches[e.correlation_id()] = e.start_ns()
    spans.sort(key=lambda s: s.start_ns)
    ops = []
    for e in device:
        # the launch's correlation id is the device record's own; the linked
        # id counts host operations, another sequence, and can collide
        t = launches.get(e.correlation_id())
        name = e.name()
        kernel = not name.lower().startswith(("memcpy", "memset"))
        ops.append(DeviceOp(name, e.start_ns(), e.start_ns() + e.duration_ns(),
                            "" if t is None else innermost(spans, t), kernel))
    ops.sort(key=lambda o: o.start_ns)
    return ops, spans


def innermost(spans: List[HostSpan], t: int) -> str:
    """The innermost range holding host time ``t`` (ranges nest, so the
    latest-starting one that holds it); '' for none."""
    i = bisect.bisect_right([s.start_ns for s in spans], t)
    for s in reversed(spans[:i]):
        if s.end_ns >= t:
            return s.name
    return ""


def busy_ns(ops: List[DeviceOp]) -> int:
    """The union of the operations' intervals, in ns."""
    total, cur_s, cur_e = 0, None, None
    for o in sorted(ops, key=lambda o: o.start_ns):
        if cur_e is None or o.start_ns > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = o.start_ns, o.end_ns
        else:
            cur_e = max(cur_e, o.end_ns)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def top_ops(ops: List[DeviceOp], n: int = 10, width: int = 120) -> List[List]:
    """The n device operations (by name, cut to ``width`` characters) that
    took most time, in s."""
    by = collections.Counter()
    for o in ops:
        by[o.name[:width]] += (o.end_ns - o.start_ns) / 1e9
    return [[k, v] for k, v in by.most_common(n)]


def idle_gaps(ops: List[DeviceOp], spans: List[HostSpan], t0: int, t1: int,
              n: int = 10) -> List[List]:
    """The n longest stretches of [t0, t1] with no device operation, each
    named by the innermost host range open at its start, in s."""
    gaps, cur = [], t0
    for o in sorted(ops, key=lambda o: o.start_ns):
        if o.start_ns > cur:
            gaps.append((cur, o.start_ns))
        cur = max(cur, o.end_ns)
    if t1 > cur:
        gaps.append((cur, t1))
    gaps.sort(key=lambda g: g[0] - g[1])
    return [[innermost(spans, a) or "host", (b - a) / 1e9] for a, b in gaps[:n]]


def window_bounds(spans: List[HostSpan], name: str) -> Optional[Tuple[int, int]]:
    """The first start and last end of the ranges named ``name``."""
    sel = [s for s in spans if s.name == name]
    if not sel:
        return None
    return sel[0].start_ns, max(s.end_ns for s in sel)
