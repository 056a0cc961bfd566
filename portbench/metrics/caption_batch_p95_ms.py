"""caption_batch_p95_ms: the nearest-rank 95th percentile of every request's
latency in the window, hand-over to results on the host (host clock).  No
cell reports it end to end yet: the greedy cell's tail, whose spread moves
with the machine, is its per-layer ``caption_batch_p95_ms.greedy``."""

from portbench.drivers.caption_closed import p95


def read(rec, ctx):
    if rec.get("kind") != "caption":
        return None
    return 1e3 * p95(rec["latencies"])
