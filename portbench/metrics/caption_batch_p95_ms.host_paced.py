"""caption_batch_p95_ms.host_paced: ``caption_batch_p95_ms`` read in the
traced run, for the cells whose pace the host's speed moves (beam search's
launches and unpacking), where the tail is the host's and is reported as a
per-layer number.  Moves
``caption_images_per_s.host_paced``."""

from portbench.drivers.caption_closed import p95


def read(rec, ctx):
    if rec.get("kind") != "caption" or "ops" not in rec:
        return None
    return 1e3 * p95(rec["latencies"])
