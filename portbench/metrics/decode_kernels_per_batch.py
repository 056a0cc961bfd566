"""decode_kernels_per_batch: device kernels launched per batch inside the
decode (``beam_search`` or ``greedy_decode`` and what they call), a count."""

from portbench.common import readers as R


def read(rec, ctx):
    if rec.get("kind") != "caption":
        return None
    n = len(R.clipped(rec, {"decode", "step", "loop"}, kernels_only=True))
    return R.per_request(rec, float(n)) or None
