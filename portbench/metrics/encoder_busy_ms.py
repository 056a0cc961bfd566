"""encoder_busy_ms: device-busy ms per batch of the operations launched
inside calls into the encoder (``SATModel.encoder``), traced requests."""

from portbench.common import readers as R


def read(rec, ctx):
    if rec.get("kind") != "caption":
        return None
    v = R.per_request(rec, R.busy_s(rec, {"encoder"}))
    return None if not v else 1e3 * v
