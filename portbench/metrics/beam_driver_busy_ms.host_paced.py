"""beam_driver_busy_ms.host_paced: device-busy ms per batch of the
operations launched inside ``decode/beam.py::beam_search`` but not inside a
step kernel call: the selection, gathers, records and the vocabulary
product.  Moves ``caption_images_per_s.host_paced``."""

from portbench.common import readers as R


def read(rec, ctx):
    if not rec.get("step_calls"):
        return None
    v = R.per_request(rec, R.busy_s(rec, {"decode"}))
    return None if not v else 1e3 * v
