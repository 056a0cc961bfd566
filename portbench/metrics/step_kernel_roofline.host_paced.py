"""step_kernel_roofline.host_paced: the least time of the traced step
kernel calls (``kernels/decoder_step.py::fused_decoder_step``) over their
device-busy time, in %: per call the larger of its operations at the
float32 peak and its bytes (each input read once, each output written once)
at the HBM rate (``common/flops.py::step_call``).  The step kernels run in
the beam cells, which report ``caption_images_per_s.host_paced``."""

from portbench.common import flops as F
from portbench.common import readers as R


def read(rec, ctx):
    calls = rec.get("step_calls")
    if not calls:
        return None
    d = rec["dims"]
    least = sum(F.bound(*reversed(F.step_call(rows, imgs, d["L"], d["D"], d["A"],
                                              d["H"], d["E"])), "float32")[0]
                for rows, imgs in calls)
    busy = R.busy_s(rec, {"step"})
    return R.share(least, None if busy is None else 1e3 * busy)
