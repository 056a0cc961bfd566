"""caption_mfu: the model operations of every image captioned in the traced
run's window, over the window's seconds and the float32 peak (67 TFLOP/s,
outside the tensor cores, at 700 W), in %.  Encoder: 2 x the convolutions'
multiply-adds at its resolution; decoder: per row and step that ran, the
decode step and the vocabulary product and selection
(``common/flops.py``)."""

from portbench.common import flops as F
from portbench.common import readers as R


def read(rec, ctx):
    if rec.get("kind") != "caption" or "ops" not in rec:
        return None
    d, s = rec["dims"], ctx.config["sat"]
    if rec.get("step_calls"):
        steps = len(rec["step_calls"]) / rec["traced_requests"]
    elif rec.get("loop_steps"):
        steps = sum(rec["loop_steps"]) / len(rec["loop_steps"])
    else:
        return None
    per_image = (F.encoder_flops_per_image(s["encoder_arch"], s["input_size"],
                                           s.get("encoder_size"))
                 + F.decoder_flops_per_image(steps, rec["beamk"], d["L"], d["D"], d["A"],
                                             d["H"], d["E"], d["V"]))
    return R.share(rec["images"] * per_image / rec["window_s"], F.PEAK_OPS["float32"])
