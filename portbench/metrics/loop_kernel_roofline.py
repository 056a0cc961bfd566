"""loop_kernel_roofline: the least time of the traced greedy loop calls
(``kernels/greedy_loop.py::greedy_loop_decode``) over their device-busy
time, in %: the steps that ran, each row's decode step, vocabulary product
and selection at the float32 peak against the weights, annotations and
outputs once at the HBM rate (``common/flops.py::loop_call``)."""

from portbench.common import flops as F
from portbench.common import readers as R


def read(rec, ctx):
    rows = rec.get("loop_rows")
    if not rows:
        return None
    d = rec["dims"]
    least = sum(F.bound(*reversed(F.loop_call(r, s, d["L"], d["D"], d["A"], d["H"],
                                              d["E"], d["V"])), "float32")[0]
                for r, s in zip(rows, rec["loop_steps"]))
    busy = R.busy_s(rec, {"loop"})
    return R.share(least, None if busy is None else 1e3 * busy)
