"""setup_s: from process start to the first timed request or step (host
clock): building the model, drawing the weights and inputs, building the
kernels where a checkout has not yet, and the warm-up."""


def read(rec, ctx):
    return rec["setup_s"]
