"""The yardstick: operations and bytes from shapes, and the card's peaks.

``step_flops`` and ``bound`` are frozen copies of ``chip_smoke.py``'s
(``:726-733``), with its peaks (``:434-436``): one
decode step's multiply-adds per row times two, and the least time of a
call, the larger of its bytes over the HBM rate and its operations over the
peak.  Added here: the vocabulary product and selection of a step, the
whole step kernel call, the greedy loop, a captioned image, and the
encoders' convolutions, counted on the meta device through the reference's own
encoder (``reference/encoders.py``)."""

from __future__ import annotations

from typing import Dict, Tuple

# published peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}
F32 = 4


def step_flops(L: int, D: int, A: int, H: int, E: int) -> int:
    """Multiply-adds x 2 of one decode step for one row (GEMVs, attention)."""
    return 2 * (H * A + L * A + L * D + H * D + (E + D + H) * 4 * H + H * E + D * E)


def bound(nbytes_moved: float, ops: float, dtype_name: str) -> Tuple[float, str]:
    """The least time in ms, and which of the two bounds it."""
    t_bytes = nbytes_moved / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def vocab_flops(E: int, V: int) -> int:
    """The vocabulary product of one row and step (2 E V) and its selection
    (a max and an exponential sum over V: 2 V)."""
    return 2 * E * V + 2 * V


def step_weight_bytes(D: int, A: int, H: int, E: int) -> int:
    """The weights one step kernel call reads, float32: att_dec, f_att,
    beta, the LSTM, out_hidden, out_context."""
    return F32 * (H * A + A + H * D + D + (E + D + H) * 4 * H + 8 * H
                  + H * E + D * E)


def step_call(rows: int, images: int, L: int, D: int, A: int, H: int, E: int
              ) -> Tuple[int, int]:
    """(operations, bytes) of one step kernel call over ``rows`` rows of
    ``images`` images: each input byte read once (weights, each image's
    annotations and att_enc, each row's embedding, h, c), each output
    written once (t, h', c', alpha)."""
    ops = rows * step_flops(L, D, A, H, E)
    io = F32 * (images * L * (D + A) + rows * (E + 2 * H) + rows * (E + 2 * H + L))
    return ops, step_weight_bytes(D, A, H, E) + io


def loop_call(rows: int, steps: int, L: int, D: int, A: int, H: int, E: int, V: int
              ) -> Tuple[int, int]:
    """(operations, bytes) of one greedy loop call of ``steps`` steps: each
    step's decode and vocabulary work per row; the weights (the step's and
    the embedding and output tables) and the annotations read once, the
    tokens, scores and alphas written once."""
    ops = rows * steps * (step_flops(L, D, A, H, E) + vocab_flops(E, V))
    weights = step_weight_bytes(D, A, H, E) + F32 * (2 * V * E + V)
    io = F32 * (rows * L * (D + A) + 2 * rows * H) + rows * steps * F32 * (L + 2)
    return ops, weights + io


def decoder_flops_per_image(steps: int, beamk: int, L: int, D: int, A: int, H: int,
                            E: int, V: int) -> int:
    """Model operations of one image's decode: ``steps`` steps of beamk rows,
    each a decode step and the vocabulary product and selection, plus the
    attention precompute and the initial state once."""
    per_row = step_flops(L, D, A, H, E) + vocab_flops(E, V)
    once = 2 * (L * D * A + D * E + E * 2 * H)
    return steps * beamk * per_row + once


_ENCODER_CACHE: Dict[Tuple, int] = {}


def encoder_flops_per_image(arch: str, px: int, encoder_size) -> int:
    """2 x the multiply-adds of the encoder's convolutions for one image at
    ``px``, counted by running the reference encoder on the meta device."""
    key = (arch, px, encoder_size)
    if key not in _ENCODER_CACHE:
        import torch
        from portbench.reference import encoders as RE
        macs = [0]

        def count(x, w, stride, padding, groups):
            y = torch.nn.functional.conv2d(x, w, None, stride, padding, 1, groups)
            macs[0] += y.numel() * w.shape[1] * w.shape[2] * w.shape[3]
            return y
        with torch.device("meta"):
            sd = RE.shapes_state_dict(arch)
            x = torch.zeros(1, px, px, 3)
            RE.encode(sd, arch, x, encoder_size, conv=count)
        _ENCODER_CACHE[key] = 2 * macs[0]
    return _ENCODER_CACHE[key]
