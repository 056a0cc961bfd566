#!/usr/bin/env python3
"""Busy device time of each phase kernel on one NVIDIA GPU.

    python3 phase_times.py [TREE]

Builds the CUDA sources of the port in TREE (a checkout of this repository;
by default the one this file lies in), decodes 64 seeded scenes with the n64
checkpoint through the greedy loop kernels, f32 then bf16, and prints one
JSON line: each loop phase's busy time per decode (ms) and, where TREE has
the phased step kernels, each step kernel's busy time per call (us), both
from torch.profiler (``chip_smoke.device_ms``), then each kernel instance's
registers.  Run it in two trees in turns (parent, change, change, parent)
within one call to compare their phases on one card.
"""

import json
import os
import sys


def main():
    tree = os.path.abspath(sys.argv[1] if len(sys.argv) > 1
                           else os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        print("phase_times: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    import chip_smoke as CS
    from sat_tpu_torch.kernels import _build
    from sat_tpu_torch.kernels import decoder_step as KS
    from sat_tpu_torch.kernels import greedy_loop as KL
    from sat_tpu_torch.models import decoder as TD
    from sat_tpu_torch.train.checkpoints import load_model_from_checkpoint

    logs = _build.build(["greedy_loop", "decoder_step"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model, _ = load_model_from_checkpoint(
        os.path.join(tree, "tests", "data", "best_n64_r4_serving.ckpt"))
    imgs = torch.from_numpy(CS.scenes(64, model.cfg.input_size, seed=0)).cuda()
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt)[6:]
        m = model.to(dt)
        an = m.encode(imgs)
        ae = TD.attention_precompute(m.decoder, an)
        h, c = TD.init_lstm_state(m.decoder, an, m.cfg)
        h, c = h[0].contiguous(), c[0].contiguous()
        args = (*KL.loop_weights(m.decoder, m.cfg, dt), m.cfg, an, ae, h, c)
        loop = lambda: KL.greedy_loop(*args, max_gen_length=20)
        for ph in KL.PHASES:
            out[f"{ph}_{name}"] = CS.device_ms(loop, "greedy_loop_" + ph, calls=20)
        out[f"total_{name}"] = CS.device_ms(loop, "greedy_loop_", calls=20)
        if hasattr(KS, "KERNELS"):
            ids = torch.arange(64, device="cuda") % (m.cfg.vocab_size - 4) + 1
            e = TD.embed_tokens(m.decoder, ids, m.cfg).contiguous()
            sargs = (KS.step_weights(m.decoder, m.cfg, dt), m.cfg, e, h, c, an, ae)
            step = lambda: KS.fused_decoder_step(*sargs)
            us = lambda ms: None if ms is None else ms * 1e3
            for k in KS.KERNELS:
                out[f"step_{k}_{name}_us"] = us(CS.device_ms(step, "decoder_step_" + k,
                                                             calls=20))
            out[f"step_total_{name}_us"] = us(CS.device_ms(step, "decoder_step_", calls=20))
    print(tree, json.dumps(out))
    for log in logs.values():
        for kern, typ, regs, _ in CS.ptxas_summary(log):
            print(f"    {kern} {typ} {regs.split(',')[0]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
