#!/usr/bin/env python3
"""Busy device time of each phase kernel on one NVIDIA GPU.

    python3 phase_times.py [TREE]

Builds the CUDA sources of the port in TREE (a checkout of this repository;
by default the one this file lies in), decodes 64 seeded scenes with the n64
checkpoint through the greedy loop kernels, f32 then bf16, and again at the
reference's 4,096 words (n64's widths, ``chip_smoke.vocab_config``'s
synthetic words, a decoder drawn from seed 0, f32 and bf16: keys ending in
``_v4096``), and prints one JSON line: each loop phase's busy time per
decode (ms, the phases TREE's ``PHASES`` names, their ``total``, and the
decode's CUDA-event ms, ``events``) and,
where TREE has the phased step kernels, each step kernel's busy time per
call at V 97 (us), at B 64 and at beam search's N = 192 rows over the 64
images (``step192_*``), both from torch.profiler (``chip_smoke.device_ms``),
then each kernel instance's registers.  At L 196, D 2048 (resnet50 at
encoder_size 14; seeded uniform annotations of 64 images, a decoder drawn
from seed 0 at 4,096 words) it gives the loop's phases likewise (keys ending
``_l196``).  Beam search through the step kernels (``beam_search(...,
fused=True)``, beamk 3, LN, S 20, B 64, f32), at n64 and at L 196, D 2048,
gives its busy ms and CUDA-event ms per decode, each step kernel's busy
ms per decode, and a hash of its tokens and raw scores, equal where two
trees decode bit for bit alike (keys ``beam_*``), f32 and again in bf16
(keys ending ``_bf16_n64`` and ``_bf16_l196``): the API both trees share,
whatever ``fused_decoder_step`` takes.  Last, at n64's widths and
4,096 and 60,000 synthetic words, it times the two greedy routes of
``decode.beam.greedy_decode`` end to end, the loop kernels
(``fused="loop"``) and the step kernels with the vocabulary matmul
(``fused=True``): every kernel's busy ms and the CUDA-event ms per decode
(keys ``route_loop_*`` and ``route_step_*``), which is what
``decode.beam.decode_route``'s choice between them rests on; a TREE whose
loop kernels cannot take 60,000 words raises there.  Run it in two trees
in turns (parent, change, change, parent) within one call to compare
their phases on one card.
"""

import copy
import hashlib
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
    cfg = model.cfg
    wide_cfg = CS.vocab_config(4096, cfg.encoder_arch, cfg.input_size, cfg.encoder_size,
                               cfg.encoder_dim)
    wide = TD.init_decoder_params(torch.Generator(device="cuda").manual_seed(0), wide_cfg)
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt)[6:]
        m = model.to(dt)
        an = m.encode(imgs)
        for suffix, params, pcfg in (("", m.decoder, m.cfg),
                                     ("_v4096", wide.to(dt), wide_cfg)):
            ae = TD.attention_precompute(params, an)
            h, c = TD.init_lstm_state(params, an, pcfg)
            h, c = h[0].contiguous(), c[0].contiguous()
            args = (*KL.loop_weights(params, pcfg, dt), pcfg, an, ae, h, c)
            loop = lambda: KL.greedy_loop(*args, max_gen_length=20)
            for ph in KL.PHASES:
                out[f"{ph}_{name}{suffix}"] = CS.device_ms(loop, "greedy_loop_" + ph, calls=20)
            out[f"total_{name}{suffix}"] = CS.device_ms(loop, "greedy_loop_", calls=20)
            out[f"events_{name}{suffix}"] = CS.cuda_ms(loop)
            if suffix or not hasattr(KS, "KERNELS"):
                continue
            ids = torch.arange(64, device="cuda") % (m.cfg.vocab_size - 4) + 1
            e = TD.embed_tokens(m.decoder, ids, m.cfg).contiguous()
            sargs = (KS.step_weights(m.decoder, m.cfg, dt), m.cfg, e, h, c, an, ae)
            step = lambda: KS.fused_decoder_step(*sargs)
            us = lambda ms: None if ms is None else ms * 1e3
            for k in KS.KERNELS:
                out[f"step_{k}_{name}_us"] = us(CS.device_ms(step, "decoder_step_" + k,
                                                             calls=20))
            out[f"step_total_{name}_us"] = us(CS.device_ms(step, "decoder_step_", calls=20))
            # beam search's call: N = 192 rows over the 64 images, k = 3
            rep = lambda x: x.repeat_interleave(3, 0).contiguous()
            ids3 = torch.arange(192, device="cuda") % (m.cfg.vocab_size - 4) + 1
            e3 = TD.embed_tokens(m.decoder, ids3, m.cfg).contiguous()
            gargs = (sargs[0], m.cfg, e3, rep(h), rep(c), an, ae)
            times = CS.device_times(lambda: KS.fused_decoder_step(*gargs), calls=20)
            for k in KS.KERNELS:
                out[f"step192_{k}_{name}_us"] = us(CS.busy_of(times, "decoder_step_" + k))
            out[f"step192_total_{name}_us"] = us(CS.busy_of(times, "decoder_step_"))
    from sat_tpu_torch.decode import beam as TB
    # the loop at L 196, D 2048, V 4096, and beam search through the step
    # kernels there and at n64
    big_cfg = CS.vocab_config(4096, "resnet50", 224, 14, 2048)
    big = TD.init_decoder_params(torch.Generator(device="cuda").manual_seed(0), big_cfg)
    big_an = torch.rand(64, 196, 2048, generator=torch.Generator().manual_seed(19)).cuda()
    ae = TD.attention_precompute(big, big_an)
    h, c = TD.init_lstm_state(big, big_an, big_cfg)
    args = (*KL.loop_weights(big, big_cfg, torch.float32), big_cfg, big_an, ae,
            h[0].contiguous(), c[0].contiguous())
    loop = lambda: KL.greedy_loop(*args, max_gen_length=20)
    times = CS.device_times(loop, calls=20)
    for ph in KL.PHASES:
        out[f"{ph}_float32_l196"] = CS.busy_of(times, "greedy_loop_" + ph)
    out["total_float32_l196"] = CS.busy_of(times, "greedy_loop_")
    out["events_float32_l196"] = CS.cuda_ms(loop)
    n64_an = model.to(torch.float32).encode(imgs)
    bf = torch.bfloat16
    m16, big16 = copy.deepcopy(model).to(bf), copy.deepcopy(big).to(bf)
    for suffix, params, pcfg, an in (("n64", model.decoder, cfg, n64_an),
                                     ("l196", big, big_cfg, big_an),
                                     ("bf16_n64", m16.decoder, cfg, m16.encode(imgs)),
                                     ("bf16_l196", big16, big_cfg, big_an.to(bf))):
        run = lambda: TB.beam_search(params, pcfg, an, beamk=3, max_gen_length=20,
                                     rescore_method="LN", fused=True)
        res = run()
        out[f"beam_sha_{suffix}"] = hashlib.sha256(
            res.tokens.cpu().numpy().tobytes()
            + res.raw_scores.float().cpu().numpy().tobytes()
        ).hexdigest()[:16]
        times = CS.device_times(run, calls=3)
        out[f"beam_busy_{suffix}"] = CS.busy_of(times)
        out[f"beam_events_{suffix}"] = CS.cuda_ms(run, reps=5)
        for k in KS.KERNELS:
            out[f"beam_step_{k}_{suffix}"] = CS.busy_of(times, "decoder_step_" + k)
    for v in (4096, 60000):
        vcfg = CS.vocab_config(v, cfg.encoder_arch, cfg.input_size, cfg.encoder_size,
                               cfg.encoder_dim)
        vp = TD.init_decoder_params(torch.Generator(device="cuda").manual_seed(0), vcfg)
        for dt in (torch.float32, torch.bfloat16):
            name, p = str(dt)[6:], vp.to(dt)
            an = model.to(dt).encode(imgs)
            for route, fused in (("loop", "loop"), ("step", True)):
                run = lambda: TB.greedy_decode(p, vcfg, an, max_gen_length=20, fused=fused)
                out[f"route_{route}_{name}_v{v}"] = CS.device_ms(run, calls=5)
                out[f"route_{route}_events_{name}_v{v}"] = CS.cuda_ms(run)
    print(tree, json.dumps(out))
    for log in logs.values():
        for kern, typ, regs, _ in CS.ptxas_summary(log):
            print(f"    {kern} {typ} {regs.split(',')[0]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
