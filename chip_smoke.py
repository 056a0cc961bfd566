#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (sat_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (nonzero exit, no result line):

1. device: require CUDA; print the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives them;
2. build both CUDA sources from ``sat_tpu_torch/csrc`` (all nvcc processes at
   once) and print the build time and, for what it compiled, each kernel
   instance's registers and spills (``nvcc -Xptxas=-v``; a spill in a phase
   kernel of either source fails the run), and both launch plans at B = 64
   (``[design]``: each kernel's grid, threads and shared memory; each tiled
   product must fill 64 blocks);
3. hold each kernel against its plain PyTorch version on the card, float32,
   n64 weights, B = 64, at the shapes of the main path, then at other shapes
   that take the kernels' other code paths (B = 192 and 300 at n64, the
   golden checkpoint's narrow widths at B = 13, and the step in bfloat16);
4. greedy path: load the n64 checkpoint, encode 64 seeded 224 px images,
   greedy captioning through the loop kernel (default), the step kernel
   (``fused=True``) and the plain path (``fused=False``), with launch counts
   read around that run, captions, and agreement with the CPU;
5. beam path, the one users run: ``SATModel.caption`` at beamk 3, LN,
   f32, whose ``beam_search`` takes the step kernels at B k = 192 rows by
   default, with launch counts read around that run; ``beam_search`` with
   the kernels and with ``fused=False`` (result shapes, finite scores, best
   captions equal on >= 99 % of images, the first 4 equal to the CPU run's);
6. both paths in bfloat16, beam search at the serving setting (beamk 3, LN,
   early exit) (token agreement with float32 printed, not asserted);
7. times, with CUDA events after a warm-up, the median of several runs: each
   kernel and its plain version per call (the ``kernels`` line: the step at
   the beam path's 192 rows), and greedy and beam captioning end to end
   (encode + decode, images/s); beside them the busy device time per call
   from torch.profiler, each loop phase's busy time per decode and each step
   kernel's busy time per call at 64 and 192 rows.

The last three lines of standard output are ``[report]`` with every number
of the run as JSON, the ``kernels`` JSON line and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(ROOT, "tests", "data", "best_n64_r4_serving.ckpt")
GOLDEN = os.path.join(ROOT, "tests", "data", "golden_v1.ckpt")
DEVICE = "cuda"
B, S = 64, 20
K_BEAM = 3     # beam width of the beam path (the serving default)
B_BEAM = B * K_BEAM   # beam search's B k rows: three 64-row tiles
B_WIDE = 300   # five 64-row tiles, more rows than an H100 has SMs

# published peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}

# colour, shape and texture of the n64 checkpoint's training scenes (one
# colour, 8 shapes x 8 stripe textures on a grey 3x3 grid)
_RED = np.array((200, 40, 40), np.float32)


def _shape_mask(shape, r):
    y, x = np.mgrid[-r:r, -r:r] + 0.5
    rr = np.hypot(x, y)
    return [rr < r, np.maximum(abs(x), abs(y)) < r * 0.82,
            (y < r * 0.55) & (abs(x) < (y + r) * 0.55), abs(x) + abs(y) < r * 1.05,
            (rr < r) & (rr > r * 0.55), (abs(x) < r * 0.3) | (abs(y) < r * 0.3),
            abs(y) < r * 0.35, abs(x) < r * 0.35][shape]


def scenes(n, size=224, seed=0):
    """n seeded images (n, size, size, 3) in [0, 1]: one or two striped
    shapes in the cells of a 3x3 grid, grey background, pixel noise."""
    rng = np.random.default_rng(seed)
    cell = size // 3
    out = np.empty((n, size, size, 3), np.float32)
    for i in range(n):
        img = np.full((size, size, 3), 105, np.float32)
        for c in rng.choice(9, size=int(rng.integers(1, 3)), replace=False):
            r = max(2, min(int(cell * (0.22, 0.42)[rng.integers(0, 2)]), cell // 2 - 1))
            cy, cx = (c // 3) * cell + cell // 2, (c % 3) * cell + cell // 2
            jit = cell // 2 - r - 1
            if jit > 0:
                cy += int(rng.integers(-jit, jit + 1))
                cx += int(rng.integers(-jit, jit + 1))
            tex = int(rng.integers(0, 8))
            y, x = np.mgrid[-r:r, -r:r] + 0.5
            ang, freq = (tex % 4) * np.pi / 4, (1.6 if tex < 4 else 3.6) * np.pi / r
            field = 0.775 + 0.225 * np.sign(np.sin((x * np.cos(ang) + y * np.sin(ang)) * freq))
            mask = _shape_mask(int(rng.integers(0, 8)), r)
            patch = img[cy - r:cy + r, cx - r:cx + r]
            patch[mask] = (field[..., None] * _RED)[mask]
        img += rng.normal(0, 6.0, img.shape)
        out[i] = np.clip(img, 0, 255).astype(np.uint8) / 255.0
    return out


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, calls=1, warmup=3, reps=10):
    """Milliseconds per call of fn(): CUDA events around ``calls`` calls in a
    row, after ``warmup`` calls; the median over ``reps`` such runs."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def host_ms(fn, calls=20, reps=5):
    """Milliseconds of host time per call of fn(), not waiting for the
    device: what the wrapper costs the host (checks, allocations,
    launches).  The median over ``reps`` runs of ``calls`` calls."""
    import torch
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def device_times(fn, calls=10):
    """Busy device time per call of each kernel fn launches, in ms by kernel
    name, from one torch.profiler (CUPTI) window of ``calls`` calls; host
    gaps between launches are not counted.  Device activity only: host
    operations are not recorded (a beam decode runs thousands)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            out[e.name] = out.get(e.name, 0.0) + e.device_time_total / calls / 1e3
    return out


def busy_of(times, name=None):
    """The busy ms of the kernels in ``times`` whose name contains ``name``
    (all of them for None); None where the profiler recorded none."""
    total = sum(ms for k, ms in times.items() if name is None or name in k)
    return total if total > 0 else None


def device_ms(fn, name=None, calls=10):
    """Busy device time per call of the kernels whose name contains
    ``name``, or of every kernel fn launches (``device_times``)."""
    return busy_of(device_times(fn, calls), name)


def ptxas_summary(log):
    """One (kernel, type, registers, spill line) per kernel instance of an
    ``nvcc -Xptxas=-v`` log; the type is the template argument."""
    out, inst, spill = [], ("?", "?"), ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"_ZN3sat\d+(\w+?)I(f|13__nv_bfloat16)E", line)
            inst = (m.group(1), "f32" if m.group(2) == "f" else "bf16") if m else ("?", "?")
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line:
            out.append((*inst, line.split(":", 1)[1].strip(), spill))
    return out


def spilled(spill_line):
    """Whether a ptxas ``... bytes spill stores, ... bytes spill loads`` line
    reports a spill."""
    return any(int(n) for n in re.findall(r"(\d+) bytes spill", spill_line))


def check(ok, what):
    """A failed check ends the run: nonzero exit, no result line."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def step_flops(L, D, A, H, E):
    """Multiply-adds x 2 of one decode step for one row (GEMVs, attention)."""
    return 2 * (H * A + L * A + L * D + H * D + (E + D + H) * 4 * H + H * E + D * E)


def bound(nbytes_moved, ops, dtype_name):
    t_bytes = nbytes_moved / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def agreement(a, b):
    """Rows whose tokens and lengths are identical, as a boolean mask."""
    return ((a.tokens[:, 0] == b.tokens[:, 0]).all(-1)
            & (a.lengths[:, 0] == b.lengths[:, 0]))


def same_share(a, b):
    """The share of images whose best captions are equal."""
    return sum(x == y for x, y in zip(a, b)) / len(a)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from sat_tpu_torch.decode.api import unpack_beam_result
    from sat_tpu_torch.decode.beam import beam_search, greedy_decode
    from sat_tpu_torch.kernels import _build
    from sat_tpu_torch.kernels import decoder_step as KS
    from sat_tpu_torch.kernels import greedy_loop as KL
    from sat_tpu_torch.models import decoder as TD
    from sat_tpu_torch.train.checkpoints import load_model_from_checkpoint

    report, stamps = {}, {"device": time.perf_counter()}
    dev = torch.device(DEVICE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. device ------------------------------------------------------------
    card = card_line()
    print(card)
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {kind}, {torch.cuda.device_count()} visible, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    report["card"] = card

    # -- 2. build ---------------------------------------------------------------
    stamps["build"] = time.perf_counter()
    t0 = time.perf_counter()
    for k, log in _build.build().items():
        for kern, typ, regs, spill in ptxas_summary(log):
            print(f"[ptxas] {k} {kern} {typ}: {regs}; {spill}")
            check(not (kern.startswith(("greedy_loop_", "decoder_step_"))
                       and spilled(spill)), f"{kern} {typ} spills")
    for name in _build.SOURCES:
        _build.load(name)
    report["build_s"] = time.perf_counter() - t0
    print(f"[build] {', '.join(_build.SOURCES)} built and loaded in "
          f"{report['build_s']:.1f} s", flush=True)

    # -- 3. kernels against their plain versions --------------------------------
    stamps["kernels"] = time.perf_counter()
    model, _ = load_model_from_checkpoint(CKPT)       # device defaults to cuda
    cfg, params = model.cfg, model.decoder
    imgs = torch.from_numpy(scenes(B, cfg.input_size, seed=0)).to(dev)
    annots = model.encode(imgs)
    L, D = annots.shape[1:]
    att_enc = TD.attention_precompute(params, annots)
    h0, c0 = TD.init_lstm_state(params, annots, cfg)
    h0, c0 = h0[0].contiguous(), c0[0].contiguous()
    fw = KS.pack_fused_weights(params, cfg, torch.float32)
    sw = KS.pack_loop_weights(fw)
    H, E, A, V = cfg.decoder_dim, cfg.embed_dim, cfg.attention_dim, cfg.vocab_size
    plans = {"greedy loop phases": KL.loop_plan(B, L, D, A, H, E, V),
             "decoder step kernels": KS.step_plan(B, L, D, A, H, E)}
    report["loop_plan"], report["step_plan"] = plans.values()
    for what, plan in plans.items():
        print(f"[design] {what}, f32 B={B}: " + "; ".join(
            f"{k} grid {g} x {n} threads, smem {dyn} B dynamic + {st} B static"
            for k, (g, n, dyn, st) in plan.items()), flush=True)
        for k in ("hside", "gates", "deepout"):
            check(plan[k][0][0] * plan[k][0][1] * plan[k][0][2] >= 64,
                  f"{what}: {k} fills 64 blocks")
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        1, cfg.vocab_size, size=B)).to(dev)
    e = TD.embed_tokens(params, ids, cfg).contiguous()

    def check_step(label, args, rel=1e-4):
        """The step kernels against their plain version on ``args``: each
        output within ``rel`` of its own scale.  Returns the outputs and
        each one's max abs error."""
        got = KS.fused_decoder_step(*args)
        ref = KS.fused_decoder_step_plain(*args)
        torch.cuda.synchronize()
        errs = {}
        for name, g, r in zip(("t", "h", "c", "z", "alpha"), got, ref):
            check(g.shape == r.shape and torch.isfinite(g).all(),
                  f"{label}: decoder_step {name} shape and finite values")
            err = (g.float() - r.float()).abs().max().item()
            tol = rel * max(1.0, r.float().abs().max().item())
            check(err <= tol, f"{label}: decoder_step {name}: {err} > {tol}")
            errs[name] = err
        print(f"[check] decoder_step kernels vs plain, {label}: max abs err "
              + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()), flush=True)
        return got, errs

    # float32 sums taken in another order: ~1e-6 of the operands' scale;
    # 1e-4 of each output's own scale leaves two orders of margin (z
    # carries the annotations' scale, ~200 at n64)
    step_args = (sw, cfg, e, h0, c0, annots, att_enc)
    got, step_err = check_step(f"f32 B={B}", step_args)
    # bfloat16: outputs may differ by one rounding step of the output type
    bf = lambda x: x.to(torch.bfloat16).contiguous()
    step_args16 = (KS.step_weights(params, cfg, torch.bfloat16), cfg,
                   *map(bf, (e, h0, c0, annots, att_enc)))
    _, step_err16 = check_step(f"bf16 B={B}", step_args16, rel=1e-2)

    lw = KL.loop_weights(params, cfg, torch.float32)
    loop_args = (*lw, cfg, annots, att_enc, h0, c0)
    kl = KL.greedy_loop(*loop_args, max_gen_length=S)
    pl = KL.greedy_loop_plain(*loop_args, max_gen_length=S)
    torch.cuda.synchronize()
    same = (kl[0] == pl[0]).all(-1) & (kl[3] == pl[3]) & (kl[4] == pl[4])
    rate = same.float().mean().item()
    check(rate >= 0.99, f"greedy_loop tokens agree on {rate:.3f} of rows")
    loop_err = max((kl[2] - pl[2])[same].abs().max().item(),
                   (kl[1] - pl[1])[same].abs().max().item())
    # scores sum up to S+1 log-probs of logits reaching ~30; alphas are in [0, 1]
    check(loop_err <= 1e-3, f"greedy_loop scores/alphas differ by {loop_err}")
    check(torch.isfinite(kl[1]).all() and torch.isfinite(kl[2]).all(),
          "greedy_loop alphas and scores are finite")
    print(f"[check] greedy_loop kernel vs plain, f32 B={B} S={S}: tokens and "
          f"lengths agree on {rate * 100:.1f}% of rows, max abs err of scores "
          f"and alphas {loop_err:.2e}", flush=True)

    # other shapes: several 64-row tiles (B_BEAM, B_WIDE), and the golden
    # checkpoint's narrow widths (H 12, A 8, E 8, V 24, L 1) for the ragged
    # tiles and the scalar GEMV paths
    golden, _ = load_model_from_checkpoint(GOLDEN)
    for label, m, n in ((f"n64 B={B_BEAM}", model, B_BEAM),
                        (f"n64 B={B_WIDE}", model, B_WIDE), ("golden B=13", golden, 13)):
        x = torch.from_numpy(scenes(n, m.cfg.input_size, seed=2)).to(dev)
        an = m.encode(x)
        ae = TD.attention_precompute(m.decoder, an)
        hh, cc = TD.init_lstm_state(m.decoder, an, m.cfg)
        hh, cc = hh[0].contiguous(), cc[0].contiguous()
        ee = TD.embed_tokens(m.decoder, torch.full((n,), 3, device=dev), m.cfg)
        args = (KS.step_weights(m.decoder, m.cfg), m.cfg, ee, hh, cc, an, ae)
        got_n, err_n = check_step(label, args)
        if n == B_BEAM and m is model:
            beam_step_args, beam_step_out, beam_step_err = args, got_n, err_n
        la = (*KL.loop_weights(m.decoder, m.cfg, torch.float32), m.cfg, an, ae, hh, cc)
        k2, p2 = KL.greedy_loop(*la, max_gen_length=S), KL.greedy_loop_plain(*la, max_gen_length=S)
        ok = (k2[0] == p2[0]).all(-1) & (k2[3] == p2[3])
        check(ok.float().mean().item() >= 0.99, f"{label}: greedy_loop tokens")
        check((k2[2] - p2[2])[ok].abs().max().item() <= 1e-3, f"{label}: greedy_loop scores")
        print(f"[check] {label}: both kernels agree with their plain versions",
              flush=True)

    # -- 4. greedy path -------------------------------------------------------------
    stamps["greedy"] = time.perf_counter()
    KS.launches = KL.launches = 0
    model, _ = load_model_from_checkpoint(CKPT)
    annots = model.encode(imgs)
    res_loop = greedy_decode(model.decoder, model.cfg, annots, max_gen_length=S)
    res_step = greedy_decode(model.decoder, model.cfg, annots, max_gen_length=S,
                             fused=True)
    res_plain = greedy_decode(model.decoder, model.cfg, annots, max_gen_length=S,
                              fused=False)
    captions, scores, alphas, _ = unpack_beam_result(res_loop, model.grid_hw)
    torch.cuda.synchronize()
    launches = {"decoder_step": KS.launches, "greedy_loop": KL.launches}
    print(f"[main] launches in the main path: {launches}", flush=True)
    check(launches["greedy_loop"] > 0 and launches["decoder_step"] > 0,
          "both kernels launched on the main path")
    words = [" ".join(model.vocab.itos(t) for t in c) for c in captions]
    for w in words[:4]:
        print(f"[main] caption: {w}")
    for r in (res_loop, res_step, res_plain):
        check(r.tokens.shape == (B, 1, S + 2) and r.alphas.shape == (B, 1, S + 1, L),
              "result shapes")
        check(torch.isfinite(r.scores).all() and torch.isfinite(r.alphas).all(),
              "scores and alphas are finite")
    agree = {"loop_vs_plain": agreement(res_loop, res_plain).float().mean().item(),
             "step_vs_plain": agreement(res_step, res_plain).float().mean().item()}
    check(min(agree.values()) >= 0.99, f"token agreement {agree}")
    check(all(len(a) == len(c) for a, c in zip(alphas, captions)),
          "one attention map per caption word")
    n_done = int((res_loop.lengths < S).sum())
    print(f"[main] token agreement {agree}; {n_done}/{B} captions end before "
          f"max_gen_length", flush=True)
    # reference on a small input: the same images through the port on the CPU
    cpu_model, _ = load_model_from_checkpoint(CKPT, device="cpu")
    ref = greedy_decode(cpu_model.decoder, cpu_model.cfg,
                        cpu_model.encode(imgs[:4].cpu()), max_gen_length=S)
    check(torch.equal(ref.tokens, res_loop.tokens[:4].cpu()), "GPU tokens equal the CPU's")
    print("[main] first 4 captions equal the CPU run's", flush=True)

    # -- 5. beam path -------------------------------------------------------------------
    stamps["beam"] = time.perf_counter()
    beam_kw = dict(beamk=K_BEAM, max_gen_length=S, rescore_method="LN")
    KS.launches = KL.launches = 0
    beam_caps = model.caption(imgs, **beam_kw)[0]
    torch.cuda.synchronize()
    beam_launches = {"decoder_step": KS.launches, "greedy_loop": KL.launches}
    print(f"[beam] launches in model.caption (beamk {K_BEAM}, LN): {beam_launches}",
          flush=True)
    check(beam_launches["decoder_step"] == S + 1 and beam_launches["greedy_loop"] == 0,
          "model.caption ran the step kernels once per step")
    res_bk = beam_search(model.decoder, model.cfg, annots, **beam_kw)
    res_bp = beam_search(model.decoder, model.cfg, annots, fused=False, **beam_kw)
    torch.cuda.synchronize()
    for r in (res_bk, res_bp):
        check(r.tokens.shape == (B, K_BEAM, S + 2)
              and r.alphas.shape == (B, K_BEAM, S + 1, L), "beam result shapes")
        check(torch.isfinite(r.scores).all() and torch.isfinite(r.raw_scores).all(),
              "beam scores are finite")
    best_k = unpack_beam_result(res_bk, model.grid_hw)[0]
    best_p = unpack_beam_result(res_bp, model.grid_hw)[0]
    check(best_k == beam_caps, "model.caption equals beam_search + unpack")
    beam_agree = same_share(best_k, best_p)
    check(beam_agree >= 0.99, f"beam best captions agree on {beam_agree:.3f} of images")
    ref_b = beam_search(cpu_model.decoder, cpu_model.cfg,
                        cpu_model.encode(imgs[:4].cpu()), **beam_kw)
    check(unpack_beam_result(ref_b, cpu_model.grid_hw)[0] == best_k[:4],
          "beam: GPU best captions equal the CPU's")
    beam_words = [" ".join(model.vocab.itos(t) for t in c) for c in best_k]
    for w in beam_words[:4]:
        print(f"[beam] caption: {w}")
    beam_done = int((res_bk.lengths < S).sum())
    print(f"[beam] best captions of the step kernels and the plain path agree on "
          f"{beam_agree * 100:.1f}% of images; first 4 equal the CPU run's; "
          f"{beam_done}/{B * K_BEAM} hypotheses end before max_gen_length",
          flush=True)

    # -- 6. bfloat16 -----------------------------------------------------------------
    stamps["bf16"] = time.perf_counter()
    m16 = copy.deepcopy(model).to(torch.bfloat16)
    a16 = m16.encode(imgs)
    r16_loop = greedy_decode(m16.decoder, m16.cfg, a16, max_gen_length=S)
    r16_step = greedy_decode(m16.decoder, m16.cfg, a16, max_gen_length=S, fused=True)
    lw16 = KL.loop_weights(m16.decoder, m16.cfg, torch.bfloat16)
    h16, c16 = TD.init_lstm_state(m16.decoder, a16, m16.cfg)
    la16 = (*lw16, m16.cfg, a16, TD.attention_precompute(m16.decoder, a16),
            h16[0].contiguous(), c16[0].contiguous())
    k16, p16 = KL.greedy_loop(*la16, max_gen_length=S), KL.greedy_loop_plain(*la16, max_gen_length=S)
    r16_dec = greedy_decode(m16.decoder, m16.cfg, annots.to(torch.bfloat16),
                            max_gen_length=S)
    bf16 = {"loop_vs_f32_plain": agreement(r16_loop, res_plain).float().mean().item(),
            "loop_on_f32_annotations_vs_f32_plain":
                agreement(r16_dec, res_plain).float().mean().item(),
            "step_vs_f32_plain": agreement(r16_step, res_plain).float().mean().item(),
            "loop_kernel_vs_plain": ((k16[0] == p16[0]).all(-1) & (k16[3] == p16[3]))
            .float().mean().item()}
    serve_kw = dict(beam_kw, early_exit=True)
    r16_beam = beam_search(m16.decoder, m16.cfg, a16, **serve_kw)
    bf16["beam_serving_vs_f32_kernels"] = same_share(
        unpack_beam_result(r16_beam, m16.grid_hw)[0], best_k)
    bf16["beam_serving_finite"] = bool(torch.isfinite(r16_beam.scores).all())
    print(f"[bf16] token agreement: {bf16}", flush=True)

    # -- 7. timing ----------------------------------------------------------------------
    stamps["timing"] = time.perf_counter()
    f32 = "float32"
    calls = {  # name: (function, calls per timed run, kernel name for the profiler)
        "decoder_step": (lambda: KS.fused_decoder_step(*step_args), 20, "decoder_step_"),
        "decoder_step_plain": (lambda: KS.fused_decoder_step_plain(*step_args), 20, None),
        "decoder_step_bf16": (lambda: KS.fused_decoder_step(*step_args16), 20,
                              "decoder_step_"),
        "decoder_step_192": (lambda: KS.fused_decoder_step(*beam_step_args), 20,
                             "decoder_step_"),
        "decoder_step_192_plain": (lambda: KS.fused_decoder_step_plain(*beam_step_args),
                                   20, None),
        "greedy_loop": (lambda: KL.greedy_loop(*loop_args, max_gen_length=S), 1,
                        "greedy_loop_"),
        "greedy_loop_plain": (lambda: KL.greedy_loop_plain(*loop_args, max_gen_length=S),
                              1, None),
        "greedy_loop_bf16": (lambda: KL.greedy_loop(*la16, max_gen_length=S), 1,
                             "greedy_loop_"),
    }
    for label, mm in (("", model), ("_bf16", m16)):
        calls["encode" + label] = (lambda mm=mm: mm.encode(imgs), 1, None)
    for label, fused, mm in (("loop", None, model), ("step", True, model),
                             ("plain", False, model), ("loop_bf16", None, m16)):
        calls["captioning_" + label] = (
            lambda mm=mm, fused=fused: greedy_decode(
                mm.decoder, mm.cfg, mm.encode(imgs), max_gen_length=S, fused=fused),
            1, None)
    for label, fused, mm, kw in (("kernels", None, model, beam_kw),
                                 ("plain", False, model, beam_kw),
                                 ("kernels_bf16_serving", None, m16, serve_kw)):
        calls["beam_captioning_" + label] = (
            lambda mm=mm, fused=fused, kw=kw: beam_search(
                mm.decoder, mm.cfg, mm.encode(imgs), fused=fused, **kw), 1, None)
    ms = {k: cuda_ms(fn, calls=n) for k, (fn, n, _) in calls.items()}
    # one profiler window per entry; a beam decode records thousands of events
    dev_times = {k: device_times(fn, calls=3 if k.startswith("beam_") else 10)
                 for k, (fn, _, _) in calls.items()}
    busy = {k: busy_of(dev_times[k], name) for k, (_, _, name) in calls.items()}
    print(f"[time] per call, CUDA events (B={B}): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items()), flush=True)
    print("[time] busy device time per call, torch.profiler: "
          + ", ".join(f"{k} {'not measured' if v is None else f'{v:.3f} ms'}"
                      for k, v in busy.items()), flush=True)
    phase_busy = {f"{ph}{label}": busy_of(dev_times["greedy_loop" + label], "greedy_loop_" + ph)
                  for label in ("", "_bf16") for ph in KL.PHASES}
    step_busy = {f"{k}{label}": busy_of(dev_times["decoder_step" + label], "decoder_step_" + k)
                 for label in ("", "_bf16", "_192") for k in KS.KERNELS}
    print(f"[time] step kernels (B={B}; _192: B={B_BEAM}), busy device time per call, "
          "torch.profiler: "
          + ", ".join(f"{k} {'not measured' if v is None else f'{v * 1e3:.1f} us'}"
                      for k, v in step_busy.items()), flush=True)
    step_host = {k: host_ms(calls[k][0]) for k in ("decoder_step", "decoder_step_bf16")}
    print("[time] step wrapper, host time per call (checks, 9 allocations, 6 "
          "launches): " + ", ".join(f"{k} {v:.3f} ms" for k, v in step_host.items()),
          flush=True)
    batch_steps = int(torch.where(kl[4], kl[3] + 1, S + 1).max())
    print(f"[time] loop phases ({batch_steps} of {S + 1} steps run before every row "
          "finished), busy device time per decode, torch.profiler: "
          + ", ".join(f"{k} {'not measured' if v is None else f'{v:.3f} ms'}"
                      for k, v in phase_busy.items()), flush=True)
    e2e = {}
    for k in ms:
        if k.startswith("beam_captioning_"):
            e2e[k] = {"ms": ms[k], "imgs_per_s": B / ms[k] * 1e3,
                      "device_idle": None if busy[k] is None else 1 - busy[k] / ms[k]}
            idle = e2e[k]["device_idle"]
            print(f"[time] beam captioning ({k[16:]}, beamk {K_BEAM}, LN): "
                  f"{ms[k]:.3f} ms / batch of {B}, {e2e[k]['imgs_per_s']:.0f} imgs/s, "
                  f"busy {'not measured' if busy[k] is None else f'{busy[k]:.3f} ms'}, "
                  f"device idle {'not measured' if idle is None else f'{idle:.1%}'}",
                  flush=True)
        if k.startswith("captioning_"):
            e2e[k] = {"ms": ms[k], "imgs_per_s": B / ms[k] * 1e3,
                      "device_idle": None if busy[k] is None else 1 - busy[k] / ms[k]}
            idle = e2e[k]["device_idle"]
            print(f"[time] greedy captioning ({k[11:]}): {ms[k]:.3f} ms / batch of "
                  f"{B}, {e2e[k]['imgs_per_s']:.0f} imgs/s, device idle "
                  f"{'not measured' if idle is None else f'{idle:.1%}'}", flush=True)

    # bounds: inputs read once, outputs written once; operations of this run
    step_bytes = nbytes(e, h0, c0, annots, att_enc, *fw, *got)
    step_bound, step_by = bound(step_bytes, B * step_flops(L, D, A, H, E), f32)
    beam_bytes = nbytes(*beam_step_args[2:], *fw, *beam_step_out)
    beam_bound, beam_by = bound(beam_bytes, B_BEAM * step_flops(L, D, A, H, E), f32)
    beam_calls = {"step_calls_per_batch": beam_launches["decoder_step"],
                  "kernel_launches_per_batch": beam_launches["decoder_step"] * len(KS.KERNELS),
                  "step_ms_192": ms["decoder_step_192"],
                  "step_busy_ms_192": busy["decoder_step_192"],
                  "step_bound_ms_192": beam_bound, "step_bound_by_192": beam_by}
    print(f"[time] beam path: {beam_calls}", flush=True)
    steps_run = torch.where(kl[4], kl[3] + 1, S + 1).sum().item()
    loop_bytes = nbytes(annots, att_enc, h0, c0, *fw, *lw[1:], *kl)
    loop_ops = steps_run * (step_flops(L, D, A, H, E) + 2 * E * V)
    loop_bound, loop_by = bound(loop_bytes, loop_ops, f32)

    kernels = [
        # at the beam path's rows, with its launch count (model.caption)
        {"name": "decoder_step", "route": "cuda",
         "source": "sat_tpu_torch/csrc/decoder_step.cu",
         "replaces": "sat_tpu/kernels/decoder_step.py:72",
         "launches": beam_launches["decoder_step"], "rows": B_BEAM,
         "max_abs_err": max(beam_step_err.values()),
         "ms": ms["decoder_step_192"], "plain_ms": ms["decoder_step_192_plain"],
         "bound_ms": beam_bound, "bound_by": beam_by, "library_ms": None},
        {"name": "greedy_loop", "route": "cuda",
         "source": "sat_tpu_torch/csrc/greedy_loop.cu",
         "replaces": "sat_tpu/kernels/greedy_loop.py:42",
         "launches": launches["greedy_loop"], "rows": B, "max_abs_err": loop_err,
         "ms": ms["greedy_loop"], "plain_ms": ms["greedy_loop_plain"],
         "bound_ms": loop_bound, "bound_by": loop_by, "library_ms": None},
    ]
    report.update(kernels=kernels, step_err=step_err, loop_agreement=rate,
                  greedy_launches=launches, beam_launches=beam_launches,
                  beam_agreement=beam_agree, beam=beam_calls,
                  beam_captions=beam_words[:8], beam_finished=beam_done,
                  step_64={"ms": ms["decoder_step"], "plain_ms": ms["decoder_step_plain"],
                           "bound_ms": step_bound, "bound_by": step_by},
                  main_agreement=agree, bf16=bf16, e2e=e2e, call_ms=ms, busy_ms=busy,
                  loop_phase_busy_ms=phase_busy, step_kernel_busy_ms=step_busy,
                  step_host_ms=step_host,
                  step_err_bf16=step_err16,
                  kernel_launches_per_call={"decoder_step": len(KS.KERNELS),
                                            "greedy_loop": len(KL.PHASES) * (S + 1)},
                  loop_batch_steps=batch_steps,
                  loop_rows_steps=steps_run,
                  captions=words[:8], finished=n_done, batch=B, max_gen_length=S)
    stamps["end"] = time.perf_counter()
    names = list(stamps)
    report["phase_s"] = {a: stamps[b] - stamps[a] for a, b in zip(names, names[1:])}
    print("[time] seconds per phase of this script: " + ", ".join(
        f"{k} {v:.1f}" for k, v in report["phase_s"].items()), flush=True)
    print("[report] " + json.dumps(report))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
