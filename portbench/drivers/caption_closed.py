"""Captioning in a closed loop with one client: each request is a batch of
seeded 224 px scenes, drawn in turn from a few distinct batches, handed to
the port's entry and done when its results are on the host.

Traffic keys: ``decode`` ("beam": ``SATModel.caption`` as ``serve`` calls
it, with ``beamk``, ``rescore_method``, ``early_exit``; "greedy":
``SATModel.encode`` then ``decode.beam.greedy_decode``, the loop kernel),
``batch``, ``distinct_batches``, ``max_gen_length``, ``px``.  Both take
``fused=None``, the port's default route.

After the window the sampled requests are held against the plain
reference (``reference/``): the annotations the encoder produced (read by a
forward hook on those requests), the served captions scored by teacher
forcing (``reference.decoder.score_beam_captions`` / ``score_greedy``), and
for beam search the share of served captions that score below the
reference's own beam search's best (``search``).
With ``trace`` on, host ranges named after the port's layers are opened
around calls into them, from this file, and a profiler window covers a few
requests of the window."""

from __future__ import annotations

import contextlib
import gc
import statistics
import time
from typing import Any, Dict, List

import numpy as np
import torch

from portbench.common import profwin, traffic, weights
from portbench.reference import decoder as RD
from portbench.reference import encoders as RE


def sat_config(cfg: Dict, seed: int):
    """The port's ``SATConfig`` of a configuration file's ``sat`` block, with
    a synthetic vocabulary (words w1 .., then UNK, START, END; PAD 0)."""
    from sat_tpu_torch.config import SATConfig
    s = dict(cfg["sat"])
    V = s["vocab_size"]
    stoi = {f"w{i}": i for i in range(1, V - 3)}
    stoi.update({"<UNK>": V - 3, "<START>": V - 2, "<END>": V - 1, "<PAD>": 0})
    s["encoder_dim"] = RE.out_channels(s["encoder_arch"])
    return SATConfig(vocab_stoi=stoi, seed=seed % (2 ** 31), **s)


def grid_side(cfg: Dict) -> int:
    """The side of the annotation grid: ``encoder_size``, else the
    backbones' output stride of 32."""
    s = cfg["sat"]
    return s.get("encoder_size") or s["input_size"] // 32


def specials(scfg) -> RD.Specials:
    s = scfg.vocab_stoi
    return RD.Specials(s["<START>"], s["<END>"], s["<PAD>"], s["<UNK>"])


def build(cfg: Dict, seed: int, device, log=lambda msg: None):
    """The port's model holding copies of the benchmark's drawn tensors, and
    the tensors, which the model never shares: the reference reads them as
    drawn.  Built as a checkpoint's model is
    (``models/jax_import.py::model_from_jax_tree``): the encoder's modules
    made without storage and given the tensors, the decoder's ``ParamTree``
    from the nested dict, then ``SATModel(cfg, grid, encoder, decoder)``;
    no initialiser runs."""
    from sat_tpu_torch.models.decoder import ParamTree
    from sat_tpu_torch.models.encoder import encoder_from_config
    from sat_tpu_torch.models.model import SATModel
    t0 = time.perf_counter()
    scfg = sat_config(cfg, seed)
    sd = weights.draw(cfg, seed, device)
    t1 = time.perf_counter()
    grid = (grid_side(cfg),) * 2
    with torch.device("meta"):
        encoder = encoder_from_config(scfg)
    encoder.load_state_dict({k[len("encoder."):]: v.clone() for k, v in sd.items()
                             if k.startswith("encoder.")}, strict=True, assign=True)
    tree: Dict[str, Any] = {}
    for k, v in sd.items():
        if k.startswith("decoder."):
            *path, leaf = k[len("decoder."):].split(".")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v.clone()
    model = SATModel(scfg, grid, encoder, ParamTree(tree)).eval()
    log(f"set-up: weights drawn in {t1 - t0:.2f} s (the card's first use), "
        f"the model built in {time.perf_counter() - t1:.2f} s")
    return model, sd


class Layers:
    """Host ranges around the port's layer entries, and the step and loop
    calls' shapes, while installed (traced runs only)."""

    def __init__(self, model):
        import sat_tpu_torch.decode.api as api
        import sat_tpu_torch.decode.beam as beam
        self.model, self.api, self.beam = model, api, beam
        self.step_calls: List[tuple] = []
        self.loop_outs: List[tuple] = []
        self.saved = {}
        self.on = False          # record shapes while the profiler is open

    def _wrap(self, mod, attr, name, record=None):
        fn = getattr(mod, attr)
        self.saved[(mod, attr)] = fn

        def wrapped(*a, **k):
            with profwin.span(name):
                out = fn(*a, **k)
            if record is not None and self.on:
                record(a, k, out)
            return out
        setattr(mod, attr, wrapped)

    def __enter__(self):
        enc = self.model.encoder
        fwd = enc.forward

        def forward(*a, **k):
            with profwin.span("encoder"):
                return fwd(*a, **k)
        enc.forward = forward
        self._wrap(self.api, "beam_search", "decode")
        self._wrap(self.api, "unpack_beam_result", "unpack")
        self._wrap(self.beam, "fused_decoder_step", "step",
                   lambda a, k, out: self.step_calls.append(
                       (a[2].shape[0], a[5].shape[0])))       # rows, images
        self._wrap(self.beam, "greedy_loop_decode", "loop",
                   lambda a, k, out: self.loop_outs.append(
                       (a[2].shape[0], out[3], out[4])))      # rows, flen, finished
        return self

    def __exit__(self, *exc):
        del self.model.encoder.forward
        for (mod, attr), fn in self.saved.items():
            setattr(mod, attr, fn)


def p95(values: List[float]) -> float:
    """The nearest-rank 95th percentile."""
    s = sorted(values)
    return s[max(0, int(np.ceil(0.95 * len(s))) - 1)]


def run(ctx) -> Dict[str, Any]:
    cfg, tr, cell, dev = ctx.config, ctx.traffic, ctx.cell, ctx.device
    B, S, nb = tr["batch"], tr["max_gen_length"], tr["distinct_batches"]
    beam = tr["decode"] == "beam"
    k = tr.get("beamk", 1) if beam else 1
    ctx.log(f"set-up: {time.perf_counter() - ctx.t_process:.2f} s to the driver")
    model, sd = build(cfg, ctx.seed, dev, ctx.log)
    scfg = model.cfg
    ctx.log(f"set-up: {time.perf_counter() - ctx.t_process:.2f} s to the model")
    gen = torch.Generator(dev).manual_seed(ctx.seed ^ 0x5EED)
    batches = [traffic.scenes(B, tr["px"], gen) for _ in range(nb)]
    ctx.log(f"set-up: {time.perf_counter() - ctx.t_process:.2f} s to the images")
    rng = np.random.default_rng(ctx.seed)
    sample = sorted(rng.choice(cell["sample_from"], cell["sample_requests"],
                               replace=False).tolist())
    captured: Dict[int, Any] = {}
    capture = {"on": None}

    def hook(_mod, _inp, out):
        if capture["on"] is not None:
            captured[capture["on"]] = {"annots": out.detach().clone(),
                                       "images": batches[capture["on"] % nb]}
    handle = model.encoder.register_forward_hook(hook)

    from sat_tpu_torch.decode.beam import greedy_decode

    def request(images):
        if beam:
            return model.caption(images, beamk=k, max_gen_length=S,
                                 rescore_method=tr.get("rescore_method"),
                                 early_exit=tr.get("early_exit", False))
        with (profwin.span("decode") if ctx.trace else contextlib.nullcontext()):
            res = greedy_decode(model.decoder, scfg, model.encode(images),
                                max_gen_length=S)
        return res, res.tokens.cpu(), res.raw_scores.cpu()

    layers = Layers(model) if ctx.trace else contextlib.nullcontext()
    with layers:
        for i in range(cell["warmup_requests"]):
            request(batches[i % nb])
            ctx.log(f"set-up: {time.perf_counter() - ctx.t_process:.2f} s to warm-up "
                    f"request {i}")
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        # no collector pauses in the window: the set-up's objects are frozen
        gc.collect()
        gc.freeze()
        gc.disable()
        t_start = time.perf_counter()
        setup_s = t_start - ctx.t_process
        lat, n_img, i, prof = [], 0, 0, None
        win = contextlib.ExitStack()
        lo, hi = cell["trace_skip"], cell["trace_skip"] + cell["trace_requests"]
        while True:
            if ctx.trace and i == lo:
                prof = win.enter_context(profwin.device_window())
                layers.on = True
            capture["on"] = i if i in sample else None
            t0 = time.perf_counter()
            with (profwin.span("request") if ctx.trace else contextlib.nullcontext()):
                out = request(batches[i % nb])
            t1 = time.perf_counter()
            if capture["on"] is not None:
                captured[i]["out"] = out
            lat.append(t1 - t0)
            n_img += B
            i += 1
            if ctx.trace and i == hi:
                layers.on = False
                win.close()
            if t1 - t_start >= ctx.seconds and (not ctx.trace or i >= hi):
                break
        window_s = time.perf_counter() - t_start
        gc.enable()
    handle.remove()
    capture["on"] = None
    gh, gw = model.grid_hw
    d = cfg["sat"]
    rec: Dict[str, Any] = {
        "kind": "caption", "dims": dict(L=gh * gw, D=scfg.encoder_dim, A=d["attention_dim"],
                                        H=d["decoder_dim"], E=d["embed_dim"],
                                        V=d["vocab_size"]),
        "setup_s": setup_s, "window_s": window_s, "latencies": lat,
        "requests": len(lat), "images": n_img, "beamk": k,
        "memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else 0)}
    if ctx.trace:
        ops, spans = profwin.window_events(prof)
        by = {}
        for o in ops:
            by[o.span or "(none)"] = by.get(o.span or "(none)", 0) + 1
        ctx.log(f"traced device operations by host range: {by}")
        rec.update(ops=ops, spans=spans, traced_requests=hi - lo,
                   step_calls=layers.step_calls,
                   loop_steps=[int(S + 1 if not bool(f.all()) else int(fl.max()) + 1)
                               for _, fl, f in layers.loop_outs],
                   loop_rows=[r for r, _, _ in layers.loop_outs])
    q = statistics.quantiles(lat, n=4) if len(lat) > 1 else lat * 3
    third = max(1, len(lat) // 3)
    ctx.log(f"requests {len(lat)} (batch {B}); the p95 is over {len(lat)} latencies; "
            f"quartiles {[round(1e3 * x, 3) for x in q]} ms; mean of the first and "
            f"last third {1e3 * sum(lat[:third]) / third:.3f}, "
            f"{1e3 * sum(lat[-third:]) / third:.3f} ms")
    if len(lat) > 1:
        cuts = statistics.quantiles(lat, n=100)
        slow = sum(x > 1.05 * q[1] for x in lat)
        ctx.log(f"latency tail: p90 {1e3 * cuts[89]:.3f}, p99 {1e3 * cuts[98]:.3f}, "
                f"max {1e3 * max(lat):.3f} ms; {slow} requests over 1.05 x the median")
    # the program's state goes before the reference runs
    outs = {j: captured[j] for j in sample if j in captured and "out" in captured[j]}
    missing = [j for j in sample if j not in outs]
    del model, batches
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rec["checks"] = compare(ctx, sd, outs, missing, scfg, S, k, beam)
    return rec


def compare(ctx, sd, outs, missing, scfg, S, k, beam) -> Dict[str, float]:
    """The widest gaps of the sampled requests to the reference, and for
    beam search the share (%) of their images whose served caption scores
    below the reference beam search's best."""
    s = ctx.config["sat"]
    w = RD.Weights(sd)
    sp = specials(scfg)
    worst = {"annot": 0.0, "score": 0.0, "alpha": 0.0, "rank": 0.0}
    if beam:
        worst["search"] = 0.0
    if missing:
        ctx.log(f"sampled requests never served: {missing}")
        worst = {n: float("inf") for n in worst}
    tokens = images = below = 0
    side = grid_side(ctx.config)
    for j, got in outs.items():
        ref = RE.encode(sd, s["encoder_arch"], got["images"], s.get("encoder_size"))
        a = got["annots"]
        worst["annot"] = max(worst["annot"], float((a - ref).abs().max()
                                                   / ref.abs().max()))
        if beam:
            caps, scores, alphas = got["out"][:3]
            gaps = RD.score_beam_captions(w, sp, ref, caps, scores, alphas, k, S)
            best = torch.tensor(RD.beam_search(w, sp, ref, k, S, (side, side))[1],
                                dtype=torch.float64, device=gaps.ln.device)
            below += int((best - gaps.ln > RD.SEARCH_TOL).sum())
            images += len(caps)
        else:
            res = got["out"][0]
            gaps = RD.score_greedy(w, sp, ref, res.tokens[:, 0], res.raw_scores[:, 0],
                                   res.alphas[:, 0], res.lengths[:, 0], S)
        tokens += gaps.tokens
        for n in ("score", "alpha", "rank"):
            worst[n] = max(worst[n], getattr(gaps, n))
    if beam and images:
        worst["search"] = 100.0 * below / images
        ctx.log(f"search: {below} of {images} served captions below the reference "
                f"beam search's best by more than {RD.SEARCH_TOL} nats a word")
    ctx.log(f"compared {len(outs)} requests, {tokens} served tokens")
    return worst
