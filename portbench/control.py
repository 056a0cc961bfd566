"""The control of a captioning cell's comparison: the plain reference put in
the program's place and computed one precision below the configuration's
(float32 with TF32 on, where the configuration states float32 with TF32
off), on the cell's own inputs and sampled requests, judged by the same
comparison as a run.  The comparison is sound only if the control fails it.
The other kinds put a selection fault in the program's place instead: the
reference at the configuration's precision, choosing wrong words or
hypotheses and serving them with their own log-probabilities, so that its
scores and attention maps agree with themselves.  ``second_best``: each step
takes the words ranked one below the right ones (greedy: the second best;
beam: each slot's ranks 2 .. k+1), for ``rank`` to catch.  Beam search only:
``second_stage`` keeps the union's candidates of ranks 2 .. k+1 after step
0, and ``worst_hypothesis`` serves each image's worst hypothesis, for
``search`` to catch.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 [--kind <kind>]

prints one JSON line per seed with the compared numbers, and the cell's
limits.  The benchmark's own runs do not run it."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent


KINDS = ("tf32", "second_best", "second_stage", "worst_hypothesis")


def control_outputs(ctx, sd, images, scfg, grid_hw, kind: str = "tf32"):
    """What the program's place would hold: the reference's annotations and
    decode, computed with TF32 on (``tf32``), or at full precision with the
    selection fault ``kind``."""
    import torch
    from portbench.drivers import caption_closed as CC
    from portbench.reference import decoder as RD
    from portbench.reference import encoders as RE
    s, tr = ctx.config["sat"], ctx.traffic
    w, sp, S = RD.Weights(sd), CC.specials(scfg), tr["max_gen_length"]
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    tf32, pick = kind == "tf32", int(kind == "second_best")
    if tr["decode"] != "beam" and kind in ("second_stage", "worst_hypothesis"):
        raise SystemExit(f"--kind {kind} is a fault of beam search")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        annots = RE.encode(sd, s["encoder_arch"], images, s.get("encoder_size"))
        if tr["decode"] == "beam":
            out = RD.beam_search(w, sp, annots, tr["beamk"], S, grid_hw, pick=pick,
                                 keep=int(kind == "second_stage"),
                                 worst=kind == "worst_hypothesis")
        else:
            toks, raw, alphas, lens = RD.greedy(w, sp, annots, S, pick=pick)
            out = (SimpleNamespace(tokens=toks[:, None], raw_scores=raw[:, None],
                                   alphas=alphas[:, None], lengths=lens[:, None]),)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    return {"annots": annots, "images": images, "out": out}


def readings(ctx, kind: str = "tf32") -> Dict[str, float]:
    """The control's compared numbers on the seed ``ctx.seed``."""
    import numpy as np
    import torch
    from portbench.common import traffic, weights
    from portbench.drivers import caption_closed as CC
    tr, cell, dev = ctx.traffic, ctx.cell, ctx.device
    scfg = CC.sat_config(ctx.config, ctx.seed)
    sd = weights.draw(ctx.config, ctx.seed, dev)
    gen = torch.Generator(dev).manual_seed(ctx.seed ^ 0x5EED)
    batches = [traffic.scenes(tr["batch"], tr["px"], gen)
               for _ in range(tr["distinct_batches"])]
    rng = np.random.default_rng(ctx.seed)
    sample = sorted(rng.choice(cell["sample_from"], cell["sample_requests"],
                               replace=False).tolist())
    side = CC.grid_side(ctx.config)
    outs = {j: control_outputs(ctx, sd, batches[j % tr["distinct_batches"]], scfg,
                               (side, side), kind) for j in sample}
    k = tr.get("beamk", 1) if tr["decode"] == "beam" else 1
    return CC.compare(ctx, sd, outs, [], scfg, tr["max_gen_length"], k,
                      tr["decode"] == "beam")


def main(argv: Optional[List[str]] = None, *, root: Path = ROOT,
         device: Optional[str] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--kind", choices=KINDS, default="tf32")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(root))
    from portbench import run
    found = run.find_cell(root, args.workload)
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = run.card(found.entry["chips"]) if device is None else torch.device(device)
    if dev is None:
        return 3
    log = lambda msg: print(f"[control] {msg}", file=sys.stderr, flush=True)
    for seed in (int(x) for x in args.seeds.split(",")):
        ctx = SimpleNamespace(config=found.config, traffic=found.traffic,
                              cell=found.cell, seed=seed, device=dev, log=log)
        got = readings(ctx, args.kind)
        print(json.dumps({"workload": args.workload, "seed": seed, "kind": args.kind,
                          "control": got, "limits": found.cell["limits"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
