"""Shared set-up of the harness's CPU tests: a checkout root in a temporary
folder holding a tiny configuration and cells beside the real ones, run on
the CPU with the port's plain paths."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY_SAT = {"encoder_arch": "shufflenet_v2_x0_5", "input_size": 64, "encoder_size": None,
            "embed_dim": 16, "attention_dim": 8, "decoder_dim": 32, "decoder_layers": 1,
            "deep_output": True, "vocab_size": 64, "precision": 32}
TINY_LIMITS = {"annot": 1e-4, "score": 1e-4, "alpha": 1e-4, "rank": 1e-3}
TINY_SEARCH = {"search": 3.0}      # beam search only


def tiny_root(tmp: Path, decode: str = "beam") -> Path:
    """A root with BENCHMARK.json naming one tiny cell ``tiny.<decode>``."""
    shutil.copytree(REPO / "portbench", tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    pb = tmp / "portbench"
    (pb / "configs" / "tiny.json").write_text(json.dumps(
        {"name": "tiny", "source": "test", "reduced": [], "sat": TINY_SAT}))
    traffic = {"decode": decode, "batch": 4, "distinct_batches": 2, "px": 64,
               "beamk": 3, "max_gen_length": 5, "rescore_method": "LN",
               "early_exit": True}
    (pb / "traffic" / f"tiny-{decode}.json").write_text(json.dumps(traffic))
    cell = f"tiny.{decode}"
    (pb / "workloads" / f"{cell}.json").write_text(json.dumps(
        {"config": "tiny", "traffic": f"tiny-{decode}", "driver": "caption_closed",
         "warmup_requests": 1, "sample_from": 2, "sample_requests": 2,
         "trace_skip": 0, "trace_requests": 2,
         "limits": dict(TINY_LIMITS, **(TINY_SEARCH if decode == "beam" else {}))}))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "test",
                             "file": "portbench/configs/tiny.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": cell, "config": "tiny",
                               "traffic": f"tiny-{decode}", "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if ("workloads" in m and m["name"].startswith(("caption", "decode_kernels"))
                and not m["name"].endswith("host_paced")):
            m["workloads"].append(cell)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def last_json(capsys):
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])


def run_tiny(tmp: Path, capsys, decode: str = "beam", trace: int = 0, seed: int = 2 ** 31 + 7,
             seconds: float = 0.5):
    """One CPU run of the tiny cell; (exit code, the result line)."""
    from portbench import run
    root = tiny_root(tmp, decode)
    rc = run.main(["--workload", f"tiny.{decode}", "--seed", str(seed), "--seconds",
                   str(seconds), "--trace", str(trace)], root=root, device="cpu")
    return rc, last_json(capsys)
