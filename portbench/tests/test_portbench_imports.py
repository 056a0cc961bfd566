"""What the harness loads: no module whose top-level name (the part before
the first dot, compared whole) is jax, jaxlib, flax or sat_tpu in a whole
run; and no module of the port in the reference."""

from __future__ import annotations

import json
import subprocess
import sys

from portbench_fixtures import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "sat_tpu"}


def _modules(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=600, check=True,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO)})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_no_jax_package(tmp_path):
    code = f"""
import json, sys
sys.path.insert(0, {str(REPO / 'portbench' / 'tests')!r})
from pathlib import Path
from portbench_fixtures import tiny_root
from portbench import run
root = tiny_root(Path({str(tmp_path)!r}), "beam")
assert run.main(["--workload", "tiny.beam", "--seed", "5", "--seconds", "0.2",
                 "--trace", "1"], root=root, device="cpu") == 0
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    top = _modules(code)
    assert "sat_tpu_torch" in top and "portbench" in top
    assert not top & FORBIDDEN


def test_the_reference_loads_nothing_of_the_port():
    code = """
import json, sys, torch
from portbench.reference import decoder, encoders
from portbench.common import weights
cfg = {"sat": {"encoder_arch": "shufflenet_v2_x0_5", "input_size": 64, "embed_dim": 8,
               "attention_dim": 4, "decoder_dim": 8, "vocab_size": 16}}
sd = weights.draw(cfg, 1, "cpu")
a = encoders.encode(sd, "shufflenet_v2_x0_5", torch.rand(2, 64, 64, 3), None)
sp = decoder.Specials(13, 14, 0, 12)
decoder.greedy(decoder.Weights(sd), sp, a, 3)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""
    top = _modules(code)
    assert "portbench" in top
    assert not top & (FORBIDDEN | {"sat_tpu_torch"})
