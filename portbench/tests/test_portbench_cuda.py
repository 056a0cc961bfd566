"""On the card (marked ``cuda``; skips without one): the control of each
captioning cell, the reference put in the program's place with TF32 on,
fails the cell's comparison, the reference with its selection faults fails
the number meant to catch each (``rank``, and for beam search ``search``),
and the program passes, at a test-size batch of the cell's own
configuration.

    python -m pytest -p no:cacheprovider portbench/tests -m cuda"""

from __future__ import annotations

import json
import shutil

import pytest

from portbench_fixtures import REPO

CELLS = ["shufflenet-v124.beam3-b512", "resnet50-es14.beam3-b64",
         "shufflenet-v124.greedy-b512"]


def _small_root(tmp, cell):
    shutil.copytree(REPO / "portbench", tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    wl_path = tmp / "portbench" / "workloads" / f"{cell}.json"
    wl = json.loads(wl_path.read_text())
    tr_path = tmp / "portbench" / "traffic" / f"{wl['traffic']}.json"
    tr = json.loads(tr_path.read_text())
    tr.update(batch=16, distinct_batches=2)
    tr_path.write_text(json.dumps(tr))
    wl.update(sample_from=2, sample_requests=2, warmup_requests=1)
    wl_path.write_text(json.dumps(wl))
    return tmp, wl["limits"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(tmp_path, capsys, cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from portbench import control, run
    root, limits = _small_root(tmp_path, cell)
    assert control.main(["--workload", cell, "--seeds", "101,102,103"], root=root) == 0
    for line in capsys.readouterr().out.strip().splitlines():
        got = json.loads(line)["control"]
        assert any(got[n] > lim for n, lim in limits.items()), got
    # the number meant to catch each fault; None: any (beam search's first
    # stage one rank low also breaks the lineage that scoring reads, and a
    # word of rank k+1 need not be served in a small batch)
    beam = "search" in limits
    faults = {"second_best": None if beam else "rank"}
    if beam:
        faults.update(second_stage="search", worst_hypothesis="search")
    for kind, number in faults.items():
        assert control.main(["--workload", cell, "--seeds", "105,106,107", "--kind",
                             kind], root=root) == 0
        for line in capsys.readouterr().out.strip().splitlines():
            got = json.loads(line)["control"]
            numbers = limits if number is None else [number]
            assert any(got[n] > limits[n] for n in numbers), (kind, got)
    assert run.main(["--workload", cell, "--seed", "104", "--seconds", "2",
                     "--trace", "0"], root=root) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
