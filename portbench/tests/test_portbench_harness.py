"""The harness on the CPU at a tiny size: what it finds by name, the result
line of each driver, the control's run, and the faults the comparison has
to catch."""

from __future__ import annotations

import json

import pytest
import torch

from portbench_fixtures import REPO, run_tiny, tiny_root

KEYS = ("correct", "attempted", "failed", "metrics", "device")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("decode", ["beam", "greedy"])
@pytest.mark.parametrize("trace", [0, 1])
def test_driver_prints_one_result_line(tmp_path, capsys, decode, trace):
    rc, out = run_tiny(tmp_path, capsys, decode, trace)
    assert rc == 0
    assert all(k in out for k in KEYS) and list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert out["device"]["platform"] == "cpu" and out["device"]["count"] == 1
    assert set(out["checks"]) == ({"annot", "score", "alpha", "rank"}
                                  | ({"search"} if decode == "beam" else set()))
    for c in out["checks"].values():
        assert c["value"] <= c["limit"]
    if trace:
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "window_s" in out["device"] and "busy_s" in out["device"]
        if decode == "greedy":
            assert out["metrics"]["caption_batch_p95_ms.greedy"]["value"] > 0
    else:
        assert {"caption_images_per_s", "setup_s"} <= set(out["metrics"])
        for m in out["metrics"].values():
            assert m["value"] > 0


def test_new_cell_config_and_metric_are_only_files(tmp_path, capsys):
    """A configuration, a cell and a per-layer metric that exist only as new
    files (and entries in BENCHMARK.json) are found and run."""
    root = tiny_root(tmp_path, "beam")
    (root / "portbench" / "metrics" / "requests_done.py").write_text(
        "def read(rec, ctx):\n    return float(rec['requests'])\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "requests_done", "unit": "requests",
                               "better": "higher", "source": "program_counter",
                               "layer": "decode driver", "moves": "caption_images_per_s",
                               "workloads": ["tiny.beam"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    from portbench import run
    assert not (REPO / "portbench" / "configs" / "tiny.json").exists()
    rc = run.main(["--workload", "tiny.beam", "--seed", "11", "--seconds", "0.3",
                   "--trace", "1"], root=root, device="cpu")
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["metrics"]["requests_done"]["value"] == out["attempted"]


def test_benchmark_names_a_reader_for_every_metric_and_cells_report_what_they_move():
    """Every metric has its reader; every cell reports setup_s, another
    end-to-end metric and a per-layer one; a per-layer metric's cells report
    the end-to-end metric it moves."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    metrics = REPO / "portbench" / "metrics"
    cells = [w["name"] for w in bench["workloads"]]

    def cells_of(m):
        return m.get("workloads", cells)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (metrics / f"{m['name']}.py").is_file(), m["name"]
        assert set(cells_of(m)) <= set(cells), m["name"]
    e2e = {m["name"]: set(cells_of(m)) for m in bench["end_to_end"]}
    for c in cells:
        assert c in e2e["setup_s"]
        assert any(c in ws for n, ws in e2e.items() if n != "setup_s"), c
        assert any(c in cells_of(m) for m in bench["per_layer"]), c
    for m in bench["per_layer"]:
        assert set(cells_of(m)) <= e2e[m["moves"]], m["name"]


def test_control_runs_on_the_cpu(tmp_path, capsys):
    """The control's readings on the CPU (no TF32 there: it reads as the
    reference does); on the card it must fail (test_portbench_cuda.py)."""
    from portbench import control
    root = tiny_root(tmp_path, "greedy")
    assert control.main(["--workload", "tiny.greedy", "--seeds", "3,4"], root=root,
                        device="cpu") == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert [x["seed"] for x in lines] == [3, 4]
    assert set(lines[0]["control"]) >= {"annot", "score", "alpha"}


def _unchanged_state(monkeypatch):
    import sat_tpu_torch.decode.beam as beam
    import sat_tpu_torch.models.decoder as dec
    same = lambda x, h, c, layers: (h, c)
    monkeypatch.setattr(beam, "lstm_stack_step", same)
    monkeypatch.setattr(dec, "lstm_stack_step", same)


def _half_batch(monkeypatch):
    """Half of each batch decoded, its answers given to the other half."""
    import sat_tpu_torch.decode.api as api
    import sat_tpu_torch.decode.beam as beam

    def halved(fn):
        def wrapped(params, cfg, annotations, **kw):
            res = fn(params, cfg, annotations[: annotations.shape[0] // 2], **kw)
            return type(res)(*(torch.cat([x, x]) for x in res))
        return wrapped
    monkeypatch.setattr(api, "beam_search", halved(api.beam_search))
    monkeypatch.setattr(beam, "greedy_decode", halved(beam.greedy_decode))


def _altered_token(monkeypatch):
    """The first row's token moved to the next word where it is chosen."""
    import sat_tpu_torch.decode.beam as beam
    import sat_tpu_torch.kernels.greedy_loop as gl
    topk, select = beam.topk_small, gl.scan_select

    def topk_altered(x, k):
        vals, idx = topk(x, k)
        if x.shape[-1] > 2 * k:
            idx = idx.clone()
            idx[0] = (idx[0] + 1) % x.shape[-1]
        return vals, idx

    def select_altered(logits, temperature, masked):
        tok, lp = select(logits, temperature, masked)
        tok = tok.clone()
        tok[0] = (tok[0] + 1) % logits.shape[-1]
        return tok, lp
    monkeypatch.setattr(beam, "topk_small", topk_altered)
    monkeypatch.setattr(gl, "scan_select", select_altered)


def _second_best(monkeypatch):
    """Each step's selection one rank low, with the chosen words' own
    log-probabilities: greedy takes the second best word, beam search each
    slot's words of ranks 2 .. k+1.  Scores and maps agree with the tokens."""
    import sat_tpu_torch.decode.beam as beam
    import sat_tpu_torch.kernels.greedy_loop as gl
    topk = beam.topk_small

    def topk_low(x, k):
        if x.shape[-1] <= k * k:        # the second stage, over the k k union
            return topk(x, k)
        vals, idx = topk(x, k + 1)
        return vals[..., 1:], idx[..., 1:]

    def select_low(logits, temperature, masked):
        scaled = logits.float() / temperature
        tok = torch.topk(scaled + torch.where(masked, gl.NEG_INF, 0.0), 2,
                         dim=-1).indices[:, 1]
        return tok, (scaled.gather(1, tok[:, None])[:, 0]
                     - torch.logsumexp(scaled, dim=-1))
    monkeypatch.setattr(beam, "topk_small", topk_low)
    monkeypatch.setattr(gl, "scan_select", select_low)


@pytest.mark.parametrize("decode", ["beam", "greedy"])
@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch, _altered_token,
                                   _second_best],
                         ids=["state_unchanged", "half_batch", "token_altered",
                              "second_best"])
def test_fault_makes_the_run_incorrect(tmp_path, capsys, monkeypatch, decode, fault):
    """The run with the timed path broken underneath reports correct false
    (the exchange between chips has no fault to plant: every cell takes one
    chip)."""
    fault(monkeypatch)
    rc, out = run_tiny(tmp_path, capsys, decode)
    assert rc == 0 and out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def test_second_best_greedy_is_caught_by_rank_alone(tmp_path, capsys, monkeypatch):
    """A consistent selection fault keeps the served scores and maps true to
    the served tokens: only the rank check sees that the tokens are wrong."""
    _second_best(monkeypatch)
    rc, out = run_tiny(tmp_path, capsys, "greedy")
    checks = out["checks"]
    assert rc == 0 and out["correct"] is False
    assert checks["rank"]["value"] > checks["rank"]["limit"]
    assert all(checks[n]["value"] <= checks[n]["limit"] for n in ("annot", "score", "alpha"))


@pytest.mark.parametrize("trace", [0, 1])
def test_host_paced_metrics_read_as_their_originals(tmp_path, capsys, trace):
    """A cell listed under the ``.host_paced`` metrics reports them, read by
    the same readers as the originals."""
    from portbench import run
    root = tiny_root(tmp_path, "beam")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    paced = [m for m in bench["end_to_end"] + bench["per_layer"]
             if m["name"].endswith("host_paced")]
    for m in paced:
        m["workloads"].append("tiny.beam")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    rc = run.main(["--workload", "tiny.beam", "--seed", "12", "--seconds", "0.3",
                   "--trace", str(trace)], root=root, device="cpu")
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    # on the CPU no operation runs on a device: the device readers find nothing
    want = {"caption_images_per_s.host_paced"} if not trace else {
        "caption_batch_p95_ms.host_paced", "device_idle_share.host_paced"}
    assert want <= set(out["metrics"]), out["metrics"]
    for n in want:
        assert out["metrics"][n]["value"] > 0


def _second_stage(monkeypatch):
    """Beam search keeps the union's candidates of ranks 2 .. k+1 after step
    0 (where only slot 0's k words are valid)."""
    import sat_tpu_torch.decode.beam as beam
    topk = beam.topk_small

    def topk_kept_low(x, k):
        if x.shape[-1] == k * k:
            vals, idx = topk(x, k + 1)
            if bool((vals[..., k] > beam.NEG_INF / 2).all()):
                return vals[..., 1:], idx[..., 1:]
        return topk(x, k)
    monkeypatch.setattr(beam, "topk_small", topk_kept_low)


def _worst_hypothesis(monkeypatch):
    """Each image served its worst hypothesis, with that hypothesis's own
    caption, score and maps."""
    import sat_tpu_torch.decode.api as api
    unpack = api.unpack_beam_result

    def worst(res, grid_hw, return_all=False):
        caps, scores, alphas, ppl = unpack(res, grid_hw, True)
        return ([c[-1] for c in caps], [x[-1] for x in scores],
                [a[-1] for a in alphas], [p[-1] for p in ppl])
    monkeypatch.setattr(api, "unpack_beam_result", worst)


@pytest.mark.parametrize("fault", [_second_stage, _worst_hypothesis],
                         ids=["second_stage", "worst_hypothesis"])
def test_beam_search_fault_is_caught_by_search_alone(tmp_path, capsys, monkeypatch,
                                                     fault):
    """A search that keeps the wrong candidates or serves the wrong
    hypothesis, each word among its row's k best and each score true to its
    caption: only the comparison with the reference's own search sees it."""
    fault(monkeypatch)
    rc, out = run_tiny(tmp_path, capsys, "beam")
    checks = out["checks"]
    assert rc == 0 and out["correct"] is False
    assert checks["search"]["value"] > checks["search"]["limit"]
    assert all(checks[n]["value"] <= checks[n]["limit"]
               for n in ("annot", "score", "alpha", "rank"))
