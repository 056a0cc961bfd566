"""The yardstick: operation and byte counts against chip_smoke.py's and the
published ones, and the end-to-end readers' arithmetic (all work over all
time; a tail over every request)."""

from __future__ import annotations

import importlib.util
from types import SimpleNamespace

import pytest

from portbench_fixtures import REPO

from portbench.common import flops as F
from portbench.common import readers as R
from portbench.common import profwin


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("L,D", [(49, 1024), (196, 2048), (49, 576), (169, 512)])
def test_step_flops_are_chip_smokes(L, D):
    cs = _chip_smoke()
    assert F.step_flops(L, D, 128, 512, 256) == cs.step_flops(L, D, 128, 512, 256)
    assert F.bound(1e9, 1e12, "float32") == cs.bound(1e9, 1e12, "float32")


def test_n64_step_call_bound_matches_the_kernel_table():
    """PERF.md's kernel table: the n64 step at N = 192 is 1.81 GFLOP, bound
    by operations at 0.0270 ms."""
    ops, nbytes = F.step_call(192, 64, 49, 1024, 128, 512, 256)
    assert abs(ops / 1e9 - 1.81) < 0.005
    ms, which = F.bound(nbytes, ops, "float32")
    assert which == "operations" and abs(ms - 0.0270) < 0.0005


def test_encoder_flops():
    """resnet50 at 224 px is 4.1 G multiply-adds; shufflenet_v2_x0_5 41 M."""
    assert 8.0e9 < F.encoder_flops_per_image("resnet50", 224, 14) < 8.4e9
    assert 0.07e9 < F.encoder_flops_per_image("shufflenet_v2_x0_5", 224, None) < 0.1e9


def _reader(name):
    from portbench.run import load_module
    return load_module(REPO / "portbench" / "metrics" / f"{name}.py", "m_" + name)


def test_rate_is_all_work_over_all_time():
    rec = {"kind": "caption", "images": 3000, "window_s": 2.0,
           "latencies": [0.1] * 6}       # the window holds host time between requests
    assert _reader("caption_images_per_s").read(rec, None) == 1500.0


def test_p95_is_over_every_request_not_over_chunks():
    lat = [1.0] * 10 + [0.01] * 190      # 5 % slow, all in the first hundred
    rec = {"kind": "caption", "latencies": lat}
    assert _reader("caption_batch_p95_ms").read(rec, None) == pytest.approx(10.0)
    lat = [1.0] * 11 + [0.01] * 189      # one more slow request crosses the 95th
    assert _reader("caption_batch_p95_ms").read({"kind": "caption", "latencies": lat},
                                                None) == pytest.approx(1000.0)


def test_busy_is_the_union_of_intervals_in_the_window():
    op = lambda s, e, span="step": profwin.DeviceOp("k", s, e, span, True)
    rec = {"ops": [op(0, 50), op(40, 100), op(150, 400, "encoder"), op(900, 1000)],
           "spans": [profwin.HostSpan("request", 10, 300)], "traced_requests": 1}
    assert R.busy_s(rec) == pytest.approx((90 + 150) / 1e9)
    assert R.busy_s(rec, {"step"}) == pytest.approx(90 / 1e9)
    assert R.window_s(rec) == pytest.approx(290 / 1e9)
    ctx = SimpleNamespace()
    assert _reader("device_idle_share.caption").read(
        dict(rec, kind="caption"), ctx) == pytest.approx(100 * (1 - 240 / 290))
