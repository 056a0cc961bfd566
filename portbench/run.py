"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Everything is found by name: the cell in
``BENCHMARK.json``'s ``workloads``, its file ``portbench/workloads/<cell>.json``
(driver, warm-up, sampling, trace and the limits of its comparison), its
configuration ``portbench/configs/<config>.json``, its traffic
``portbench/traffic/<traffic>.json``, its driver
``portbench/drivers/<driver>.py`` and each metric's reader
``portbench/metrics/<metric>.py``.  With ``--trace 0`` the metrics are the
cell's end-to-end ones, with ``--trace 1`` its per-layer ones.

The run needs as many CUDA cards as the cell asks for, and exits 3 with no
result where there are fewer.  It turns TF32 off before anything is built,
keeps every build cache inside the checkout, and exits 4 with no result if
JAX, flax or the JAX package was loaded.  The last line of standard output
is one JSON object; the last lines of standard error give each compared
number beside its limit."""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "sat_tpu")
ROOT = Path(__file__).resolve().parent.parent


def process_start() -> float:
    """The process's start on the ``perf_counter`` clock (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.perf_counter() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


T_PROCESS = process_start()


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def applies(entry: Dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def find_cell(root: Path, name: str) -> SimpleNamespace:
    """The cell ``name`` and everything it names, from files under ``root``."""
    bench = load_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    pb = root / "portbench"
    cell = load_json(pb / "workloads" / f"{name}.json")
    if (cell["config"], cell["traffic"]) != (entry["config"], entry["traffic"]):
        raise SystemExit(f"{name}: the cell's file names another config or traffic")
    return SimpleNamespace(
        entry=entry, cell=cell, config=load_json(root / conf["file"]),
        traffic=load_json(pb / "traffic" / f"{entry['traffic']}.json"),
        driver=pb / "drivers" / f"{cell['driver']}.py",
        end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if applies(m, name)],
        metrics_dir=pb / "metrics")


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card(chips: int):
    """The CUDA device, or None with the reason on stderr."""
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"the cell needs {chips} CUDA card(s); this machine has {n}",
              file=sys.stderr)
        return None
    return torch.device("cuda", 0)


def cache_env(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    base = root / ".portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")


def main(argv: Optional[List[str]] = None, *, root: Path = ROOT,
         device: Optional[str] = None) -> int:
    """One run.  ``device`` is for tests: "cpu" skips the look for a card."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env(root)
    found = find_cell(root, args.workload)
    import torch
    log = lambda msg: print(f"[portbench] {msg}", file=sys.stderr, flush=True)
    log(f"set-up: {time.perf_counter() - T_PROCESS:.2f} s to torch's import")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)        # one host thread: the runs' host work steadier
    if device is None:
        dev = card(found.entry["chips"])
        if dev is None:
            return 3
    else:
        dev = torch.device(device)
    ctx = SimpleNamespace(config=found.config, traffic=found.traffic, cell=found.cell,
                          seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                          device=dev, t_process=T_PROCESS, log=log)
    sys.path.insert(0, str(root))
    driver = load_module(found.driver, f"portbench.drivers.{found.cell['driver']}")
    rec = driver.run(ctx)
    bad = forbidden_modules()
    if bad:
        print(f"modules loaded that the benchmark may not load: {bad}", file=sys.stderr)
        return 4
    wanted = found.per_layer if args.trace else found.end_to_end
    metrics = {}
    for m in wanted:
        reader = load_module(found.metrics_dir / f"{m['name']}.py",
                             "portbench.metrics." + m["name"].replace(".", "_"))
        v = reader.read(rec, ctx)
        if v is not None and math.isfinite(v):
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    limits = found.cell["limits"]
    for n, v in rec["checks"].items():
        if n not in limits:
            log(f"reading {n}: {v!r} (not compared: its control reads alike)")
    checks = {n: {"value": rec["checks"][n], "limit": limits[n]} for n in limits}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    out = {"correct": correct, "attempted": rec["requests"], "failed": 0,
           "metrics": metrics, "device": device_block(dev, rec, found.entry["chips"])}
    if args.trace:
        out["breakdown"] = breakdown(rec)
    out["checks"] = checks
    for n, c in checks.items():
        log(f"check {n}: {c['value']!r} against the limit {c['limit']!r}"
            f" ({'ok' if c['value'] <= c['limit'] else 'FAILED'})")
    print(json.dumps(out), flush=True)
    return 0


def device_block(dev, rec: Dict, chips: int) -> Dict:
    import torch
    from portbench.common import readers as R
    block = {"platform": "gpu" if dev.type == "cuda" else dev.type,
             "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
             "count": chips, "memory_peak_bytes": rec["memory_peak_bytes"]}
    if "ops" in rec:
        block["busy_s"] = R.busy_s(rec)
        block["window_s"] = R.window_s(rec)
    return block


def breakdown(rec: Dict) -> Dict:
    from portbench.common import profwin
    from portbench.common import readers as R
    w = R.window(rec)
    if w is None:
        return {"device_ops": [], "idle_gaps": []}
    ops = R.clipped(rec)
    return {"device_ops": profwin.top_ops(ops),
            "idle_gaps": profwin.idle_gaps(ops, rec["spans"], *w)}


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
