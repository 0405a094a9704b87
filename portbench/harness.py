"""One run of one cell: set-up, the measured window, the check of what the
window produced against the plain reference, and the result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to a cell, a configuration or a per-layer metric
is found by name: BENCHMARK.json's entry, portbench/workloads/<cell>.json
(its kind, sizes, draws and limits), portbench/configs/<config>.json and
portbench/metrics/<metric>.py. The kind (portbench/kinds/<kind>.py) drives
the program and returns the window's numbers, the traced window's context
and the compared numbers with their limits.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass
from pathlib import Path

from portbench import yardstick

PB = Path(__file__).resolve().parent
ROOT = PB.parent
# top-level module names that may not be loaded in a run: JAX and the JAX
# package (compared whole: coolchic_tpu_torch is the program under test)
FORBIDDEN = ("jax", "jaxlib", "flax", "coolchic_tpu")
NO_READING = 1e30


def process_age_s() -> float:
    """Seconds since this process started (Linux's /proc, 10 ms ticks)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules(names=None) -> list[str]:
    tops = {m.split(".", 1)[0] for m in (sys.modules if names is None else names)}
    return sorted(tops & set(FORBIDDEN))


@dataclass
class Run:
    """What a kind gets: the cell's workload file and configuration, the
    run's arguments; `setup_s` once the window starts."""
    spec: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    setup_s: float | None = None

    def window_starts(self) -> None:
        """Set-up ends here: the measured window starts."""
        self.setup_s = process_age_s()


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_entry(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json")


def reports(metric: dict, cell: str, bench: dict) -> bool:
    """Whether a metric of BENCHMARK.json belongs to this cell."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    moved = next((m for m in bench["end_to_end"] if m["name"] == metric.get("moves")), None)
    return moved is None or "workloads" not in moved or cell in moved["workloads"]


def load_reader(metric: str):
    """portbench/metrics/<metric>.py (metric names hold dots, so by path)."""
    path = PB / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str,
             spec_overrides: dict | None = None) -> dict:
    """Set-up, window and check of one cell; returns the result object
    (the last key, "checks", holds each compared number and its limit)."""
    bench = benchmark()
    cell = cell_entry(bench, name)
    spec = json.loads((PB / "workloads" / f"{name}.json").read_text())
    spec.update(spec_overrides or {})
    run = Run(spec=spec, config=yardstick.load_config(cell["config"]), seed=seed,
              seconds=seconds, trace=trace, device=device)
    kind = importlib.import_module(f"portbench.kinds.{spec['kind']}")
    out = kind.run(run)

    checks = out["checks"]
    for c in checks.values():
        # a reading that is no number (NaN, inf) stands past every limit,
        # and the result line stays valid JSON
        if not math.isfinite(c["value"]):
            c["value"] = NO_READING
    correct = out["failed"] == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    if trace:
        metrics = {}
        ctx = out["trace"]
        for m in bench["per_layer"]:
            if not reports(m, name, bench):
                continue
            value = load_reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {"setup_s": {"value": run.setup_s, "unit": "s"}}
        for m in bench["end_to_end"]:
            if m["name"] == "setup_s" or not reports(m, name, bench):
                continue
            # a quantity split by cells (train_img_steps_per_s.n1) reports
            # the kind's reading of the quantity
            q = m["name"] if m["name"] in out["e2e"] else m["name"].rsplit(".", 1)[0]
            if q in out["e2e"]:
                metrics[m["name"]] = {"value": out["e2e"][q], "unit": m["unit"]}
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": out["device"]}
    if trace:
        result["device"].update(busy_s=out["trace"]["busy_s"], window_s=out["trace"]["window_s"])
        result["breakdown"] = out["trace"]["breakdown"]
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    chips = cell_entry(benchmark(), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"portbench: card {yardstick.card_line()}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", file=sys.stderr, flush=True)
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0")

    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}: no result", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
