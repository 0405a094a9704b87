"""The program's own spans and counters (coolchic_tpu_torch/utils/trace.py),
for the per-layer metrics that read them.

A traced run (--trace 1) times the cell's work three ways in the kind
(portbench/kinds/): by the host clock, with the card's activity traced,
and with the benchmark's spans around the program; the program's tracing
is off in all three. The metric readers then ask this module, once per
process, for two more passes over the same work, with the program's
tracing on:

  - the device pass: span_calls decode calls, or trace_steps training
    steps (a whole refresh period), under torch.profiler with the host's
    operators, so that the program's `coolchic.*` ranges lie in the trace.
    Each kernel and copy goes to the innermost program span open at its
    launch (the runtime call's time, matched through the correlation id:
    by time, not thread, as autograd launches the backward from its own
    thread while `train.backward` is open on the caller's), and each idle
    gap of the card to the innermost span open, the benchmark's or the
    program's. The gaps go into the run's breakdown as `program_idle_gaps`.
  - the program pass: the kind's trace_calls untraced calls again, the
    same files in the same order, or trace_steps steps, with no profiler,
    four times: tracing off, on, on, off. It gives the host's ms by span
    (total and self) and the counters, per decode call or step, from the
    two blocks on, and one standard-error line of tracing's cost: a block
    on against a block off and against the kind's untraced pass, and the
    spans a call times the cost of one span site, off and on.

The cell and the seed are the run's own (run.py's --workload and --seed on
the command line). A program without the trace module, or a run without a
card, gives no reading: the readers return None.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

import torch

from portbench import harness, inputs, yardstick
from portbench.yardstick import DEVICE_CATS, _union

PROGRAM = "coolchic."
BENCH = "portbench."
NO_SPAN = "no benchmark span"        # yardstick.reduce_trace's name for an unnamed gap
NO_PROGRAM_SPAN = "no program span"
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")

_passes: dict = {}


# ------------------------------------------------------------ reduction
def _ranges(xs: list[dict], prefixes: tuple[str, ...], skip: str = "") -> list[tuple]:
    """(start, end, name) of the user annotations named with a prefix, in
    trace order."""
    return [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in xs
            if e.get("cat") == "user_annotation" and e["name"].startswith(prefixes)
            and e["name"] != skip]


def _innermost(ranges: list[tuple], t: float) -> str | None:
    """The name of the shortest range that holds t (the first of equals)."""
    open_ = [r for r in ranges if r[0] <= t <= r[1]]
    return min(open_, key=lambda r: r[1] - r[0])[2] if open_ else None


def by_program_span(events: list[dict]) -> dict:
    """Each kernel and copy of a chrome trace put down to the innermost
    program span open at its launch: kernel seconds, copy seconds by copy
    name, and kernel launches, by span name (the prefix dropped)."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    program = [(a, b, n[len(PROGRAM):]) for a, b, n in _ranges(xs, (PROGRAM,))]
    launched = {e["args"]["correlation"]: e["ts"] for e in xs
                if e.get("cat") in RUNTIME_CATS and "correlation" in e.get("args", {})}
    kernel_s: dict[str, float] = {}
    memcpy_s: dict[str, dict[str, float]] = {}
    launches: dict[str, int] = {}
    for e in xs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        t = launched.get(e.get("args", {}).get("correlation"))
        name = (_innermost(program, t) if t is not None else None) or NO_PROGRAM_SPAN
        if e["cat"] == "kernel":
            kernel_s[name] = kernel_s.get(name, 0.0) + e["dur"] * 1e-6
            launches[name] = launches.get(name, 0) + 1
        elif e["cat"] == "gpu_memcpy":
            d = memcpy_s.setdefault(name, {})
            d[e["name"]] = d.get(e["name"], 0.0) + e["dur"] * 1e-6
    return {"kernel_s": kernel_s, "memcpy_s": memcpy_s, "launches": launches}


def idle_gaps(events: list[dict], window_span: str = BENCH + "window") -> list:
    """The card's idle gaps inside the window span, each named by the
    innermost span open at its middle, the benchmark's or the program's:
    the ten largest, [[name, seconds], ...], as yardstick.reduce_trace
    gives them (the same gaps and, for a trace with the benchmark's spans
    alone, the same names)."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in xs if e.get("name") == window_span and e.get("cat") == "user_annotation"]
    if not win:
        return []
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    spans = _ranges(xs, (BENCH, PROGRAM), skip=window_span)
    dev = []
    for e in xs:
        if e.get("cat") in DEVICE_CATS:
            a, b = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
            if b > a:
                dev.append((a, b))
    gaps, t = [], w0
    for a, b in _union(dev) + [(w1, w1)]:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    idle_by: dict[str, float] = {}
    for a, b in gaps:
        name = _innermost(spans, 0.5 * (a + b)) or NO_SPAN
        idle_by[name] = idle_by.get(name, 0.0) + (b - a) * 1e-6
    return [[k[:200], v] for k, v in sorted(idle_by.items(), key=lambda kv: -kv[1])[:10]]


# ---------------------------------------------------------------- passes
def _sync(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _profiled(device: str, work) -> list[dict]:
    """The chrome trace's events of `work` under torch.profiler (the host's
    operators and the card's), inside the window span."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(BENCH + "window"):
            _sync(device)
            work()
            _sync(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


def _per_root(recs: list, root: str) -> dict:
    """Host ms by span (total, self) and counters, per root span, over the
    records of several collect() blocks."""
    total: dict[str, dict] = {}
    counters: dict[str, int] = {}
    for rec in recs:
        for name, s in rec.summary().items():
            t = total.setdefault(name, {"count": 0, "total_ns": 0, "self_ns": 0})
            for k in t:
                t[k] += s[k]
        for k, v in rec.counters.items():
            counters[k] = counters.get(k, 0) + v
    n = total.get(root, {}).get("count", 0)
    if not n:
        return {"roots": 0, "host_ms": {}, "self_ms": {}, "counters": {}}
    return {"roots": n,
            "host_ms": {k: 1e-6 * v["total_ns"] / n for k, v in total.items()},
            "self_ms": {k: 1e-6 * v["self_ns"] / n for k, v in total.items()},
            "counters": {k: v / n for k, v in counters.items()}}


def _device_readings(events: list[dict], rec, root: str) -> dict:
    n = rec.summary().get(root, {}).get("count", 0)
    by = by_program_span(events) if n else {"kernel_s": {}, "memcpy_s": {}, "launches": {}}
    return {"roots": n,
            "kernel_ms": {k: 1e3 * v / n for k, v in by["kernel_s"].items()},
            "memcpy_ms": {k: {c: 1e3 * s / n for c, s in d.items()}
                          for k, d in by["memcpy_s"].items()},
            "launches": {k: v / n for k, v in by["launches"].items()},
            "counters": {k: v / n for k, v in rec.counters.items()} if n else {},
            "idle_gaps": idle_gaps(events)}


def _off_on(work) -> tuple[list, float, float]:
    """work() four times, the program's tracing off, on, on, off (a drift of
    the host cancels to first order): the traced blocks' records, and the
    seconds of a block on and off."""
    from coolchic_tpu_torch.utils import trace

    recs, secs = [], {False: 0.0, True: 0.0}
    for on in (False, True, True, False):
        t0 = time.perf_counter()
        if on:
            with trace.collect() as rec:
                work()
            recs.append(rec)
        else:
            work()
        secs[on] += time.perf_counter() - t0
    return recs, secs[True] / 2, secs[False] / 2


def _span_ns(n: int = 100_000) -> tuple[float, float]:
    """ns of one span site, off and on (an empty block, the loop included)."""
    from coolchic_tpu_torch.utils import trace

    out = []
    for on in (False, True):
        with trace.collect() if on else contextlib.nullcontext():
            t0 = time.perf_counter_ns()
            for _ in range(n):
                with trace.span("x"):
                    pass
            out.append((time.perf_counter_ns() - t0) / n)
    return out[0], out[1]


def _on_cost(unit: str, recs: list, n: int, on_s: float, off_s: float, clock_s: float) -> None:
    """One standard-error line: tracing's cost, measured (a block on against
    a block off, and against the kind's untraced pass) and counted (spans
    a call or step times the cost of a span site)."""
    per = sum(len(r.spans) for r in recs) / (len(recs) * n)
    off_ns, on_ns = _span_ns()
    print(f"portbench: program tracing on: {on_s:.4f} s over {n} {unit} against {off_s:.4f} s "
          f"off ({100 * (on_s / off_s - 1):+.2f} %; blocks off, on, on, off) and {clock_s:.4f} s "
          f"in the untraced pass ({100 * (on_s / clock_s - 1):+.2f} %); counted: {per:.1f} "
          f"spans a {unit[:-1]}, a site {off_ns:.0f} ns off and {on_ns:.0f} ns on: "
          f"{100 * per * off_ns * 1e-9 * n / off_s:.4f} % off, "
          f"{100 * per * on_ns * 1e-9 * n / off_s:.4f} % on", file=sys.stderr)


def decode_pass(paths: list[str], spec: dict, seed: int, device: str, clock_s: float) -> dict:
    """The device and program passes of a decode cell over the pool `paths`."""
    from coolchic_tpu_torch.bitstream.decode import decode_images
    from coolchic_tpu_torch.utils import trace

    from portbench.kinds.decode import call_files

    calls = call_files(paths, spec["batch"], seed + 2)
    with trace.collect() as rec:
        events = _profiled(device, lambda: [decode_images(next(calls), device=device)
                                            for _ in range(spec["span_calls"])])
    out = {"device": _device_readings(events, rec, "decode.call")}

    # the untraced pass's calls again: the kind's first trace_calls calls of
    # the seed, the same files in the same order
    calls = call_files(paths, spec["batch"], seed)
    files = [next(calls) for _ in range(spec["trace_calls"])]
    recs, on_s, off_s = _off_on(lambda: [decode_images(f, device=device) for f in files])
    _on_cost("calls", recs, len(files), on_s, off_s, clock_s)
    out["host"] = _per_root(recs, "decode.call")
    return out


def train_pass(run: harness.Run, clock_s: float) -> dict:
    """The device and program passes of a training cell, from a state set
    up as the kind sets up its own."""
    from coolchic_tpu_torch.parallel.batch import window_chunks
    from coolchic_tpu_torch.train.params import tree_unflatten
    from coolchic_tpu_torch.train.train import (PhaseFns, cosine_lr, init_opt_state,
                                                linear_schedule, seed_opt_state)
    from coolchic_tpu_torch.utils import trace

    from portbench.kinds.train import SeedNoise, make_inputs

    dev, G, n = run.device, run.spec["batch"], run.spec["trace_steps"]
    x = make_inputs(run)
    phase, fcfg = x["phase"], x["fcfg"]
    leaves = [x["init"][p].clone() for p in x["paths"]]
    fns = PhaseFns(fcfg, tree_unflatten(x["shapes_tree"], leaves),
                   phase["quantizer_noise_type"], phase["quantizer_type"], {"mse": 1.0},
                   tuple(phase["betas_model"]), tuple(phase["betas_latent"]),
                   phase["precondition_frequency"])
    noise = SeedNoise(run.seed + 2, dev, keep=0)
    level = torch.full((G,), linear_schedule(phase["noise_parameter"], 0, phase["max_itr"]),
                       dtype=torch.float32, device=dev)

    def draw():
        return noise("step", fcfg, G, phase["quantizer_noise_type"], level, fns.need_noise)

    temp = linear_schedule(phase["softround_temperature"], 0, phase["max_itr"])
    lr = torch.tensor(cosine_lr(phase["lr"], 0, phase["max_itr"] / phase["freq_valid"]),
                      dtype=torch.float32, device=dev)
    opt = init_opt_state(leaves, fns.groups, fns.hp_weight, fns.hp_latent)
    opt = seed_opt_state(opt, fns.grads(leaves, draw(), temp, x["target"], x["lmbda"]),
                         fns.groups, fns.hp_weight)
    state = [(leaves, opt)]

    def steps(k: int) -> None:
        state[:] = window_chunks([fns], state, [draw], k, temp, [lr], [x["target"]],
                                 [x["lmbda"]], [None])
        _sync(dev)

    steps(fns.pf)                                   # the new state's first steps
    with trace.collect() as rec:
        events = _profiled(dev, lambda: steps(n))
    out = {"device": _device_readings(events, rec, "train.step")}
    recs, on_s, off_s = _off_on(lambda: steps(n))
    _on_cost("steps", recs, n, on_s, off_s, clock_s)
    out["host"] = _per_root(recs, "train.step")
    return out


def _run_args() -> tuple[str | None, int | None]:
    """The run's --workload and --seed, as run.py's command line gives them."""
    ap = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    args, _ = ap.parse_known_args(sys.argv[1:])
    return args.workload, args.seed


def passes(t: dict) -> dict | None:
    """The device and program passes of this run's cell (made once per
    process), or None: no card ran, no cell on the command line, or a
    program without the trace module."""
    if t.get("busy_s", 0) <= 0 or not torch.cuda.is_available():
        return None
    name, seed = _run_args()
    if name is None or seed is None:
        return None
    if (name, seed) not in _passes:
        try:
            import coolchic_tpu_torch.utils.trace  # noqa: F401
        except ImportError:
            print("portbench: the program has no spans (coolchic_tpu_torch.utils.trace)",
                  file=sys.stderr)
            _passes[(name, seed)] = None
            return None
        spec = json.loads((harness.PB / "workloads" / f"{name}.json").read_text())
        if t["kind"] == "decode":
            out = decode_pass([str(inputs.DATA / p) for p in inputs.pool(spec["pool"])], spec,
                              seed, "cuda:0", t["clock_s"])
        else:
            config = yardstick.load_config(harness.cell_entry(harness.benchmark(), name)["config"])
            out = train_pass(harness.Run(spec=spec, config=config, seed=seed, seconds=0.0,
                                         trace=True, device="cuda:0"), t["clock_s"])
        t["breakdown"]["program_idle_gaps"] = out["device"]["idle_gaps"]
        print("portbench: program spans, host ms per "
              f"{'call' if t['kind'] == 'decode' else 'step'} (total / self): "
              + ", ".join(f"{k} {v:.3f} / {out['host']['self_ms'][k]:.3f}"
                          for k, v in out["host"]["host_ms"].items()), file=sys.stderr)
        print("portbench: program spans, device: kernel ms "
              f"{json.dumps(out['device']['kernel_ms'])}; copy ms "
              f"{json.dumps(out['device']['memcpy_ms'])}; launches "
              f"{json.dumps(out['device']['launches'])}", file=sys.stderr)
        _passes[(name, seed)] = out
    return _passes[(name, seed)]


def reading(t: dict, kind: str, read) -> float | None:
    """read(passes) for a traced context of `kind`; None otherwise, or where
    the program gave nothing to read."""
    if t.get("kind") != kind:
        return None
    out = passes(t)
    return None if not out else read(out)
