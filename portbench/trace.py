"""The traced window: torch.profiler (CUPTI) over a fixed amount of work,
the benchmark's spans (record_function ranges named portbench.*) around
its calls into each layer, and the reduction of the trace."""

from __future__ import annotations

import os
import tempfile
import time
from contextlib import contextmanager
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from portbench import yardstick


def span(name: str):
    return record_function(f"portbench.{name}")


@contextmanager
def spans_around(targets: list[tuple[object, str, str]]):
    """Wrap obj.attr in a span named `name` for each (obj, attr, name),
    restored on exit: the benchmark's spans around the program's layers,
    without a change to the program."""
    saved = []
    for obj, attr, name in targets:
        orig = getattr(obj, attr)

        def wrapped(*a, _orig=orig, _name=name, **k):
            with span(_name):
                return _orig(*a, **k)

        saved.append((obj, attr, orig))
        setattr(obj, attr, wrapped)
    try:
        yield
    finally:
        for obj, attr, orig in reversed(saved):
            setattr(obj, attr, orig)


def warm_tracer(device: str, work) -> None:
    """Trace `work` in a session of each kind and drop the traces: the
    profiler's first session in a process starts CUPTI and meets every
    kernel for the first time, which a traced window must not pay (a part
    of set-up, in traced runs)."""
    with TracedWindow(device, host_ops=False):
        work()
    with TracedWindow(device):
        work()


class TracedWindow:
    """`with TracedWindow(device) as tw:` profiles the block; tw.ctx then
    holds busy_s and window_s (the traced range), wall_s (the host clock,
    the card synchronised), kernel_s by name, launches and the breakdown.
    host_ops=False records the card's activity alone: the host's ops are
    not timed (recording each costs the host about as much as dispatching
    it), so no span names the idle gaps and the window is the host clock's."""

    def __init__(self, device: str, host_ops: bool = True):
        self.device = torch.device(device)
        self.host_ops = host_ops
        self.ctx: dict = {}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        acts = [ProfilerActivity.CPU] if self.host_ops or self.device.type != "cuda" else []
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._rf = span("window")
        self._rf.__enter__()
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        window_s = time.perf_counter() - self._t0
        self._rf.__exit__(*exc)
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            self.ctx = yardstick.reduce_trace(Path(path))
        finally:
            os.unlink(path)
        self.ctx["wall_s"] = window_s
        # without the host's ops there is no traced range: the window is the
        # host clock's
        self.ctx["window_s"] = self.ctx.pop("trace_window_s") or window_s
        return False
