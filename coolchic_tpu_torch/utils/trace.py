"""Spans and counters of the port's host work, off unless a caller collects
them.

    with trace.span("decode.prepare"): ...      # a span around a block
    @trace.spanned("decode.call", root=True)    # a span around each call
    if trace.on(): trace.count("decode.d2h_bytes", n)   # a counter
    with trace.collect() as rec: ...            # tracing on for the block
    rec.spans, rec.counters, rec.summary()

Off (the default), span() returns the one shared no-op context OFF and
count() returns at once: one test of a global each, no clock read and no
allocation. On, a span records (name, start_ns, end_ns, parent, call) on
time.perf_counter_ns; parent is the index of the enclosing span in
rec.spans (-1 at the top) and call the call id: a span opened with
root=True (one decode call, one training step) starts a new one, the spans
under it take its id, spans under no root take 0. While a torch.profiler session records, an open
span also opens record_function("coolchic." + name), so that the span lies
in the profiler's trace, on its clock, beside the kernels and runtime
calls it issued. A span never synchronises the card: it measures the
host's time; the card's comes from the profiler.

Spans nest by the order in which one thread opens and closes them; the
port opens them on the caller's thread only.
"""

from __future__ import annotations

import functools
import time
from contextlib import contextmanager

import torch

PROFILER_PREFIX = "coolchic."

_rec: "Records | None" = None


class _Off:
    """The shared no-op context of a span while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()


class Records:
    """What one collect() block recorded: spans [name, start_ns, end_ns,
    parent, call] in the order they opened, and counters by name."""

    def __init__(self):
        self.spans: list[list] = []
        self.counters: dict[str, int] = {}
        self._open: list[int] = []
        self._calls = 0

    def summary(self) -> dict[str, dict]:
        """By span name: count, total_ns and self_ns (the durations less
        what each span's children cover)."""
        child_ns = [0] * len(self.spans)
        for name, t0, t1, parent, _ in self.spans:
            if parent >= 0 and t1 is not None:
                child_ns[parent] += t1 - t0
        out: dict[str, dict] = {}
        for (name, t0, t1, _, _), inner in zip(self.spans, child_ns):
            if t1 is None:
                continue
            s = out.setdefault(name, {"count": 0, "total_ns": 0, "self_ns": 0})
            s["count"] += 1
            s["total_ns"] += t1 - t0
            s["self_ns"] += t1 - t0 - inner
        return out


class _Span:
    __slots__ = ("rec", "i", "rf")

    def __init__(self, rec: Records, name: str, root: bool):
        self.rec = rec
        parent = rec._open[-1] if rec._open else -1
        if root:
            rec._calls += 1
            call = rec._calls
        else:
            call = rec.spans[parent][4] if parent >= 0 else 0
        self.i = len(rec.spans)
        rec.spans.append([name, None, None, parent, call])
        # torch has no public test for a recording session, and a
        # record_function outside one still costs ~10 us
        self.rf = (torch.profiler.record_function(PROFILER_PREFIX + name)
                   if torch.autograd.profiler._is_profiler_enabled else None)

    def __enter__(self):
        if self.rf is not None:
            self.rf.__enter__()
        self.rec._open.append(self.i)
        self.rec.spans[self.i][1] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.rec.spans[self.i][2] = time.perf_counter_ns()
        self.rec._open.pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def on() -> bool:
    """Whether tracing is on: a caller tests it before it computes a count."""
    return _rec is not None


def span(name: str, root: bool = False):
    """A span named `name` around a `with` block (OFF while tracing is off);
    root=True starts a new call id."""
    if _rec is None:
        return OFF
    return _Span(_rec, name, root)


def spanned(name: str, root: bool = False):
    """Decorator: each call of the function in a span named `name`."""

    def wrap(fn):
        @functools.wraps(fn)
        def traced(*args, **kwargs):
            if _rec is None:
                return fn(*args, **kwargs)
            with _Span(_rec, name, root):
                return fn(*args, **kwargs)

        return traced

    return wrap


def count(name: str, n: int) -> None:
    """Add n to the counter `name` (nothing while tracing is off)."""
    if _rec is not None:
        _rec.counters[name] = _rec.counters.get(name, 0) + n


@contextmanager
def collect():
    """Tracing on for the block; yields its Records (kept in memory only)."""
    global _rec
    saved, _rec = _rec, Records()
    try:
        yield _rec
    finally:
        _rec = saved
