"""Host ms a training step in SOAP's per-leaf updates, the eigenbasis
refresh included: the program's span `train.soap`, tracing on
(portbench/spans.py's program pass)."""

from portbench.spans import reading


def read(t: dict):
    return reading(t, "train", lambda m: m["host"]["host_ms"].get("train.soap"))
