"""Host ms a training step in the gradient's forward and backward: the
program's span `train.grads`, tracing on (portbench/spans.py's program
pass)."""

from portbench.spans import reading


def read(t: dict):
    return reading(t, "train", lambda m: m["host"]["host_ms"].get("train.grads"))
