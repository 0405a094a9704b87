"""Host ms a decode call in _finish_frame (rounding to the bit depth,
4:2:0): the program's span `decode.finish`, tracing on
(portbench/spans.py's program pass)."""

from portbench.spans import reading


def read(t: dict):
    return reading(t, "decode", lambda m: m["host"]["host_ms"].get("decode.finish"))
