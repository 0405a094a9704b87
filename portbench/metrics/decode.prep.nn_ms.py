"""Host ms a decode call in the exp-Golomb decode of the images' networks
and their ARM parameters: the program's span `decode.prepare.nn`, tracing
on (portbench/spans.py's program pass)."""

from portbench.spans import reading


def read(t: dict):
    return reading(t, "decode", lambda m: m["host"]["host_ms"].get("decode.prepare.nn"))
