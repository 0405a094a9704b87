"""Host ms a decode call in the host's range decode of the grids that the
wavefront kernel does not take: the program's span
`decode.prepare.host_levels`, tracing on (portbench/spans.py's program
pass)."""

from portbench.spans import reading

SPAN = "decode.prepare.host_levels"


def read(t: dict):
    return reading(t, "decode", lambda m: m["host"]["host_ms"].get(SPAN))
