"""Host ms a decode call in prepare_batch, all of it (headers, the NN
decode, the host levels, uploads, the float tail's modules): the program's
span `decode.prepare`, tracing on (portbench/spans.py's program pass)."""

from portbench.spans import reading


def read(t: dict):
    return reading(t, "decode", lambda m: m["host"]["host_ms"].get("decode.prepare"))
