"""Device ms a decode call of the small-grid decode: the kernels launched
in the program's span `decode.small_grids`, around the decode of the grids
coded on fewer than 128 streams (portbench/spans.py's device pass). The
IFCE context of such a grid is launched in `decode.ifce` inside it, and is
decode.ifce_ms's."""

from portbench.spans import reading


def read(t: dict):
    return reading(t, "decode", lambda m: m["device"]["kernel_ms"].get("decode.small_grids"))
