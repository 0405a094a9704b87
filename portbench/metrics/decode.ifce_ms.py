"""Device ms a decode call of the IFCE context and its shear to the
kernel's layout, before each kernel level: the kernels launched in the
program's span `decode.ifce` (portbench/spans.py's device pass)."""

from portbench.spans import reading


def read(t: dict):
    return reading(t, "decode", lambda m: m["device"]["kernel_ms"].get("decode.ifce"))
