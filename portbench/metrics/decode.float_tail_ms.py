"""Device ms a decode call of the float tail (upsampling, synthesis, the
final resize): the kernels launched in the program's span
`decode.float_tail` (portbench/spans.py's device pass)."""

from portbench.spans import reading


def read(t: dict):
    return reading(t, "decode", lambda m: m["device"]["kernel_ms"].get("decode.float_tail"))
