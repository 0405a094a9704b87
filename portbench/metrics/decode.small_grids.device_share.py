"""Share of a decode call's grids that the program's small-grid decode
took on the card: its counters `decode.small_grids.device` (grids sent to
the small-grid kernel) over that plus `decode.small_grids.host` (grids
left to the host's range decode), tracing on (portbench/spans.py's
program pass)."""

from portbench.spans import reading


def _share(m: dict):
    c = m["host"]["counters"]
    if "decode.small_grids.device" not in c:
        return None
    total = c["decode.small_grids.device"] + c.get("decode.small_grids.host", 0)
    return c["decode.small_grids.device"] / total if total > 0 else None


def read(t: dict):
    return reading(t, "decode", _share)
