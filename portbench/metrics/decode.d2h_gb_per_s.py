"""The copy of the frames and grids back to the host, GB/s: the bytes the
program counts in `decode.copy_out` (decode.d2h_bytes, per call, from
portbench/spans.py's program pass) over the DtoH copy time per call of the
card-alone pass, which traces calls of the window's own kind. Every DtoH
copy of a decode call is launched in `decode.copy_out`, and the files of a
pool share one configuration, so every call copies the same bytes."""

from portbench.spans import passes


def read(t: dict):
    if t.get("kind") != "decode" or not t.get("calls"):
        return None
    s = sum(v for k, v in t.get("breakdown", {}).get("device_ops", []) if "DtoH" in k)
    if s <= 0:
        return None
    out = passes(t)
    n_bytes = out["host"]["counters"].get("decode.d2h_bytes") if out else None
    return n_bytes / (s / t["calls"]) * 1e-9 if n_bytes else None
