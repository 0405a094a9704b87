"""The readers of the small-grid decode's per-layer metrics on synthetic
readings of the program's passes (portbench/spans.py): the device ms
launched in the span `decode.small_grids`, and the share of the grids the
counters say went to the card. A program without the span or the
counters, as before the small-grid decode, gives no reading."""

import pytest

from portbench import harness, spans

CTX = {"kind": "decode", "calls": 2, "busy_s": 1.0, "clock_s": 1.0, "breakdown": {}}


@pytest.mark.parametrize("kernel_ms, ms", [
    ({"decode.small_grids": 4.5, "decode.ifce": 1.2, "decode.kernel": 16.1}, 4.5),
    ({"decode.ifce": 1.2, "decode.kernel": 16.1}, None),     # no such span
])
def test_small_grids_ms_reads_the_spans_kernels(monkeypatch, kernel_ms, ms):
    monkeypatch.setattr(spans, "passes", lambda t: {"device": {"kernel_ms": kernel_ms}})
    got = harness.load_reader("decode.small_grids_ms").read(CTX)
    assert got == (pytest.approx(ms) if ms is not None else None)


@pytest.mark.parametrize("counters, share", [
    ({"decode.small_grids.device": 64.0, "decode.small_grids.host": 0.0}, 1.0),
    ({"decode.small_grids.device": 2.0, "decode.small_grids.host": 4.0}, 1 / 3),
    ({"decode.small_grids.device": 0.0, "decode.small_grids.host": 10.0}, 0.0),
    ({"decode.small_grids.device": 0.0, "decode.small_grids.host": 0.0}, None),
    ({"decode.d2h_bytes": 5.0}, None),                        # no such counters
])
def test_device_share_reads_the_counters(monkeypatch, counters, share):
    monkeypatch.setattr(spans, "passes", lambda t: {"host": {"counters": counters}})
    got = harness.load_reader("decode.small_grids.device_share").read(CTX)
    assert got == (pytest.approx(share) if share is not None else None)


def test_readers_read_decode_passes_only(monkeypatch):
    monkeypatch.setattr(spans, "passes", lambda t: None)      # no card or no cell
    for name in ("decode.small_grids_ms", "decode.small_grids.device_share"):
        reader = harness.load_reader(name)
        assert reader.read(dict(CTX, kind="train")) is None
        assert reader.read(CTX) is None
