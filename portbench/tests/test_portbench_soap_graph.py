"""The reader of train.soap.graph_share (and .n1) on synthetic readings of
the program's passes (portbench/spans.py): the replays of SOAP's CUDA
graph a step. A program without the counters, as before the graph, gives
no reading."""

import pytest

from portbench import harness, spans

CTX = {"kind": "train", "steps": 10, "busy_s": 1.0, "clock_s": 1.0, "breakdown": {}}


@pytest.mark.parametrize("name", ["train.soap.graph_share", "train.soap.graph_share.n1"])
@pytest.mark.parametrize("counters, share", [
    ({"train.soap.graph_replays": 0.9, "train.soap.eager_steps": 0.1}, 0.9),
    ({"train.soap.eager_steps": 1.0}, 0.0),                  # the CPU: every step eager
    ({"train.soap.graph_replays": 1.0}, 1.0),
    ({"train.arm_wgrad.launches": 7.0}, None),               # no such counters
])
def test_graph_share_reads_the_counters(monkeypatch, name, counters, share):
    monkeypatch.setattr(spans, "passes", lambda t: {"host": {"counters": counters}})
    got = harness.load_reader(name).read(CTX)
    assert got == (pytest.approx(share) if share is not None else None)


def test_graph_share_reads_training_passes_only(monkeypatch):
    monkeypatch.setattr(spans, "passes", lambda t: {"host": {"counters": {
        "train.soap.graph_replays": 0.9}}})
    assert harness.load_reader("train.soap.graph_share").read(dict(CTX, kind="decode")) is None
    monkeypatch.setattr(spans, "passes", lambda t: None)      # no card or no cell
    assert harness.load_reader("train.soap.graph_share").read(CTX) is None
