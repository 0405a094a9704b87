"""Share of training steps whose SOAP update replayed a CUDA graph: the
program's counter `train.soap.graph_replays` a step (replays over steps),
tracing on (portbench/spans.py's program pass). A program without the
counters (`train.soap.graph_replays`, `train.soap.eager_steps`), as before
the graph, gives no reading."""

from portbench.spans import reading

COUNTERS = ("train.soap.graph_replays", "train.soap.eager_steps")


def _share(m: dict):
    c = m["host"]["counters"]
    if not any(k in c for k in COUNTERS):
        return None
    return c.get("train.soap.graph_replays", 0.0)


def read(t: dict):
    return reading(t, "train", _share)
