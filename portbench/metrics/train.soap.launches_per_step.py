"""Kernel launches per training step in the program's spans `train.soap`
and `train.soap.refresh` (SOAP's per-leaf updates; a refresh in each
refresh period), from portbench/spans.py's device pass."""

from portbench.spans import reading

SPANS = ("train.soap", "train.soap.refresh")


def read(t: dict):
    return reading(t, "train", lambda m: sum(v for k, v in m["device"]["launches"].items()
                                             if k in SPANS) or None)
