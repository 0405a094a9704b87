"""Kernel launches per training step, from the profiler (host dispatch)."""


def read(t: dict):
    if t.get("kind") != "train" or not t["steps"] or not t["launches"]:
        return None
    return t["launches"] / t["steps"]
