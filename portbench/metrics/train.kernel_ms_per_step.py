"""Device time of all kernels per training step (every slot of the batch)."""


def read(t: dict):
    if t.get("kind") != "train" or not t["steps"]:
        return None
    s = sum(t["kernel_s"].values())
    return 1e3 * s / t["steps"] if s > 0 else None
