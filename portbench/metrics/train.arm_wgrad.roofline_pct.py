"""The ARM's weight gradient's least time over its device time, in percent:
the bytes the program counts a step in `train.arm_wgrad.bytes` (X and dY
read once a launch, from portbench/spans.py's program pass, which runs the
cell's own steps) at the H100 SXM's HBM rate, over the device time a step
of the kernels whose names hold `arm_wgrad`, from the card-alone pass. A
program without the kernel or the counter gives no reading."""

from portbench.spans import passes
from portbench.yardstick import HBM_BYTES_PER_S

KERNEL = "arm_wgrad"


def read(t: dict):
    if t.get("kind") != "train" or not t["steps"]:
        return None
    s = sum(v for k, v in t["kernel_s"].items() if KERNEL in k)
    if s <= 0:
        return None
    out = passes(t)
    n_bytes = out["host"]["counters"].get("train.arm_wgrad.bytes") if out else None
    return 100.0 * n_bytes / HBM_BYTES_PER_S / (s / t["steps"]) if n_bytes else None
