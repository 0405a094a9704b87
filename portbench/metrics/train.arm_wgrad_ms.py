"""Device ms a training step of the ARM's weight gradient: the kernels
whose names hold `arm_wgrad` (the program's csrc/arm_wgrad.cu, both its
passes), from the card-alone pass's kernel times, over its steps. A
program without that kernel gives no reading."""

KERNEL = "arm_wgrad"


def read(t: dict):
    if t.get("kind") != "train" or not t["steps"]:
        return None
    s = sum(v for k, v in t["kernel_s"].items() if KERNEL in k)
    return 1e3 * s / t["steps"] if s > 0 else None
