"""6 x MAC/pixel x pixels x images per step (forward and backward), over
the host clock's time of the untraced steps, over the H100 SXM's
67 TFLOP/s FP32 rate."""

from portbench.yardstick import FP32_FLOP_PER_S


def read(t: dict):
    if t.get("kind") != "train" or t["busy_s"] <= 0:
        return None
    return 100.0 * 6.0 * t["mac_per_px"] * t["pixels"] * t["img_steps"] / t["clock_s"] \
        / FP32_FLOP_PER_S
