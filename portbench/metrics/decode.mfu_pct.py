"""2 x MAC/pixel x pixels decoded, over the host clock's time of the
untraced calls, over the H100 SXM's 67 TFLOP/s FP32 rate outside the
tensor cores (the port runs in f32 with TF32 off)."""

from portbench.yardstick import FP32_FLOP_PER_S


def read(t: dict):
    if t.get("kind") != "decode" or t["busy_s"] <= 0:
        return None
    return 100.0 * 2.0 * t["mac_per_px"] * t["pixels"] / t["clock_s"] / FP32_FLOP_PER_S
