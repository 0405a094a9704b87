"""The wavefront kernel's least time (yardstick.kernel_bound: bytes at the
HBM rate, integer operations at the FP32 CUDA-core rate, the larger) over
its device time, in percent of the H100 SXM's published peaks."""

KERNEL = "wavefront_decode_kernel"


def read(t: dict):
    if t.get("kind") != "decode" or not t["calls"]:
        return None
    s = sum(v for k, v in t["kernel_s"].items() if KERNEL in k)
    return 100.0 * t["calls"] * t["bound_s_per_call"] / s if s > 0 else None
