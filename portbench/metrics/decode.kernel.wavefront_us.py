"""The wavefront kernel's device time per call, over the serial wavefronts
of the levels it decodes: us per wavefront (the kernel's serial chain)."""

KERNEL = "wavefront_decode_kernel"


def read(t: dict):
    if t.get("kind") != "decode" or not t["calls"]:
        return None
    s = sum(v for k, v in t["kernel_s"].items() if KERNEL in k)
    return 1e6 * s / (t["calls"] * t["wavefronts_per_call"]) if s > 0 else None
