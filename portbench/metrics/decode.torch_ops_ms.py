"""Device time per call of every kernel but the wavefront kernel: IFCE
context, shear, upsampling, synthesis, resize (batch prep + float tail)."""

KERNEL = "wavefront_decode_kernel"


def read(t: dict):
    if t.get("kind") != "decode" or not t["calls"]:
        return None
    s = sum(v for k, v in t["kernel_s"].items() if KERNEL not in k)
    return 1e3 * s / t["calls"] if s > 0 else None
