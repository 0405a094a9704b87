"""IFCE wiring of the entropy model. The decode runs the ARM and the IFCE in
fixed point (bitstream/tpu_cdf.py, the CUDA wavefront kernel and the host
C++), so only the grid -> IFCE-ARM index map is needed here.

Reference parity: coolchic_tpu/models/arm.py:ifce_arm_index.
"""

from __future__ import annotations


def ifce_arm_index(input_features_ifce: tuple[int, ...]) -> dict[int, int]:
    """Latent grid index -> index of its IFCE ARM (grids with no IFCE input
    features have none)."""
    mapping = {}
    internal = 0
    for i, in_ft in enumerate(input_features_ifce):
        if in_ft == 0:
            continue
        mapping[i] = internal
        internal += 1
    return mapping
