"""Global (whole-frame) integer translation search.

Coarse-to-fine: starting from +-2^8 down to +-2, test the 9 combinations of
{-s, 0, +s} per axis around the current center, keep the best (nearest-warp
MSE), halve s. Encoder-side only; the winning translation is written in the
frame header and applied at decode with a nearest warp.

A copy of coolchic_tpu/models/globalmotion.py (numpy on the host, f32), so
that the port finds the same integers: its quirks are kept, the steps stop
at +-2 and each scale restarts the bar at the unshifted MSE.

Reference parity: coolchic/component/intercoding/globalmotion.py:22-160.
"""

from __future__ import annotations

import numpy as np

from coolchic_tpu_torch.models.warp import nearest_warp


def get_global_translation(target: np.ndarray, refs: list[np.ndarray],
                           verbose: bool = False) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """target/refs: dense [1, C, H, W] float arrays.

    Returns (shifted refs, per-ref global flow [2] = (dx, dy))."""
    shifted_refs, global_flows = [], []
    for ref in refs:
        ref = np.asarray(ref, dtype=np.float32)
        h, w = ref.shape[-2:]
        center = np.zeros(2, dtype=np.float32)  # (dx, dy)

        def mse_of(shift):
            flow = np.broadcast_to(shift.reshape(1, 2, 1, 1), (1, 2, h, w))
            return float(((nearest_warp(ref, flow) - target) ** 2).mean())

        initial_mse = mse_of(np.zeros(2, dtype=np.float32))
        best_mse = initial_mse
        for n in range(8, 0, -1):
            s = float(2**n)
            cands = [(0, 0), (0, s), (0, -s), (s, 0), (-s, 0),
                     (s, s), (-s, s), (s, -s), (-s, -s)]
            # each scale restarts the bar at the unshifted MSE (reference
            # globalmotion.py:99-116 behaves this way)
            best_mse = initial_mse
            best_shift = np.zeros(2, dtype=np.float32)
            for dx, dy in cands:
                shift = center + np.array([dx, dy], dtype=np.float32)
                m = mse_of(shift)
                if m < best_mse:
                    best_mse = m
                    best_shift = np.array([dx, dy], dtype=np.float32)
            center = center + best_shift
            if verbose:
                print(f"  global motion +-{int(s):<4} center=({center[0]:.0f},"
                      f"{center[1]:.0f}) mse={best_mse:.6f}")

        flow = np.broadcast_to(center.reshape(1, 2, 1, 1), (1, 2, h, w))
        shifted_refs.append(nearest_warp(ref, flow))
        global_flows.append(center)
    return shifted_refs, global_flows
