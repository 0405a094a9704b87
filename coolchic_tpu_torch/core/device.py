"""Explicit device selection: "cuda" must mean a CUDA card, never a silent
fallback to the CPU."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """torch.device for `device`; raises when a CUDA device is asked for and
    there is none (pass device="cpu" to run on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but torch sees no CUDA "
                "device; pass device='cpu' to run on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev
