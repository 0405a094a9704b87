"""Conv wrapper with the padding semantics the codec needs. Arrays are NCHW
and kernels OIHW, as in the JAX package (coolchic_tpu/ops/convs.py)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv2d_replicate(x: torch.Tensor, kernel: torch.Tensor,
                     bias: torch.Tensor | None = None, padding: int = 0,
                     groups: int = 1) -> torch.Tensor:
    """Cross-correlation of an edge-replicated input (Cool-Chic synthesis
    convs, reference coolchic/component/core/synthesis.py:70)."""
    if padding > 0:
        x = F.pad(x, (padding, padding, padding, padding), mode="replicate")
    return F.conv2d(x, kernel, bias, groups=groups)
