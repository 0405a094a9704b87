"""Causal spatial-context extraction for the ARM entropy model.

Each of the N static context offsets is one shifted slice of the
zero-padded grid; the stack of N slices is the [H*W, N] context matrix.
Every output is a copy of one input value, so the result is exact in f32
(a one-hot convolution could run in TF32 or pick an inexact algorithm).

Reference parity: coolchic/component/core/arm.py:420-445 and
coolchic_tpu/ops/context.py:spatial_context_slices.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from coolchic_tpu_torch.core.constants import MAX_ARM_MASK_SIZE, ctx_row_col_offsets


def spatial_context(grid: torch.Tensor, n_spatial_ctx: int) -> torch.Tensor:
    """Per-pixel causal contexts of latent grids [..., H, W].

    Returns [..., H * W, n_spatial_ctx]; column k holds the k-th context
    pixel (priority order), zero outside the grid."""
    h, w = grid.shape[-2:]
    half = (MAX_ARM_MASK_SIZE - 1) // 2
    padded = F.pad(grid, (half, half, half, half))
    cols = [padded[..., half + dy: half + dy + h, half + dx: half + dx + w]
            for dy, dx in ctx_row_col_offsets(n_spatial_ctx)]
    ctx = torch.stack(cols, dim=-1)  # [..., H, W, N]
    return ctx.reshape(*grid.shape[:-2], h * w, n_spatial_ctx)
