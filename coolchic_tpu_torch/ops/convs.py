"""Conv wrapper with the padding semantics the codec needs. Arrays are NCHW
and kernels OIHW, as in the JAX package (coolchic_tpu/ops/convs.py)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _edges(x: torch.Tensor, dim: int, before: int, after: int) -> torch.Tensor:
    """x with its first and last slices along `dim` repeated before and
    after times: a cat of expanded views, whose backward is slicing and a
    sum over the expanded axis."""
    if before == after == 0:
        return x
    n = x.shape[dim]
    parts = [x.narrow(dim, 0, 1).expand(*x.shape[:dim], before, *x.shape[dim + 1:]), x,
             x.narrow(dim, n - 1, 1).expand(*x.shape[:dim], after, *x.shape[dim + 1:])]
    return torch.cat(parts, dim)


def replicate_pad(x: torch.Tensor, pad: tuple[int, int, int, int]) -> torch.Tensor:
    """F.pad(x, (left, right, top, bottom), mode="replicate") with a
    deterministic backward (coolchic_tpu/ops/convs.py:replicate_pad). On a
    card the backward of torch's replication pad adds the edges' gradients
    with atomics, in an order that may change run to run; here every
    gradient is a slice or a sum."""
    left, right, top, bottom = pad
    return _edges(_edges(x, x.dim() - 2, top, bottom), x.dim() - 1, left, right)


def conv2d_replicate(x: torch.Tensor, kernel: torch.Tensor,
                     bias: torch.Tensor | None = None, padding: int = 0,
                     groups: int = 1) -> torch.Tensor:
    """Cross-correlation of an edge-replicated input (Cool-Chic synthesis
    convs, reference coolchic/component/core/synthesis.py:70)."""
    if padding > 0:
        x = replicate_pad(x, (padding,) * 4)
    return F.conv2d(x, kernel, bias, groups=groups)
