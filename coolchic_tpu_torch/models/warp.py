"""Motion compensation (warping) with selectable interpolation filters.

A gather-based separable interpolation: the integer part of the flow
relocates each pixel's tap window (indices clamped to the border, matching
grid_sample(padding_mode="border", align_corners=True)); the fractional part
selects per-pixel filter coefficients:

  - filter_size 2: bilinear (coeffs (1-s, s))
  - filter_size 4: bicubic, a = -0.75 (torch grid_sample polynomial)
  - filter_size >= 6: cos-windowed sinc ("Efficient Sub-pixel Motion
    Compensation in Learned Video Codecs", eq. 6)

At eval time flows are quantized to 1/64 pixel (fractional_accuracy).

Batched: [G, C, H, W] images by [G, 2, H, W] flows. The JAX package builds
the whole [C, k, k, H, W] neighbour tensor of one image (~300 MB of f32 at
512x768, k = 8, C = 3); here one y-tap's [G, C, k, H, W] gather is live at
a time, in the forward and in the backward (which re-gathers instead of
keeping the neighbours). The x taps are summed first, then the y taps, as
the JAX einsums do. Gradients reach the flow through the coefficients only
(the integer tap indices carry none) and never the warped image: the
references are constants of the frame.

Reference parity: coolchic/component/intercoding/warp.py through
coolchic_tpu/models/warp.py.
"""

from __future__ import annotations

import math

import numpy as np
import torch

FRACTIONAL_ACCURACY = 64


def _coeffs(s: torch.Tensor, filter_size: int) -> torch.Tensor:
    """s: [..., 1] fractional offsets in [0, 1) -> [..., filter_size] taps."""
    lo = -(filter_size // 2) + 1
    hi = filter_size // 2
    if filter_size == 2:
        return torch.cat([1.0 - s, s], dim=-1)
    if filter_size == 4:
        a = -0.75
        b = torch.tensor([
            [0, a, -2 * a, a],
            [1, 0, -(a + 3), a + 2],
            [0, -a, (2 * a + 3), -(a + 2)],
            [0, 0, a, -a],
        ], dtype=torch.float32, device=s.device)
        s_pow = torch.cat([s**e for e in range(4)], dim=-1)
        return s_pow @ b.T
    kappa = torch.arange(lo, hi + 1, dtype=torch.float32, device=s.device)
    window = torch.cos(math.pi * (s - kappa) / filter_size)
    return window * torch.sinc(s - kappa)


def _gather_tap(xf: torch.Tensor, iy_a: torch.Tensor, ix: torch.Tensor,
                w: int) -> torch.Tensor:
    """Neighbours of y-tap a: xf [G, C, H*W], iy_a [G, H, W], ix [G, k, H, W]
    -> [G, C, k, H, W] with out[g, c, b, i, j] = x[g, c, iy_a[g, i, j],
    ix[g, b, i, j]]."""
    G, C, _ = xf.shape
    idx = (iy_a[:, None] * w + ix).reshape(G, 1, -1)
    return torch.gather(xf, 2, idx.expand(G, C, idx.shape[-1])).reshape(G, C, *ix.shape[1:])


class _SeparableWarp(torch.autograd.Function):
    """out = sum_a cy[a] * sum_b cx[b] * x[iy[a], ix[b]], one y-tap at a time;
    the backward re-gathers each tap instead of saving k of them."""

    @staticmethod
    def forward(ctx, x, cx, cy, ix, iy):
        G, C, h, w = x.shape
        xf = x.reshape(G, C, h * w)
        out = x.new_zeros((G, C, h, w))
        for a in range(cy.shape[1]):
            line = (_gather_tap(xf, iy[:, a], ix, w) * cx[:, None]).sum(dim=2)
            out = out + line * cy[:, a, None]
        ctx.save_for_backward(x, cx, cy, ix, iy)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        x, cx, cy, ix, iy = ctx.saved_tensors
        G, C, h, w = x.shape
        xf = x.reshape(G, C, h * w)
        grad_cx = torch.zeros_like(cx)
        grad_cy = torch.zeros_like(cy)
        for a in range(cy.shape[1]):
            nb = _gather_tap(xf, iy[:, a], ix, w)
            line = (nb * cx[:, None]).sum(dim=2)
            grad_cy[:, a] = (grad_out * line).sum(dim=1)
            grad_line = grad_out * cy[:, a, None]
            grad_cx = grad_cx + (nb * grad_line[:, :, None]).sum(dim=1)
        return None, grad_cx, grad_cy, None, None


def warp_fn(x: torch.Tensor, flow: torch.Tensor, filter_size: int,
            training: bool = False) -> torch.Tensor:
    """Warp x [G, C, H, W] by flow [G, 2, H, W] (pixels; channel 0 is
    horizontal): out[g, c, i, j] = x[g, c, i + flow_y, j + flow_x],
    interpolated by the filter_size-tap filter."""
    filter_size = int(filter_size)
    G, C, h, w = x.shape
    q_flow = flow if training else torch.round(flow * FRACTIONAL_ACCURACY) / FRACTIONAL_ACCURACY
    rounded = torch.floor(q_flow).detach()
    frac = q_flow - rounded  # [G, 2, H, W]

    dev = x.device
    base_x = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :] + rounded[:, 0]
    base_y = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None] + rounded[:, 1]
    lo = -(filter_size // 2) + 1
    taps = torch.arange(lo, filter_size // 2 + 1, dtype=torch.float32,
                        device=dev)[None, :, None, None]
    # tap indices [G, k, H, W], clamped to the borders (grid_sample "border")
    ix = torch.clamp(base_x[:, None] + taps, 0, w - 1).long()
    iy = torch.clamp(base_y[:, None] + taps, 0, h - 1).long()
    cx = _coeffs(frac[:, 0, ..., None], filter_size).movedim(-1, 1)  # [G, k, H, W]
    cy = _coeffs(frac[:, 1, ..., None], filter_size).movedim(-1, 1)
    return _SeparableWarp.apply(x.detach(), cx, cy, ix, iy)


def nearest_warp(x: np.ndarray, flow: np.ndarray) -> np.ndarray:
    """Nearest-neighbour warp with border clamping (global translation path),
    numpy [1, C, H, W] by [1, 2, H, W]. Matches vanilla_warp_fn(mode=
    "nearest"): grid_sample nearest rounds the sampling coordinate to the
    nearest pixel, then clamps to the border."""
    x = np.asarray(x)
    flow = np.asarray(flow)
    _, _, h, w = x.shape
    jj = np.arange(w)[None, :] + flow[0, 0]
    ii = np.arange(h)[:, None] + flow[0, 1]
    ix = np.clip(np.round(jj).astype(np.int64), 0, w - 1)
    iy = np.clip(np.round(ii).astype(np.int64), 0, h - 1)
    return x[:, :, iy, ix]


def apply_global_translation(reference_frames: list, global_flows: list) -> list:
    """Shift each numpy reference by its constant global flow (nearest warp)."""
    out = []
    for ref, gflow in zip(reference_frames, global_flows):
        h, w = np.asarray(ref).shape[-2:]
        flow = np.broadcast_to(np.asarray(gflow, dtype=np.float32).reshape(1, 2, 1, 1),
                               (1, 2, h, w))
        out.append(nearest_warp(ref, flow))
    return out


def shift_references(refs: list, global_flows: list) -> list:
    """Each [G, C, H, W] reference shifted by its slot's global flow ([G, 2]
    tensors, rounded to integers): the nearest warp of a constant integer
    flow is a clamped index shift (coolchic_tpu/models/frame.py:121-129)."""
    out = []
    for ref, gflow in zip(refs, global_flows):
        G, C, h, w = ref.shape
        g = torch.round(gflow.detach()).long()            # [G, 2]
        jj = torch.clamp(torch.arange(w, device=ref.device)[None] + g[:, 0:1], 0, w - 1)
        ii = torch.clamp(torch.arange(h, device=ref.device)[None] + g[:, 1:2], 0, h - 1)
        rows = torch.gather(ref, 2, ii[:, None, :, None].expand(G, C, h, w))
        out.append(torch.gather(rows, 3, jj[:, None, None, :].expand(G, C, h, w)))
    return out
