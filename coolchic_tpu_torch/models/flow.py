"""Dense optical-flow estimation for guided motion pretraining.

The reference uses torchvision's pretrained RAFT purely as an encoder-side
guidance signal (coolchic/component/intercoding/raft.py): the flow never
reaches the bitstream, it only initializes the motion decoder's training.
Like the JAX package (coolchic_tpu/models/flow.py), the port uses a
deterministic pyramidal Lucas-Kanade estimator instead, so no weights are
needed.

Flow convention matches the codec's warper: warp(ref, flow)[i, j] =
ref[i + flow_y, j + flow_x], i.e. the flow maps the current frame's pixels
to their source location in the reference.

Batched: [G, C, H, W] frames -> [G, 2, H, W] flows.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from coolchic_tpu_torch.models.warp import warp_fn
from coolchic_tpu_torch.ops.resize import interpolate


def _to_gray(x: torch.Tensor) -> torch.Tensor:
    """[G, C, H, W] -> [G, 1, H, W] luminance."""
    if x.shape[1] == 3:
        w = torch.tensor([0.2126, 0.7152, 0.0722], dtype=torch.float32,
                         device=x.device).reshape(1, 3, 1, 1)
        return (x * w).sum(dim=1, keepdim=True)
    return x.mean(dim=1, keepdim=True)


def _down2(x: torch.Tensor) -> torch.Tensor:
    """2x2 mean pooling; an odd last row / column is dropped."""
    b, c, h, w = x.shape
    h2, w2 = h // 2 * 2, w // 2 * 2
    x = x[:, :, :h2, :w2]
    return x.reshape(b, c, h2 // 2, 2, w2 // 2, 2).mean(dim=(3, 5))


def _box(x: torch.Tensor, k: int = 7) -> torch.Tensor:
    """Separable box sum (same size, zero padding)."""
    pad = k // 2
    c = x.shape[1]
    x = x.reshape(-1, 1, *x.shape[-2:])
    x = F.conv2d(x, x.new_ones((1, 1, k, 1)), padding=(pad, 0))
    x = F.conv2d(x, x.new_ones((1, 1, 1, k)), padding=(0, pad))
    return x.reshape(-1, c, *x.shape[-2:])


def _lk_refine(target: torch.Tensor, ref: torch.Tensor, flow: torch.Tensor,
               n_iters: int) -> torch.Tensor:
    """Iterative dense LK at one pyramid level. target/ref: [G, 1, H, W]."""
    for _ in range(n_iters):
        warped = warp_fn(ref, flow, filter_size=2, training=True)
        # central differences, wrapping around the borders (jnp.roll)
        ix = (torch.roll(warped, -1, dims=-1) - torch.roll(warped, 1, dims=-1)) * 0.5
        iy = (torch.roll(warped, -1, dims=-2) - torch.roll(warped, 1, dims=-2)) * 0.5
        it = warped - target
        ixx = _box(ix * ix)
        iyy = _box(iy * iy)
        ixy = _box(ix * iy)
        ixt = _box(ix * it)
        iyt = _box(iy * it)
        eps = 1e-4
        det = (ixx + eps) * (iyy + eps) - ixy * ixy
        du = -((iyy + eps) * ixt - ixy * iyt) / det
        dv = -((ixx + eps) * iyt - ixy * ixt) / det
        flow = flow + torch.clamp(torch.cat([du, dv], dim=1), -2.0, 2.0)
    return flow


@torch.no_grad()
def estimate_flow(target: torch.Tensor, ref: torch.Tensor, n_levels: int | None = None,
                  n_iters: int = 8) -> torch.Tensor:
    """Dense flow [G, 2, H, W] (pixels) mapping `target` pixels to `ref`,
    both [G, C, H, W] on one device."""
    target = target.float()
    ref = ref.float()
    h, w = target.shape[-2:]
    if n_levels is None:
        n_levels = max(int(np.log2(min(h, w))) - 4, 1)
    tgs, rgs = [_to_gray(target)], [_to_gray(ref)]
    for _ in range(n_levels - 1):
        tgs.append(_down2(tgs[-1]))
        rgs.append(_down2(rgs[-1]))

    G = target.shape[0]
    flow = target.new_zeros((G, 2, *tgs[-1].shape[-2:]))
    for lvl in range(n_levels - 1, -1, -1):
        if lvl != n_levels - 1:
            # not always 2x: _down2 truncates odd sizes
            flow = 2.0 * interpolate(flow, tuple(tgs[lvl].shape[-2:]), "bilinear")
        flow = _lk_refine(tgs[lvl], rgs[lvl], flow, n_iters)
    return flow
