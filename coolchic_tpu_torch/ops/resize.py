"""`F.interpolate`-compatible resizing as two matrix products, with the exact
semantics the Cool-Chic format pins (align_corners=False):

  - ``nearest``  : IFCE context path and motion fields;
  - ``bicubic``  : common randomness and the final ``rescale_output``
                   (a = -0.75, Keys kernel);
  - ``bilinear`` : alternative final upsampling type.

The separable filters are the same dense [out, in] matrices as the JAX
package's (coolchic_tpu/ops/resize.py), so both packages compute the same
sums in the same order.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

_CUBIC_A = -0.75


def _cubic_w1(t: float) -> float:
    # |t| <= 1 branch of the Keys kernel.
    a = _CUBIC_A
    return ((a + 2.0) * t - (a + 3.0)) * t * t + 1.0


def _cubic_w2(t: float) -> float:
    # 1 < |t| < 2 branch of the Keys kernel.
    a = _CUBIC_A
    return ((a * t - 5.0 * a) * t + 8.0 * a) * t - 4.0 * a


@lru_cache(maxsize=None)
def _resize_matrix_np(in_size: int, out_size: int, mode: str) -> np.ndarray:
    """Dense [out_size, in_size] 1-D resampling matrix, float32."""
    w = np.zeros((out_size, in_size), dtype=np.float64)
    scale = in_size / out_size

    if mode == "bilinear":
        for o in range(out_size):
            src = max((o + 0.5) * scale - 0.5, 0.0)
            i0 = int(np.floor(src))
            t = src - i0
            i0c = min(i0, in_size - 1)
            i1c = min(i0 + 1, in_size - 1)
            w[o, i0c] += 1.0 - t
            w[o, i1c] += t
    elif mode == "bicubic":
        for o in range(out_size):
            src = (o + 0.5) * scale - 0.5
            i0 = int(np.floor(src))
            t = src - i0
            coeffs = [_cubic_w2(t + 1.0), _cubic_w1(t), _cubic_w1(1.0 - t), _cubic_w2(2.0 - t)]
            for k, c in enumerate(coeffs):
                idx = min(max(i0 - 1 + k, 0), in_size - 1)
                w[o, idx] += c
    else:
        raise ValueError(f"Unknown separable resize mode {mode}")

    return w.astype(np.float32)


@lru_cache(maxsize=None)
def _nearest_index_np(in_size: int, out_size: int) -> np.ndarray:
    # torch 'nearest' (legacy): src = floor(dst * in / out)
    idx = np.floor(np.arange(out_size) * (in_size / out_size)).astype(np.int64)
    return np.minimum(idx, in_size - 1)


@lru_cache(maxsize=256)
def _on(fn, in_size: int, out_size: int, device: torch.device, *mode) -> torch.Tensor:
    """fn's table for (in_size, out_size[, mode]) on `device`, made once: a
    host-to-card copy waits for the card, so the training step must not
    make one per call."""
    return torch.as_tensor(fn(in_size, out_size, *mode), device=device)


def interpolate(x: torch.Tensor, size: tuple[int, int], mode: str) -> torch.Tensor:
    """Resize ``x`` ([..., H, W]) to ``size`` with torch-interpolate
    semantics (align_corners=False for bilinear/bicubic)."""
    h_in, w_in = x.shape[-2], x.shape[-1]
    h_out, w_out = size
    if (h_in, w_in) == (h_out, w_out):
        # every mode interpolates: identical size is the identity
        return x
    if mode == "nearest":
        if (h_out, w_out) == (2 * h_in, 2 * w_in):
            lead = x.shape[:-2]
            y = x[..., :, None, :, None].expand(*lead, h_in, 2, w_in, 2)
            return y.reshape(*lead, h_out, w_out)
        iy = _on(_nearest_index_np, h_in, h_out, x.device)
        ix = _on(_nearest_index_np, w_in, w_out, x.device)
        return x[..., iy, :][..., :, ix]

    wy = _on(_resize_matrix_np, h_in, h_out, x.device, mode).to(x.dtype)
    wx = _on(_resize_matrix_np, w_in, w_out, x.device, mode).to(x.dtype)
    # [..., H_in, W_in] -> [..., H_out, W_in] -> [..., H_out, W_out]
    y = torch.einsum("oh,...hw->...ow", wy, x)
    return torch.einsum("ow,...hw->...ho", wx, y)


def interpolate_x2(x: torch.Tensor, mode: str) -> torch.Tensor:
    """F.interpolate(scale_factor=2.0) semantics."""
    return interpolate(x, (2 * x.shape[-2], 2 * x.shape[-1]), mode)
