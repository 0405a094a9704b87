"""Rate-distortion loss: L = sum_d w_d * D_d + lambda * (R_latent + R_nn) / n_pixels.

Distortions: MSE (YUV420 weighted by per-plane pixel counts) and
Wasserstein (train/wasserstein.py). Out-of-[0,1] targets are renormalized
on the fly. Batched: every input carries a leading axis of G images and
every output field is [G].

Reference parity: coolchic/training/loss.py and coolchic_tpu/train/loss.py.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple

import torch


def dist_to_db(dist) -> float:
    """-10 log10(dist), floored at 100 dB (reference metrics/mse.py)."""
    if dist <= 0:
        return 100.0
    return min(-10.0 * math.log10(dist), 100.0)


def mse_fn(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-image MSE of [G, ...] batches -> [G]."""
    return torch.square(x - y).flatten(1).mean(dim=1)


def compute_mse(x, y) -> torch.Tensor:
    """MSE per image; dicts (yuv420) are weighted by per-plane pixel counts."""
    if not isinstance(x, dict):
        return mse_fn(x, y)
    total = 0
    mse = 0.0
    for k in ("y", "u", "v"):
        n = x[k][0].numel()
        mse = mse + mse_fn(x[k], y[k]) * n
        total += n
    return mse / total


class LossOutput(NamedTuple):
    loss: torch.Tensor
    dist: torch.Tensor
    rate_bpp: torch.Tensor
    total_rate_latent_bpp: torch.Tensor
    mse: torch.Tensor


def loss_function(decoded_image, rate_latent_bit: Dict[str, torch.Tensor], target_image,
                  dist_weight: Dict[str, float], lmbda,
                  total_rate_nn_bit: float = 0.0,
                  wasserstein_fn=None) -> LossOutput:
    """`lmbda`: a float or a [G] tensor (one rate point per image).
    `wasserstein_fn(decoded, target) -> [G]` computes the "wasserstein"
    term of `dist_weight` (train/wasserstein.py:make_wasserstein_fn)."""
    if not isinstance(target_image, dict):
        # Renormalize out-of-range targets (e.g. raw flow pretraining
        # targets), per image and without a host sync.
        flat = target_image.flatten(1)
        out_of_range = flat.abs().amax(dim=1) > 1.0
        shape = (-1,) + (1,) * (target_image.dim() - 1)
        t_min = torch.where(out_of_range, flat.amin(dim=1), 0.0).reshape(shape)
        t_max = torch.where(out_of_range, flat.amax(dim=1), 1.0).reshape(shape)
        rng = t_max - t_min
        decoded_image = (decoded_image - t_min) / rng
        target_image = (target_image - t_min) / rng

    dist = 0.0
    mse = None
    for name, w in dist_weight.items():
        if name == "mse":
            cur = compute_mse(decoded_image, target_image)
            mse = cur
        elif name == "wasserstein":
            if wasserstein_fn is None:
                raise ValueError("wasserstein distortion requested but no extractor given")
            cur = wasserstein_fn(decoded_image, target_image)
        else:
            raise ValueError(f"Unknown distortion {name}")
        dist = dist + w * cur
    if mse is None:
        mse = compute_mse(decoded_image, target_image)

    if isinstance(decoded_image, dict):
        n_pixels = decoded_image["y"].shape[-2] * decoded_image["y"].shape[-1]
    else:
        n_pixels = decoded_image.shape[-2] * decoded_image.shape[-1]

    total_latent_bit = sum(v.sum(dim=1) for v in rate_latent_bit.values())
    rate_bpp = (total_latent_bit + total_rate_nn_bit) / n_pixels
    loss = dist + lmbda * rate_bpp
    return LossOutput(loss=loss, dist=dist, rate_bpp=rate_bpp,
                      total_rate_latent_bpp=total_latent_bit / n_pixels, mse=mse)
