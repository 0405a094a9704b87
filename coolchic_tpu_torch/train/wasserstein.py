"""Wasserstein distortion (texture-realism objective for --tune wasserstein).

Pipeline (reference coolchic/training/metrics/wasserstein.py, after the
Google "codex" Wasserstein-distortion formulation):
  1. extract multi-layer CNN features of decoded and target images (VGG16
     "features" after ReLUs 3, 8, 15, 22);
  2. per feature channel, build `num_levels` mean/variance pyramids with a
     3x3 binomial lowpass (stride-1 filter + stride-2 subsample);
  3. distortion = sum over levels of mean(weight * wd_map) with
     wd_map_0 = (fa - fb)^2, wd_map_i = (m_a - m_b)^2 + (sqrt(v_a) -
     sqrt(v_b))^2 and weight = relu(1 - |log2_sigma - i|), log2_sigma = 3.

The VGG16 weights are the deterministic He-initialized ones of the JAX
package (numpy rng, seed 20260817): nothing is ever fetched. Pretrained
weights in torchvision layout (keys features.{i}.weight / .bias) can be
given as an .npz path to load_vgg_weights / make_wasserstein_fn.

Batched: images carry a leading axis of G, features are [G, C, h, w] (the
JAX package's [C, 1, h, w] per image) and the distortion is one value per
image, [G].

Reference parity: coolchic_tpu/train/wasserstein.py.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

# torchvision VGG16 "features" prefix: (out_channels, layer index of conv)
_VGG_CONVS = [
    (64, 0), (64, 2),            # relu at 1, 3
    ("pool", 4),
    (128, 5), (128, 7),          # relu at 6, 8
    ("pool", 9),
    (256, 10), (256, 12), (256, 14),  # relu 11, 13, 15
    ("pool", 16),
    (512, 17), (512, 19), (512, 21),  # relu 18, 20, 22
]
_DESIRED_RELU = (3, 8, 15, 22)
LOG2_SIGMA = 3
NUM_LEVELS = 5
_LOWPASS = np.outer([0.25, 0.5, 0.25], [0.25, 0.5, 0.25]).reshape(1, 1, 3, 3) \
    .astype(np.float32)


def _he_init_weights(seed: int = 20260817) -> dict:
    rng = np.random.default_rng(seed)
    weights = {}
    in_ch = 3
    for out_ch, idx in _VGG_CONVS:
        if out_ch == "pool":
            continue
        fan_in = in_ch * 9
        w = rng.standard_normal((out_ch, in_ch, 3, 3)) * np.sqrt(2.0 / fan_in)
        weights[f"features.{idx}.weight"] = w.astype(np.float32)
        weights[f"features.{idx}.bias"] = np.zeros(out_ch, dtype=np.float32)
        in_ch = out_ch
    return weights


@lru_cache(maxsize=4)
def _vgg_weights_np(npz_path: Optional[str]) -> dict:
    if npz_path is None:
        return _he_init_weights()
    with np.load(npz_path) as data:
        return {k: np.asarray(data[k], dtype=np.float32) for k in data.files}


@lru_cache(maxsize=8)
def load_vgg_weights(device: torch.device, npz_path: Optional[str] = None) -> dict:
    """The VGG16 feature weights on `device`: He-init by default, or the
    torchvision-layout .npz at `npz_path`."""
    return {k: torch.as_tensor(v, device=device)
            for k, v in _vgg_weights_np(npz_path).items()}


def vgg16_features(x: torch.Tensor, weights: dict | None = None) -> list[torch.Tensor]:
    """[G, 3, H, W] in [0, 1] -> the 4 feature arrays [G, C, h, w]."""
    w = weights or load_vgg_weights(x.device)
    results = []
    for out_ch, conv_idx in _VGG_CONVS:
        if out_ch == "pool":
            # 2x2 max pool, stride 2 (odd sizes drop the last row / column)
            b, c, h, ww = x.shape
            x = x[:, :, : h // 2 * 2, : ww // 2 * 2]
            x = x.reshape(b, c, h // 2, 2, ww // 2, 2).amax(dim=(3, 5))
            continue
        x = torch.relu(F.conv2d(x, w[f"features.{conv_idx}.weight"].to(x.dtype),
                                w[f"features.{conv_idx}.bias"].to(x.dtype), padding=1))
        if conv_idx + 1 in _DESIRED_RELU:
            results.append(x)
    return results


def _lowpass(x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    k = torch.as_tensor(_LOWPASS, device=x.device).to(x.dtype)
    return F.conv2d(x, k, stride=stride, padding=1)


def _multiscale_stats(features: torch.Tensor, num_levels: int):
    squared = torch.square(features)
    means, variances = [], []
    for _ in range(num_levels):
        m = _lowpass(features)
        p = _lowpass(squared)
        means.append(m)
        variances.append(p - torch.square(m))
        features = m[..., ::2, ::2]
        squared = p[..., ::2, ::2]
    return means, variances


def _safe_clamp_min(y: torch.Tensor, lo: float) -> torch.Tensor:
    """Clamp forward, identity gradient (reference safe_clamp_min)."""
    return y + (torch.clamp_min(y, lo) - y).detach()


def wasserstein_distortion(fa: torch.Tensor, fb: torch.Tensor,
                           num_levels: int = NUM_LEVELS) -> torch.Tensor:
    """Features [G, C, h, w] of the decoded images against the target's
    ([G or 1, C, h, w]) -> [G]: each channel is one [1, h, w] map, as the
    reference reshapes its features."""
    G, c, h, w = fa.shape
    fa = fa.reshape(G * c, 1, h, w)
    fb = fb.expand(G, -1, -1, -1).reshape(G * c, 1, h, w)
    means_a, vars_a = _multiscale_stats(fa, num_levels)
    means_b, vars_b = _multiscale_stats(fb, num_levels)

    log2_sigma = torch.full((1, 1, h, w), float(LOG2_SIGMA), dtype=fa.dtype,
                            device=fa.device)
    wd_maps = [torch.square(fa - fb)]
    for ma, mb, va, vb in zip(means_a, means_b, vars_a, vars_b):
        sa = torch.sqrt(_safe_clamp_min(va, 5e-7))
        sb = torch.sqrt(_safe_clamp_min(vb, 5e-7))
        wd_maps.append(torch.square(ma - mb) + torch.square(sa - sb))

    dist = 0.0
    for i, wd_map in enumerate(wd_maps):
        weight = torch.relu(1.0 - torch.abs(log2_sigma - i))
        dist = dist + (weight * wd_map).reshape(G, -1).mean(dim=1)
        if i > 0:
            log2_sigma = _lowpass(log2_sigma, stride=2)
    return dist


def make_wasserstein_fn(target_img: torch.Tensor, npz_path: Optional[str] = None):
    """wd(decoded [G, 3, H, W]) -> [G] against `target_img` ([1 or G, 3, H,
    W]), whose features are computed once, without gradient (the reference
    caches the target features in its global singleton)."""
    weights = load_vgg_weights(target_img.device, npz_path)
    with torch.no_grad():
        target_ft = vgg16_features(target_img, weights)

    def fn(decoded_img: torch.Tensor, _target_unused=None) -> torch.Tensor:
        dist = 0.0
        for fa, fb in zip(vgg16_features(decoded_img, weights), target_ft):
            dist = dist + wasserstein_distortion(fa, fb)
        return dist

    return fn
