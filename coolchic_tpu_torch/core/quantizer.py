"""Differentiable quantization proxies used by the overfitting encoder.

Training-time quantizer family (reference:
coolchic/component/core/quantizer.py, coolchic_tpu/core/quantizer.py). The
bitstream path never uses these; only round() appears decoder-side.

Noise is an input: the caller draws it (sample_noise maps standard draws
to the noise family) and passes it in, so a forward is a pure function of
its tensors.
"""

from __future__ import annotations

import torch

QUANTIZER_NOISE_TYPES = ("kumaraswamy", "gaussian", "none")
QUANTIZER_TYPES = ("softround_alone", "softround", "hardround", "ste", "none")


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jnp.clip: min(max(x, lo), hi), whose gradient is split at equality
    (torch.clamp passes all of it). The bounds are filled on x's device:
    a tensor made from a Python number would be a host copy, which waits
    for the card."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)), x.new_full((), hi))


def _on_device(v, like: torch.Tensor) -> torch.Tensor:
    """A scalar parameter (Python number or tensor) as a tensor on like's
    device, without a host copy."""
    return v.to(like.dtype) if torch.is_tensor(v) else like.new_full((), v)


def softround(x: torch.Tensor, t) -> torch.Tensor:
    """Soft rounding of Agustsson & Theis (arXiv:2006.09952, sec. 4.1)."""
    t = _on_device(t, x)
    floor_x = torch.floor(x)
    delta = x - floor_x - 0.5
    return floor_x + 0.5 * torch.tanh(delta / t) / torch.tanh(1.0 / (2.0 * t)) + 0.5


def kumaraswamy_noise(uniform: torch.Tensor, a) -> torch.Tensor:
    """Map U(0,1) samples to a mode-centered Kumaraswamy noise in [-0.5, 0.5].

    ``a`` = 1 gives uniform noise; larger values concentrate around 0.
    (C3, Kim et al., arXiv:2312.02753.)
    """
    a = _on_device(a, uniform)
    b = (2.0**a * (a - 1.0) + 1.0) / a
    return (1.0 - (1.0 - uniform) ** (1.0 / b)) ** (1.0 / a) - 0.5


def sample_noise(shape: tuple[int, ...], noise_type: str, noise_parameter, *,
                 generator: torch.Generator, device: torch.device) -> torch.Tensor:
    """One draw of the training noise. `noise_parameter` is a scalar or a
    tensor broadcastable to `shape` (one value per batch slot)."""
    if noise_type == "none":
        return torch.zeros(shape, dtype=torch.float32, device=device)
    if noise_type == "gaussian":
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=device) * noise_parameter
    if noise_type == "kumaraswamy":
        u = torch.rand(shape, generator=generator, dtype=torch.float32, device=device)
        return kumaraswamy_noise(u, noise_parameter)
    raise ValueError(f"Unknown noise type {noise_type}")


def quantize(x: torch.Tensor, *, quantizer_type: str,
             noise: torch.Tensor | None = None,
             soft_round_temperature=None) -> torch.Tensor:
    """Apply the selected quantization proxy.

    - none:            x + n
    - softround_alone: softround(x, t)
    - softround:       softround(softround(x, t) + n, t)   (C3 style)
    - ste:             round(x) forward, softround(x, t) backward
    - hardround:       round(x)   (half to even, as jnp.round)
    """
    if quantizer_type == "none":
        return x + noise
    if quantizer_type == "softround_alone":
        return softround(x, soft_round_temperature)
    if quantizer_type == "softround":
        return softround(softround(x, soft_round_temperature) + noise,
                         soft_round_temperature)
    if quantizer_type == "ste":
        y = softround(x, soft_round_temperature)
        return y + (torch.round(x) - y).detach()
    if quantizer_type == "hardround":
        return torch.round(x)
    raise ValueError(f"Unknown quantizer type {quantizer_type}")
