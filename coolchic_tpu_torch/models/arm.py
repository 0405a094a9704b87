"""Auto-Regressive entropy Model (ARM) and Inter-Feature Context Extractor
(IFCE), float version for training, as plain functions over parameter dicts.

Model definition (reference parity: coolchic/component/core/arm.py:22-417,
coolchic_tpu/models/arm.py):
  - trunk: n_hidden residual [C -> C] linear layers + ReLU, then a final
    [C -> 2] linear layer;
  - optional parallel linear stabiliser [C -> 2] added to the trunk output;
  - output reparameterization: mu = y[:, 0],
    b = exp(clamp(y[:, 1] - 4, -5, 5)).

The IFCE is a bank of zero-hidden-layer ARMs (one per latent grid in the IFCE
resolution range) mapping already-decoded coarser grids to extra context
features.

Parameter layout: dicts of torch-layout [out, in] weights, as in the JAX
package. The init functions build one image's parameters; arm_apply and
arm_reparameterize run on a leading batch axis of images (every leaf
[G, ...]). The decode runs the ARM and the IFCE in fixed point
(bitstream/tpu_cdf.py, the CUDA wavefront kernel and the host C++), not
here.
"""

from __future__ import annotations

import torch

from coolchic_tpu_torch.core.constants import ARM_LOG_SHIFT, LOG_SCALE_MAX, LOG_SCALE_MIN
from coolchic_tpu_torch.core.quantizer import clip


def _linear_init(generator: torch.Generator, in_ft: int, out_ft: int, residual: bool,
                 device: torch.device) -> dict:
    """ArmLinear init: zero bias; zero weight if residual else N(0, out^-4)."""
    if residual:
        w = torch.zeros((out_ft, in_ft), dtype=torch.float32, device=device)
    else:
        w = torch.randn((out_ft, in_ft), generator=generator, dtype=torch.float32,
                        device=device) / out_ft**2
    return {"weight": w, "bias": torch.zeros((out_ft,), dtype=torch.float32,
                                             device=device)}


def arm_init(generator: torch.Generator, dim_arm: int, n_hidden_layers: int,
             n_out: int = 2, stabiliser: bool = True,
             device: torch.device | str = "cpu") -> dict:
    layers = [_linear_init(generator, dim_arm, dim_arm, True, device)
              for _ in range(n_hidden_layers)]
    layers.append(_linear_init(generator, dim_arm, n_out, False, device))
    params = {"layers": layers}
    if stabiliser:
        params["stabiliser"] = _linear_init(generator, dim_arm, n_out, False, device)
    return params


def _linear(x: torch.Tensor, lay: dict) -> torch.Tensor:
    """[G, B, C_in] x [G, C_out, C_in] + [G, C_out] -> [G, B, C_out]."""
    return torch.baddbmm(lay["bias"][:, None, :], x, lay["weight"].transpose(1, 2))


def arm_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    """[G, B, C] contexts -> [G, B, n_out] raw outputs."""
    y = x
    layers = params["layers"]
    for lay in layers[:-1]:
        y = torch.relu(_linear(y, lay) + y)
    y = _linear(y, layers[-1])
    if "stabiliser" in params:
        y = y + _linear(x, params["stabiliser"])
    return y


def arm_reparameterize(raw: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Raw [..., 2] ARM output -> (mu, laplace scale)."""
    mu = raw[..., 0]
    log_scale = clip(raw[..., 1] + ARM_LOG_SHIFT, LOG_SCALE_MIN, LOG_SCALE_MAX)
    return mu, torch.exp(log_scale)


# ---------------------------------------------------------------------------
# IFCE
# ---------------------------------------------------------------------------
def ifce_init(generator: torch.Generator, input_features_ifce: tuple[int, ...],
              output_features_ifce: int, device: torch.device | str = "cpu") -> dict:
    """One linear ARM per latent grid with a non-zero input feature count;
    params["arms"][j] is the j-th active grid's (in grid order)."""
    return {"arms": [arm_init(generator, in_ft, 0, n_out=output_features_ifce,
                              stabiliser=False, device=device)
                     for in_ft in input_features_ifce if in_ft != 0]}


def ifce_arm_index(input_features_ifce: tuple[int, ...]) -> dict[int, int]:
    """Latent grid index -> index of its IFCE ARM (grids with no IFCE input
    features have none)."""
    mapping = {}
    internal = 0
    for i, in_ft in enumerate(input_features_ifce):
        if in_ft == 0:
            continue
        mapping[i] = internal
        internal += 1
    return mapping
