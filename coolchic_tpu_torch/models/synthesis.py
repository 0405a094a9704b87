"""Convolutional synthesis transform.

Small conv stack parsed from "<out>-<k>-<linear|residual>-<none|relu>" layer
specs, with replicate padding, an optional 1x1 linear stabiliser branch over
the non-common-randomness half of the input, and a frozen 1x1 output
transform.

Reference parity: coolchic/component/core/synthesis.py:18-370 and
coolchic_tpu/models/synthesis.py.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from coolchic_tpu_torch.core.arch import CoolChicConfig
from coolchic_tpu_torch.ops.convs import conv2d_replicate


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Synthesis(nn.Module):
    """One image's synthesis. Weights OIHW, biases [C_out]."""

    def __init__(self, cfg: CoolChicConfig, layers: list[dict],
                 output_transform: dict, stabiliser: dict | None = None):
        super().__init__()
        self.specs = cfg.parsed_synthesis
        self.weights = nn.ParameterList([_frozen(lay["weight"]) for lay in layers])
        self.biases = nn.ParameterList([_frozen(lay["bias"]) for lay in layers])
        self.ot_weight = _frozen(output_transform["weight"])
        self.ot_bias = _frozen(output_transform["bias"])
        self.stab_weight = None if stabiliser is None else _frozen(stabiliser["weight"])
        self.stab_bias = None if stabiliser is None else _frozen(stabiliser["bias"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[1, C_in, H, W] -> [1, C_out, H, W]."""
        return synthesis_batched([self], x)


def synthesis_batched(mods: list[Synthesis], x: torch.Tensor) -> torch.Tensor:
    """G images, each with its own Synthesis: [G, C_in, H, W] ->
    [G, C_out, H, W]."""
    m0 = mods[0]

    def wb(w, b):
        return {"weight": torch.stack(list(w)), "bias": torch.stack(list(b))}

    params = {
        "layers": [wb([m.weights[j] for m in mods], [m.biases[j] for m in mods])
                   for j in range(len(m0.specs))],
        "output_transform": wb([m.ot_weight for m in mods], [m.ot_bias for m in mods]),
    }
    if m0.stab_weight is not None:
        params["stabiliser"] = wb([m.stab_weight for m in mods],
                                  [m.stab_bias for m in mods])
    return synthesis_apply(params, m0.specs, x)


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
          edges: tuple[bool, bool] = (True, True)) -> torch.Tensor:
    """Per-image conv: x [G, C_in, H, W], w [G, C_out, C_in, k, k], b
    [G, C_out] -> [G, C_out, H', W], as one grouped conv (group g = image
    g), so the batch costs one launch per layer. `edges` (top, bottom):
    whether x's first / last row is the image's; only an image edge is
    replicate-padded, and an interior side loses (k - 1) // 2 rows of halo
    (H' = H at two edges)."""
    G, c_in = x.shape[:2]
    k = w.shape[-1]
    p = (k - 1) // 2
    x = x.reshape(1, G * c_in, *x.shape[-2:])
    if edges == (True, True):
        y = conv2d_replicate(x, w.reshape(-1, *w.shape[2:]), b.reshape(-1), padding=p,
                             groups=G)
    else:
        if p > 0:
            x = F.pad(x, (p, p, p * edges[0], p * edges[1]), mode="replicate")
        y = F.conv2d(x, w.reshape(-1, *w.shape[2:]), b.reshape(-1), groups=G)
    return y.reshape(G, -1, *y.shape[-2:])


def synthesis_halo(params: dict) -> int:
    """Rows of context the synthesis reads on each side of a row: the sum
    of (k - 1) // 2 over its convs."""
    return sum((lay["weight"].shape[-1] - 1) // 2 for lay in params["layers"])


def _rows(x: torch.Tensor, top: int, bottom: int) -> torch.Tensor:
    return x[..., top: x.shape[-2] - bottom, :]


def synthesis_apply(params: dict, specs, x: torch.Tensor,
                    edges: tuple[bool, bool] = (True, True)) -> torch.Tensor:
    """[G, C_in, H, W] -> [G, C_out, H, W] with per-image params (every leaf
    [G, ...]) in the JAX package's layout; `specs` is
    CoolChicConfig.parsed_synthesis. Differentiable in the params and x.

    `edges` (top, bottom) for a slab of rows of a larger image: an interior
    side carries synthesis_halo(params) rows of halo, which the convs use
    up (cropped after each conv); the output is the slab less its halos."""
    y = x
    cut = [0, 0]   # rows of x's halo used up so far, top and bottom
    for lay, (_, _, mode, non_linearity) in zip(params["layers"], specs):
        z = _conv(y, lay["weight"], lay["bias"], edges)
        p = (lay["weight"].shape[-1] - 1) // 2
        lost = (p * (not edges[0]), p * (not edges[1]))
        if mode == "residual":
            z = z + _rows(y, *lost)
        cut = [cut[0] + lost[0], cut[1] + lost[1]]
        if non_linearity == "relu":
            z = torch.relu(z)
        y = z

    if "stabiliser" in params:
        n_in_stab = params["stabiliser"]["weight"].shape[2]
        y = y + _conv(_rows(x[:, :n_in_stab], *cut), params["stabiliser"]["weight"],
                      params["stabiliser"]["bias"])

    ot = params["output_transform"]
    return _conv(y, ot["weight"], ot["bias"])


def _conv_init(generator: torch.Generator, in_ft: int, out_ft: int, k: int,
               residual: bool, device) -> dict:
    if residual:
        w = torch.zeros((out_ft, in_ft, k, k), dtype=torch.float32, device=device)
    else:
        sqrt_k = math.sqrt(1.0 / (in_ft * k * k))
        w = (torch.rand((out_ft, in_ft, k, k), generator=generator,
                        dtype=torch.float32, device=device) - 0.5) \
            * 2.0 * sqrt_k / out_ft**2
    return {"weight": w, "bias": torch.zeros((out_ft,), dtype=torch.float32,
                                             device=device)}


def output_transform_init(out_ft: int, img_min_max: torch.Tensor | None = None,
                          device: torch.device | str = "cpu") -> dict:
    """Identity 1x1 conv, or diag(max-min) + min when image stats are given."""
    if img_min_max is None:
        w = torch.eye(out_ft, dtype=torch.float32, device=device)
        b = torch.zeros((out_ft,), dtype=torch.float32, device=device)
    else:
        mm = torch.as_tensor(img_min_max, dtype=torch.float32, device=device)
        mn, mx = mm[:, 0], mm[:, 1]
        w = torch.diag(mx - mn)
        b = mn.clone()
    return {"weight": w.reshape(out_ft, out_ft, 1, 1), "bias": b}


def synthesis_init(generator: torch.Generator, cfg: CoolChicConfig,
                   img_min_max: torch.Tensor | None = None,
                   device: torch.device | str = "cpu") -> dict:
    """One image's synthesis params (coolchic_tpu/models/synthesis.py
    layout). Random draws come from `generator`: the streams differ from
    the JAX package's PRNG."""
    out_ft_final = cfg.synthesis_out_ft
    params: dict = {"output_transform": output_transform_init(out_ft_final,
                                                              img_min_max, device)}
    if cfg.linear_stabiliser_synth:
        n_in_stab = (cfg.input_feature_synthesis // 2 if cfg.flag_common_randomness
                     else cfg.input_feature_synthesis)
        params["stabiliser"] = _conv_init(generator, n_in_stab, out_ft_final, 1,
                                          False, device)
    layers = []
    in_ft = cfg.input_feature_synthesis
    for out_ft, k, mode, _ in cfg.parsed_synthesis:
        layers.append(_conv_init(generator, in_ft, out_ft, k, mode == "residual",
                                 device))
        in_ft = out_ft
    params["layers"] = layers
    return params
