"""Convolutional synthesis transform (forward).

Small conv stack parsed from "<out>-<k>-<linear|residual>-<none|relu>" layer
specs, with replicate padding, an optional 1x1 linear stabiliser branch over
the non-common-randomness half of the input, and a frozen 1x1 output
transform.

Reference parity: coolchic/component/core/synthesis.py:18-370 and
coolchic_tpu/models/synthesis.py.
"""

from __future__ import annotations

import torch
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
    [G, C_out, H, W]. The G images run as one grouped conv per layer (group
    g = image g), so the batch costs one launch per layer."""
    G = x.shape[0]
    m0 = mods[0]

    def conv(inp, ws, bs, k):
        c_in = inp.shape[1]
        w = torch.cat(list(ws), dim=0)                 # [G*C_out, C_in, k, k]
        b = torch.cat(list(bs), dim=0)
        y = conv2d_replicate(inp.reshape(1, G * c_in, *inp.shape[-2:]), w, b,
                             padding=(k - 1) // 2, groups=G)
        return y.reshape(G, -1, *y.shape[-2:])

    y = x
    for j, (_, k, mode, non_linearity) in enumerate(m0.specs):
        z = conv(y, [m.weights[j] for m in mods], [m.biases[j] for m in mods], k)
        if mode == "residual":
            z = z + y
        if non_linearity == "relu":
            z = torch.relu(z)
        y = z

    if m0.stab_weight is not None:
        n_in_stab = m0.stab_weight.shape[1]
        y = y + conv(x[:, :n_in_stab], [m.stab_weight for m in mods],
                     [m.stab_bias for m in mods], 1)

    return conv(y, [m.ot_weight for m in mods], [m.ot_bias for m in mods], 1)
