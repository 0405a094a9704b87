"""Architecture description of one Cool-Chic decoder (a.k.a. CoolChicConfig).

This is the static, hashable configuration every jitted function closes over.
It derives all per-resolution latent sizes, hyperlatent flags, IFCE wiring and
synthesis input width from the user-facing parameters.

Reference parity: CoolChicEncoderParameter.__post_init__ and its post_init_*
helpers (coolchic/component/core/coolchic.py:52-242).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Literal, Optional, Tuple

FinalUpsampling = Literal["nearest", "bilinear", "bicubic"]


def _parse_synth_layer(layer: str) -> Tuple[int, int, str, str]:
    """"<out_ft>-<k_size>-<linear|residual>-<none|relu>" -> tuple."""
    out_ft, k_size, mode, non_linearity = layer.split("-")
    if mode not in ("linear", "residual"):
        raise ValueError(f"Unknown synthesis mode {mode}")
    if non_linearity not in ("none", "relu"):
        raise ValueError(f"Unknown synthesis non-linearity {non_linearity}")
    return int(out_ft), int(k_size), mode, non_linearity


@dataclass(frozen=True)
class CoolChicConfig:
    """Static architecture of one Cool-Chic decoder ("residue" or "motion")."""

    # Synthesis
    layers_synthesis: Tuple[str, ...]
    linear_stabiliser_synth: bool

    # Upsampling
    ups_k_size: int
    ups_preconcat_k_size: int

    # Entropy model
    ifce_resolution: Optional[Tuple[int, int]]
    output_feature_ifce: int
    spatial_context_arm: int
    linear_stabiliser_arm: bool
    n_hidden_layers_arm: int

    # Latent / hyperlatent pyramids
    latent_resolution: Tuple[int, int]
    hyperlatent_resolution: Optional[Tuple[int, int]]
    flag_common_randomness: bool

    # Frame
    img_size: Tuple[int, int]
    final_upsampling_type: FinalUpsampling = "bicubic"
    encoder_gain: int = 16

    # --- Derived (filled in __post_init__) ---
    size_per_latent: Tuple[Tuple[int, int], ...] = field(init=False)
    size_per_latent_cr: Tuple[Tuple[int, int], ...] = field(init=False)
    flag_is_hyperlatent: Tuple[bool, ...] = field(init=False)
    input_features_ifce: Tuple[int, ...] = field(init=False)
    n_latent_grids: int = field(init=False)
    total_context_arm: int = field(init=False)
    input_feature_synthesis: int = field(init=False)
    flag_ifce: bool = field(init=False)
    flag_hyperlatent: bool = field(init=False)

    def __post_init__(self):
        h, w = self.img_size

        def grid_size(i: int) -> Tuple[int, int]:
            return (math.ceil(h / 2**i), math.ceil(w / 2**i))

        flag_hyper = self.hyperlatent_resolution is not None
        if flag_hyper:
            lo = min(self.latent_resolution + self.hyperlatent_resolution)
            hi = max(self.latent_resolution + self.hyperlatent_resolution)
        else:
            lo, hi = self.latent_resolution

        sizes: list[Tuple[int, int]] = []
        is_hyper: list[bool] = []
        for i in range(lo, hi + 1):
            if self.latent_resolution[0] <= i <= self.latent_resolution[1]:
                sizes.append(grid_size(i))
                is_hyper.append(False)
            if flag_hyper and (
                self.hyperlatent_resolution[0] <= i <= self.hyperlatent_resolution[1]
            ):
                sizes.append(grid_size(i))
                is_hyper.append(True)

        cr_sizes: list[Tuple[int, int]] = []
        if self.flag_common_randomness:
            for i in range(self.latent_resolution[0], self.latent_resolution[1] + 1):
                cr_sizes.append(grid_size(i))

        n_grids = len(sizes)
        flag_ifce = self.ifce_resolution is not None
        in_ft_ifce: list[int] = []
        for size_i in sizes:
            downsampling_ratio = int(math.ceil(math.log2(h / size_i[0])))
            if not flag_ifce:
                in_ft_ifce.append(0)
            elif self.ifce_resolution[0] <= downsampling_ratio <= self.ifce_resolution[1]:
                in_ft_ifce.append(max(n_grids - 1 - len(in_ft_ifce), 1))
            else:
                in_ft_ifce.append(0)

        n_syn_in = self.latent_resolution[1] - self.latent_resolution[0] + 1
        if self.flag_common_randomness:
            n_syn_in *= 2

        object.__setattr__(self, "size_per_latent", tuple(sizes))
        object.__setattr__(self, "size_per_latent_cr", tuple(cr_sizes))
        object.__setattr__(self, "flag_is_hyperlatent", tuple(is_hyper))
        object.__setattr__(self, "input_features_ifce", tuple(in_ft_ifce))
        object.__setattr__(self, "n_latent_grids", n_grids)
        object.__setattr__(
            self, "total_context_arm", self.spatial_context_arm + self.output_feature_ifce
        )
        object.__setattr__(self, "input_feature_synthesis", n_syn_in)
        object.__setattr__(self, "flag_ifce", flag_ifce)
        object.__setattr__(self, "flag_hyperlatent", flag_hyper)

    # Convenience ----------------------------------------------------------
    @property
    def n_ups(self) -> int:
        # One (tconv, preconcat) kernel pair per x2 step from 2^-hi to 2^0.
        return self.latent_resolution[1]

    @property
    def parsed_synthesis(self) -> Tuple[Tuple[int, int, str, str], ...]:
        return tuple(_parse_synth_layer(s) for s in self.layers_synthesis)

    @property
    def synthesis_out_ft(self) -> int:
        return self.parsed_synthesis[-1][0]
