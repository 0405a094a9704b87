"""One complete Cool-Chic decoder-under-training as plain functions on
tensors.

forward = quantize latents -> ARM/IFCE rate -> learned upsampling ->
synthesis -> final rescale, differentiable end to end by autograd.

Every leaf of the parameter dict carries a leading batch axis of G images
(G = 1 for one image; the warm-up trains its candidates as G slots), and
each image owns its slot: the ops are batched matmuls, grouped convs and
elementwise ops, so one forward serves the whole batch. Noise is an input
(one [G, h, w] tensor per latent grid, in grid order), drawn by the caller.

Reference parity: CoolChicEncoder.forward and helpers
(coolchic/component/core/coolchic.py:261-758) and
coolchic_tpu/models/coolchic.py. The spatial-mesh resharding of the JAX
package is not ported.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Optional

import torch

from coolchic_tpu_torch.core.arch import CoolChicConfig
from coolchic_tpu_torch.core.laplace import rate_bits
from coolchic_tpu_torch.core.noise import common_randomness_grids
from coolchic_tpu_torch.core.quantizer import clip, quantize
from coolchic_tpu_torch.models.arm import (
    arm_apply,
    arm_init,
    arm_reparameterize,
    ifce_arm_index,
    ifce_init,
)
from coolchic_tpu_torch.models.synthesis import synthesis_apply, synthesis_init
from coolchic_tpu_torch.models.upsampling import (
    fixed_upsampling,
    upsampling_apply,
    upsampling_init,
)
from coolchic_tpu_torch.ops.context import spatial_context
from coolchic_tpu_torch.ops.resize import interpolate, interpolate_x2


class CoolChicOutput(NamedTuple):
    raw_out: torch.Tensor   # [G, C_out, H, W]
    rate: torch.Tensor      # [G, n_latents] rate in bits per latent
    latents: list           # quantized (decoder-side) latent grids, [G, h, w]


def coolchic_init(generator: torch.Generator, cfg: CoolChicConfig,
                  img_min_max: torch.Tensor | None = None,
                  device: torch.device | str = "cpu") -> dict:
    """One image's parameters (no batch axis), in the JAX package's layout.
    The random draws come from `generator`: the streams differ from the
    JAX package's PRNG, the distributions are the same."""
    params = {
        "latents": [torch.zeros(s, dtype=torch.float32, device=device)
                    for s in cfg.size_per_latent],
        "arm": arm_init(generator, cfg.total_context_arm, cfg.n_hidden_layers_arm,
                        stabiliser=cfg.linear_stabiliser_arm, device=device),
        "upsampling": upsampling_init(cfg.ups_k_size, cfg.ups_preconcat_k_size,
                                      cfg.n_ups, device=device),
        "synthesis": synthesis_init(generator, cfg, img_min_max, device=device),
    }
    if cfg.flag_ifce:
        params["ifce"] = ifce_init(generator, cfg.input_features_ifce,
                                   cfg.output_feature_ifce, device=device)
    return params


def quantize_latents(params: dict, cfg: CoolChicConfig, *,
                     noise: Optional[list[torch.Tensor]], quantizer_type: str,
                     soft_round_temperature, ac_max_val: int = -1
                     ) -> list[torch.Tensor]:
    """Encoder gain + quantization proxy per grid, in grid order. `noise`:
    one tensor per grid (the JAX package draws one per grid, in grid
    order), or None for zeros where the quantizer adds noise."""
    need_noise = quantizer_type in ("none", "softround")
    out = []
    for i, lat in enumerate(params["latents"]):
        x = lat * cfg.encoder_gain
        n = None
        if need_noise:
            n = noise[i] if noise is not None else torch.zeros_like(x)
        y = quantize(x, quantizer_type=quantizer_type, noise=n,
                     soft_round_temperature=soft_round_temperature)
        if ac_max_val != -1:
            y = clip(y, -ac_max_val, ac_max_val - 1)
        out.append(y)
    return out


def _nearest_pyramid(grids: list[torch.Tensor]) -> list[torch.Tensor]:
    """Intermediates of the nearest fixed upsampling of [G, h_i, w_i] grids
    (largest first): entry j is the [G, j, h, w] stack of the j smallest
    grids at the resolution of the j-th smallest (entry 0 is a zeros
    placeholder), coolchic_tpu/models/upsampling.py:fixed_upsampling."""
    rev = list(reversed(grids))
    acc = rev[0][:, None]
    intermediates = [torch.zeros_like(acc)]
    for target in rev[1:]:
        intermediates.append(acc)
        if acc.shape[-2:] != target.shape[-2:]:
            x = interpolate_x2(acc, "nearest")[..., : target.shape[-2], : target.shape[-1]]
        else:
            x = acc
        acc = torch.cat([target[:, None], x], dim=1)
    return intermediates


def ifce_context(params: dict, cfg: CoolChicConfig, grids: list[torch.Tensor]
                 ) -> torch.Tensor:
    """Inter-feature context for every latent pixel: [G, sum_i H_i*W_i, C_f].

    For grid i, the IFCE runs on the nearest-upsampled stack of already
    decoded (coarser) grids at one-level-coarser resolution, then the result
    is x2-nearest upsampled and cropped (reference coolchic.py:606-663)."""
    n = len(grids)
    G = grids[0].shape[0]
    intermediates = _nearest_pyramid(grids)
    arm_index = ifce_arm_index(cfg.input_features_ifce)
    chunks = []
    for i, grid in enumerate(grids):
        h_i, w_i = grid.shape[-2:]
        if cfg.input_features_ifce[i] > 0:
            already = intermediates[n - 1 - i]  # [G, c, h, w]
            c, h, w = already.shape[1:]
            flat = already.reshape(G, c, h * w).transpose(1, 2)  # [G, (h w), c]
            ctx = arm_apply(params["ifce"]["arms"][arm_index[i]], flat)
            ctx = ctx.transpose(1, 2).reshape(G, -1, h, w)
            ctx = interpolate_x2(ctx, "nearest")[..., :h_i, :w_i]
            chunks.append(ctx.reshape(G, -1, h_i * w_i).transpose(1, 2))
        else:
            chunks.append(grid.new_zeros((G, h_i * w_i, cfg.output_feature_ifce)))
    return torch.cat(chunks, dim=1)


def latent_rate(params: dict, cfg: CoolChicConfig, grids: list[torch.Tensor]
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-latent (rate_bits, mu, scale), each [G, n_latents], flattened over
    all grids in order."""
    G = grids[0].shape[0]
    flat_latent = torch.cat([g.reshape(G, -1) for g in grids], dim=1)
    ctx = torch.cat([spatial_context(g, cfg.spatial_context_arm) for g in grids], dim=1)
    if cfg.flag_ifce:
        ctx = torch.cat([ctx, ifce_context(params, cfg, grids)], dim=2)
    mu, scale = arm_reparameterize(arm_apply(params["arm"], ctx))
    return rate_bits(flat_latent, mu, scale), mu, scale


@lru_cache(maxsize=4)
def _cr_grids_np(sizes: tuple) -> tuple:
    # the normative generator runs in Python, ~1 s per 512x768 pyramid
    return tuple(common_randomness_grids(list(sizes)))


def make_cr_grids(cfg: CoolChicConfig, device: torch.device | str = "cpu"
                  ) -> Optional[list[torch.Tensor]]:
    """Deterministic common-randomness grids (largest first), or None."""
    if not cfg.flag_common_randomness:
        return None
    return [torch.tensor(g, device=device) for g in _cr_grids_np(cfg.size_per_latent_cr)]


def synthesis_input(cfg: CoolChicConfig, dense: torch.Tensor,
                    cr: Optional[list[torch.Tensor]],
                    no_cr: bool = False, only_cr: bool = False) -> torch.Tensor:
    """The synthesis input of G images: the dense latent stack [G, C, H, W],
    followed, with common randomness, by the bicubic-upsampled noise grids
    (shared by every image). no_cr zeroes the noise half, only_cr the
    latent half (coolchic_tpu/models/coolchic.py:synthesis_input)."""
    x = dense
    if cfg.flag_common_randomness:
        ups_noise = interpolate(fixed_upsampling(cr, mode="bicubic"), cfg.img_size,
                                "bicubic")
        ups_noise = ups_noise[None].expand(x.shape[0], *ups_noise.shape)
        if no_cr:
            ups_noise = ups_noise * 0
        if only_cr:
            x = x * 0
        x = torch.cat([x, ups_noise], dim=1)
    return x


def coolchic_forward(params: dict, cfg: CoolChicConfig, *,
                     noise: Optional[list[torch.Tensor]] = None,
                     quantizer_type: str = "softround",
                     soft_round_temperature=0.35,
                     training: bool = True,
                     ac_max_val: int = -1,
                     cr: Optional[list[torch.Tensor]] = None,
                     no_cr: bool = False, only_cr: bool = False) -> CoolChicOutput:
    """Batched forward (every params leaf [G, ...]). training=False is the
    decoder's view: hardround latents, no noise. `cr`: the common-randomness
    grids (make_cr_grids) when the config has them (--tune wasserstein)."""
    if not training:
        quantizer_type, noise = "hardround", None

    grids = quantize_latents(params, cfg, noise=noise, quantizer_type=quantizer_type,
                             soft_round_temperature=soft_round_temperature,
                             ac_max_val=ac_max_val)

    rate, _, _ = latent_rate(params, cfg, grids)

    # Hyperlatents are entropy-coded but do not feed the synthesis.
    syn_grids = [g for g, hyper in zip(grids, cfg.flag_is_hyperlatent) if not hyper]
    ups = params["upsampling"]
    dense = upsampling_apply(ups["tconv_half"], ups["conv_half"], syn_grids,
                             cfg.ups_k_size, cfg.ups_preconcat_k_size)
    syn_in = synthesis_input(cfg, dense, cr, no_cr=no_cr, only_cr=only_cr)
    syn_out = synthesis_apply(params["synthesis"], cfg.parsed_synthesis, syn_in)
    raw_out = interpolate(syn_out, cfg.img_size, cfg.final_upsampling_type)
    return CoolChicOutput(raw_out=raw_out, rate=rate, latents=grids)
