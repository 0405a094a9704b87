"""One complete Cool-Chic decoder-under-training as plain functions on
tensors.

forward = quantize latents -> ARM/IFCE rate -> learned upsampling ->
synthesis -> final rescale, differentiable end to end by autograd.

Every leaf of the parameter dict carries a leading batch axis of G images
(G = 1 for one image; the warm-up trains its candidates as G slots), and
each image owns its slot: the ops are batched matmuls, grouped convs and
elementwise ops, so one forward serves the whole batch. Noise is an input
(one [G, h, w] tensor per latent grid, in grid order), drawn by the caller.

With a `mesh` (parallel/batch.py:Mesh; every device of it is one "space"
shard) the forward splits ONE large image's rows over the devices, the
port of the JAX package's GSPMD spatial sharding
(coolchic_tpu/parallel/spatial.py, models/upsampling.py:_pin_spatial,
respread_spatial). The placement is explicit:
  - the parameters, the latents and their optimizer state stay whole on
    the mesh's first device (the JAX package shards the latents and their
    state; the numbers are the same either way, and at 2048x3072 the
    latents are ~34 MB beside gigabytes of activations);
  - quantization, the IFCE context and the upsampling pyramid run whole
    there too (the JAX package pins the pyramid replicated);
  - shard s computes the ARM rate of its rows [a_s, b_s) of every grid
    that split_rows() splits, from a slab with the 4 rows above that the
    causal 9x9 context reads, and the synthesis of its rows of the dense
    stack from a slab with synthesis_halo() rows on each interior side
    (replicate padding only at the image's top and bottom rows); a grid
    that does not split is rated whole on the first device, once;
  - the rates and the synthesis rows are concatenated back on the first
    device, where the final resize and everything after it run.
`.to()` is differentiable, so autograd carries the gradients back to the
whole leaves. A mesh may name one device several times (the tests' and a
one-card run's meshes): the copies are then no-ops. A slab's convs sum in
another order than the whole image's, so the sharded forward equals the
unsharded one to f32 rounding, not bit for bit.

Reference parity: CoolChicEncoder.forward and helpers
(coolchic/component/core/coolchic.py:261-758) and
coolchic_tpu/models/coolchic.py.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Optional, Sequence

import torch

from coolchic_tpu_torch.core.arch import CoolChicConfig
from coolchic_tpu_torch.core.constants import MAX_ARM_MASK_SIZE
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
from coolchic_tpu_torch.models.synthesis import (
    synthesis_apply,
    synthesis_halo,
    synthesis_init,
)
from coolchic_tpu_torch.models.upsampling import (
    fixed_upsampling,
    upsampling_apply,
    upsampling_init,
)
from coolchic_tpu_torch.ops.context import spatial_context
from coolchic_tpu_torch.ops.resize import interpolate, interpolate_x2
from coolchic_tpu_torch.train.params import tree_map

# Rows above a latent that its causal 9x9 ARM context reads.
CTX_ROWS = (MAX_ARM_MASK_SIZE - 1) // 2


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


def split_rows(h: int, n: int) -> bool:
    """Whether a latent grid of h rows splits over n space shards: the JAX
    package's placement rule (coolchic_tpu/parallel/spatial.py:46-47), h
    divisible by n with at least 4 rows a shard (thinner slabs would be
    all halo)."""
    return n > 1 and h % n == 0 and h // n >= 4


def _row_bounds(h: int, n: int, s: int) -> tuple[int, int]:
    return s * h // n, (s + 1) * h // n


def _on_devices(tree, devices: Sequence[torch.device]) -> dict:
    """{device: tree moved there} for each distinct device (differentiable
    copies; the tree itself on its own device)."""
    return {d: tree_map(lambda x: x.to(d), tree) for d in dict.fromkeys(devices)}


def _arm_rate(arm_params: dict, lat: torch.Tensor, ctx: torch.Tensor) -> torch.Tensor:
    mu, scale = arm_reparameterize(arm_apply(arm_params, ctx))
    return rate_bits(lat, mu, scale)


def latent_rate(params: dict, cfg: CoolChicConfig, grids: list[torch.Tensor],
                devices: Optional[Sequence[torch.device]] = None) -> torch.Tensor:
    """Per-latent rate_bits [G, n_latents], flattened over all grids in order,
    on the grids' device. With `devices` (a space mesh's) every split_rows
    grid is rated in row slabs, slab s on devices[s]; the other grids are
    rated whole, together, on the grids' device."""
    G, d0 = grids[0].shape[0], grids[0].device
    devices = [d0] if devices is None else list(devices)
    n = len(devices)
    ifce = ifce_context(params, cfg, grids) if cfg.flag_ifce else None
    arm_on = {d0: params["arm"]} if n == 1 else _on_devices(params["arm"], devices)
    pieces, whole, off = [], [], 0
    for g in grids:
        h, w = g.shape[-2:]
        ifce_g = None if ifce is None else ifce[:, off: off + h * w]
        off += h * w
        if not split_rows(h, n):
            ctx = spatial_context(g, cfg.spatial_context_arm)
            if ifce_g is not None:
                ctx = torch.cat([ctx, ifce_g], dim=2)
            whole.append((len(pieces), g.reshape(G, -1), ctx))
            pieces.append(None)
            continue
        parts = []
        for s, d in enumerate(devices):
            a, b = _row_bounds(h, n, s)
            a0 = max(a - CTX_ROWS, 0)
            slab = g[:, a0:b].to(d)
            ctx = spatial_context(slab, cfg.spatial_context_arm)[:, (a - a0) * w:]
            if ifce_g is not None:
                ctx = torch.cat([ctx, ifce_g[:, a * w: b * w].to(d)], dim=2)
            parts.append(_arm_rate(arm_on[d], slab[:, a - a0:].reshape(G, -1), ctx).to(d0))
        pieces.append(torch.cat(parts, dim=1))
    if whole:
        rate = _arm_rate(arm_on[d0], torch.cat([x[1] for x in whole], dim=1),
                         torch.cat([x[2] for x in whole], dim=1))
        start = 0
        for idx, lat, _ in whole:
            pieces[idx] = rate[:, start: start + lat.shape[1]]
            start += lat.shape[1]
    return torch.cat(pieces, dim=1)


def synthesis_sharded(params: dict, specs, x: torch.Tensor,
                      devices: Optional[Sequence[torch.device]] = None) -> torch.Tensor:
    """synthesis_apply of [G, C, H, W], with its rows split over `devices`
    (a space mesh's) when H divides evenly (the target's rule,
    parallel/spatial.py:shard_target), each slab with synthesis_halo rows on
    its interior sides; the rows come back concatenated on x's device."""
    h, n, d0 = x.shape[-2], 1 if devices is None else len(devices), x.device
    if n < 2 or h % n:
        return synthesis_apply(params, specs, x)
    halo = synthesis_halo(params)
    on = _on_devices(params, devices)
    rows = []
    for s, d in enumerate(devices):
        a, b = _row_bounds(h, n, s)
        a0, b0 = max(a - halo, 0), min(b + halo, h)
        y = synthesis_apply(on[d], specs, x[:, :, a0:b0].to(d), edges=(a0 == 0, b0 == h))
        start = a0 + (halo if a0 > 0 else 0)
        rows.append(y[:, :, a - start: b - start].to(d0))
    return torch.cat(rows, dim=2)


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
                     no_cr: bool = False, only_cr: bool = False,
                     mesh=None) -> CoolChicOutput:
    """Batched forward (every params leaf [G, ...]). training=False is the
    decoder's view: hardround latents, no noise. `cr`: the common-randomness
    grids (make_cr_grids) when the config has them (--tune wasserstein).
    `mesh`: split the image's rows over its devices (the module's
    docstring); its first device must hold the params."""
    if not training:
        quantizer_type, noise = "hardround", None
    devices = None if mesh is None else list(mesh.devices)

    grids = quantize_latents(params, cfg, noise=noise, quantizer_type=quantizer_type,
                             soft_round_temperature=soft_round_temperature,
                             ac_max_val=ac_max_val)

    rate = latent_rate(params, cfg, grids, devices)

    # Hyperlatents are entropy-coded but do not feed the synthesis.
    syn_grids = [g for g, hyper in zip(grids, cfg.flag_is_hyperlatent) if not hyper]
    ups = params["upsampling"]
    dense = upsampling_apply(ups["tconv_half"], ups["conv_half"], syn_grids,
                             cfg.ups_k_size, cfg.ups_preconcat_k_size)
    syn_in = synthesis_input(cfg, dense, cr, no_cr=no_cr, only_cr=only_cr)
    syn_out = synthesis_sharded(params["synthesis"], cfg.parsed_synthesis, syn_in,
                                devices)
    raw_out = interpolate(syn_out, cfg.img_size, cfg.final_upsampling_type)
    return CoolChicOutput(raw_out=raw_out, rate=rate, latents=grids)
