"""Decoder complexity accounting (MAC / decoded pixel).

The reference measures this with fvcore on the eval-mode (separable) forward
(coolchic/component/core/coolchic.py:870-909); here the same counts are
derived analytically from the architecture, which is exact for conv/linear
layers (fvcore counts multiply-accumulates of those same ops).

Reference parity: coolchic_tpu/utils/complexity.py (the port's own copy).
"""

from __future__ import annotations

from coolchic_tpu_torch.core.arch import CoolChicConfig


def arm_macs(cfg: CoolChicConfig) -> int:
    """ARM MLP MACs over all latent pixels."""
    c = cfg.total_context_arm
    per_pixel = cfg.n_hidden_layers_arm * c * c + c * 2
    if cfg.linear_stabiliser_arm:
        per_pixel += c * 2
    n_latent_pixels = sum(h * w for h, w in cfg.size_per_latent)
    return per_pixel * n_latent_pixels


def ifce_macs(cfg: CoolChicConfig) -> int:
    """IFCE MACs: each active grid's linear ARM runs at one-level-coarser
    resolution (the nearest-upsampled already-decoded stack)."""
    total = 0
    for i, in_ft in enumerate(cfg.input_features_ifce):
        if in_ft == 0:
            continue
        # Computed at the resolution of the next coarser grid.
        if i + 1 < cfg.n_latent_grids:
            h, w = cfg.size_per_latent[i + 1]
        else:
            h, w = cfg.size_per_latent[i]
        total += h * w * in_ft * cfg.output_feature_ifce
    return total


def upsampling_macs(cfg: CoolChicConfig) -> int:
    """Eval-mode separable pyramid: each x2 step filters the accumulated
    stack with two 1-D passes of the tconv kernel, and pre-filters the
    higher-resolution grid with two 1-D passes of the preconcat kernel."""
    sizes = [s for s, hyper in zip(cfg.size_per_latent, cfg.flag_is_hyperlatent)
             if not hyper]
    total = 0
    n_ch = 1
    for idx in range(len(sizes) - 1, 0, -1):
        h_out, w_out = sizes[idx - 1]
        # tconv: intermediate width pass (h_in x 2w) then height pass (2h x 2w)
        h_in, w_in = sizes[idx]
        total += n_ch * cfg.ups_k_size * (h_in * 2 * w_in + 2 * h_in * 2 * w_in)
        # preconcat residual filter on the higher-resolution single grid
        total += 2 * cfg.ups_preconcat_k_size * h_out * w_out
        n_ch += 1
    return total


def synthesis_macs(cfg: CoolChicConfig) -> int:
    # Synthesis runs at the resolution of the largest (non-hyper) grid.
    sizes = [s for s, hyper in zip(cfg.size_per_latent, cfg.flag_is_hyperlatent)
             if not hyper]
    h, w = sizes[0]
    in_ft = cfg.input_feature_synthesis
    total = 0
    for out_ft, k, _, _ in cfg.parsed_synthesis:
        total += in_ft * out_ft * k * k * h * w
        in_ft = out_ft
    if cfg.linear_stabiliser_synth:
        n_in_stab = (cfg.input_feature_synthesis // 2 if cfg.flag_common_randomness
                     else cfg.input_feature_synthesis)
        total += n_in_stab * cfg.synthesis_out_ft * h * w
    total += cfg.synthesis_out_ft * cfg.synthesis_out_ft * h * w  # output transform
    return total


def macs_per_module(cfg: CoolChicConfig) -> dict[str, float]:
    n_pixels = cfg.img_size[0] * cfg.img_size[1]
    return {
        "arm": arm_macs(cfg) / n_pixels,
        "ifce": ifce_macs(cfg) / n_pixels,
        "upsampling": upsampling_macs(cfg) / n_pixels,
        "synthesis": synthesis_macs(cfg) / n_pixels,
    }


def total_mac_per_pixel(cfg: CoolChicConfig) -> float:
    return sum(macs_per_module(cfg).values())


def pretty_complexity(cfg: CoolChicConfig) -> str:
    per_module = macs_per_module(cfg)
    total = sum(per_module.values())
    s = ""
    for name, macs in per_module.items():
        share = 100 * macs / total if total else 0.0
        s += f"   - {name:<14} {macs:8.1f} MAC / pixel; {share:4.1f} % of the complexity\n"
    s += f"   - {'total':<14} {total:8.1f} MAC / pixel\n"
    return s
