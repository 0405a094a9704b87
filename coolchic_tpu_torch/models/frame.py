"""Frame-level model: one or two Cool-Chic decoders + motion compensation.

For an I frame the decoded image is the residue decoder's output; for P/B
frames the motion decoder produces optical flow(s) and the residue decoder
produces (residue, alpha[, beta]) so that

    P: x = alpha * warp(ref1, flow1) + residue
    B: x = alpha * (beta * warp(ref1, flow1) + (1-beta) * warp(ref2, flow2))
           + residue         (alpha, beta = clamp(raw + 0.5, 0, 1))

where each reference is first shifted by its integer global flow.

Batched like models/coolchic.py: every parameter leaf carries a leading
axis of G images.

Reference parity: coolchic/component/frame.py:96-352 and
coolchic_tpu/models/frame.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from coolchic_tpu_torch.core.arch import CoolChicConfig
from coolchic_tpu_torch.core.quantizer import clip
from coolchic_tpu_torch.models.coolchic import coolchic_forward, coolchic_init, make_cr_grids
from coolchic_tpu_torch.models.warp import shift_references, warp_fn


@dataclass(frozen=True)
class FrameConfig:
    """Static description of one frame-encoder (hashable)."""

    coolchic_cfg: Dict[str, CoolChicConfig] | Tuple[Tuple[str, CoolChicConfig], ...]
    frame_type: str = "I"
    frame_data_type: str = "rgb"
    bitdepth: int = 8
    index_references: Tuple[int, ...] = ()
    frame_display_index: int = 0
    warp_filter_size: int = 8

    def __post_init__(self):
        if isinstance(self.coolchic_cfg, dict):
            object.__setattr__(self, "coolchic_cfg", tuple(self.coolchic_cfg.items()))

    @property
    def cc_cfgs(self) -> Dict[str, CoolChicConfig]:
        return dict(self.coolchic_cfg)

    @property
    def n_refs(self) -> int:
        return {"I": 0, "P": 1, "B": 2}[self.frame_type]


class FrameEncoderOutput(NamedTuple):
    decoded_image: torch.Tensor | dict
    rate: Dict[str, torch.Tensor]
    # inter-frame intermediates for the detailed logs (reference
    # FrameEncoderOutput.additional_data, training/test.py:160-235):
    # {"alpha", "beta", "pred", "masked_pred", "residue", "flow_1",
    # "flow_2"}; None for I frames.
    additional_data: Optional[dict] = None


def frame_encoder_init(generator: torch.Generator, fcfg: FrameConfig,
                       img_min_max: Optional[torch.Tensor] = None,
                       device: torch.device | str = "cpu") -> dict:
    """One image's params: {"residue": <coolchic params>[, "motion": ...],
    "global_flow_1": [2], "global_flow_2": [2]} (the flows stay zero for I
    frames; the encoder sets them for P/B)."""
    params: dict = {}
    for name, cfg in fcfg.cc_cfgs.items():
        params[name] = coolchic_init(generator, cfg,
                                     img_min_max if name == "residue" else None,
                                     device=device)
    params["global_flow_1"] = torch.zeros((2,), dtype=torch.float32, device=device)
    params["global_flow_2"] = torch.zeros((2,), dtype=torch.float32, device=device)
    return params


def frame_cr_grids(fcfg: FrameConfig, device: torch.device | str = "cpu") -> dict:
    """{cc name: its common-randomness grids, or None}."""
    return {name: make_cr_grids(cfg, device) for name, cfg in fcfg.cc_cfgs.items()}


def _to_420(x: torch.Tensor) -> dict:
    b, c, h, w = x.shape
    y = x[:, 0:1]
    uv = x[:, 1:3].reshape(b, 2, h // 2, 2, w // 2, 2).mean(dim=(3, 5))
    return {"y": y, "u": uv[:, 0:1], "v": uv[:, 1:2]}


def frame_encoder_forward(params: dict, fcfg: FrameConfig, *,
                          reference_frames: Optional[list] = None,
                          noise: Optional[dict] = None,
                          quantizer_type: str = "softround",
                          soft_round_temperature=0.3,
                          training: bool = True,
                          ac_max_val: int = -1,
                          cr: Optional[dict] = None) -> FrameEncoderOutput:
    """Batched forward. `reference_frames`: for P/B, one [G, 3, H, W]
    tensor per reference (dense, 444 for yuv420), unshifted; `noise`: {cc
    name: [one tensor per grid]} or None; `cr`: frame_cr_grids' dict, or
    None. Returns the decoded image(s) [G, C, H, W] (a dict of planes for
    yuv420), clipped to [0, 1] (not for frame_data_type "flow"), and
    rounded to the bitdepth when not training."""
    cc_out = {}
    for name, cfg in fcfg.cc_cfgs.items():
        cc_out[name] = coolchic_forward(
            params[name], cfg, noise=None if noise is None else noise.get(name),
            quantizer_type=quantizer_type, soft_round_temperature=soft_round_temperature,
            training=training, ac_max_val=ac_max_val,
            cr=None if cr is None else cr.get(name))

    rate = {name: out.rate for name, out in cc_out.items()}
    additional = None
    if fcfg.frame_type == "I":
        decoded = cc_out["residue"].raw_out
    else:
        raw = cc_out["residue"].raw_out
        residue = raw[:, :3]
        alpha = clip(raw[:, 3:4] + 0.5, 0.0, 1.0)
        motion = cc_out["motion"].raw_out
        flow_1 = motion[:, 0:2]
        refs = shift_references(
            reference_frames, [params[f"global_flow_{i + 1}"]
                               for i in range(len(reference_frames))])
        fsize = fcfg.warp_filter_size
        if fcfg.frame_type == "P":
            pred = warp_fn(refs[0], flow_1, fsize, training=training)
            beta = flow_2 = None
        else:
            flow_2 = motion[:, 2:4]
            beta = clip(raw[:, 4:5] + 0.5, 0.0, 1.0)
            pred = beta * warp_fn(refs[0], flow_1, fsize, training=training) \
                + (1.0 - beta) * warp_fn(refs[1], flow_2, fsize, training=training)
        decoded = alpha * pred + residue
        additional = {"alpha": alpha, "beta": beta, "pred": pred,
                      "masked_pred": alpha * pred, "residue": residue,
                      "flow_1": flow_1, "flow_2": flow_2}

    if fcfg.frame_data_type == "yuv420":
        decoded = {k: clip(v, 0.0, 1.0) for k, v in _to_420(decoded).items()}
    elif fcfg.frame_data_type != "flow":
        decoded = clip(decoded, 0.0, 1.0)

    if not training:
        max_dyn = 2**fcfg.bitdepth - 1
        if fcfg.frame_data_type == "yuv420":
            decoded = {k: torch.round(v * max_dyn) / max_dyn for k, v in decoded.items()}
        else:
            decoded = torch.round(decoded * max_dyn) / max_dyn

    return FrameEncoderOutput(decoded_image=decoded, rate=rate, additional_data=additional)
