"""Frame-level model: the Cool-Chic decoder(s) of one frame.

For an I frame the decoded image is the residue decoder's output. P and B
frames (motion decoder, warping) are not ported yet.

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


def _intra_only(fcfg: FrameConfig) -> None:
    if fcfg.frame_type != "I":
        raise NotImplementedError(
            f"{fcfg.frame_type} frames are not encoded by the port yet (I only)")


def frame_encoder_init(generator: torch.Generator, fcfg: FrameConfig,
                       img_min_max: Optional[torch.Tensor] = None,
                       device: torch.device | str = "cpu") -> dict:
    """One image's params: {"residue": <coolchic params>, "global_flow_1":
    [2], "global_flow_2": [2]} (the flows stay zero for I frames)."""
    _intra_only(fcfg)
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
                          noise: Optional[dict] = None,
                          quantizer_type: str = "softround",
                          soft_round_temperature=0.3,
                          training: bool = True,
                          ac_max_val: int = -1,
                          cr: Optional[dict] = None) -> FrameEncoderOutput:
    """Batched I-frame forward. `noise`: {cc name: [one tensor per grid]}
    or None; `cr`: frame_cr_grids' dict, or None. Returns the decoded
    image(s) [G, C, H, W] (a dict of planes for yuv420), clipped to [0, 1],
    and rounded to the bitdepth when not training."""
    _intra_only(fcfg)
    cc_out = {}
    for name, cfg in fcfg.cc_cfgs.items():
        cc_out[name] = coolchic_forward(
            params[name], cfg, noise=None if noise is None else noise.get(name),
            quantizer_type=quantizer_type, soft_round_temperature=soft_round_temperature,
            training=training, ac_max_val=ac_max_val,
            cr=None if cr is None else cr.get(name))

    rate = {name: out.rate for name, out in cc_out.items()}
    decoded = cc_out["residue"].raw_out

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

    return FrameEncoderOutput(decoded_image=decoded, rate=rate)
