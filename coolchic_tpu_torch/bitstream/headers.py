"""Bit-level headers of the .cool bitstream format (video / frame / cool-chic).

Layout is normative; field order and widths mirror the reference
(coolchic/bitstream/header/header.py + element.py). Within each header the
subclass-specific fixed fields come first, then the 16-bit n_bytes_header,
then the variable-length fields; the byte payload is suffix-zero-padded.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from coolchic_tpu_torch.bitstream.bits import BitReader, BitWriter
from coolchic_tpu_torch.core.arch import CoolChicConfig

FRAME_TYPES = ("I", "P", "B")
FRAME_DATA_TYPES = ("rgb", "yuv420", "yuv444", "flow")
POSSIBLE_BITDEPTH = (8, 9, 10, 11, 12, 13, 14, 15, 16)
FINAL_UPSAMPLING_TYPES = ("nearest", "bilinear", "bicubic")
SYNTH_MODES = ("linear", "residual")
SYNTH_NON_LINEARITIES = ("none", "relu")

# Normative per-module quantization-step grids (power-of-two shifts) and
# exp-Golomb order grids, indexed in headers.
# (reference coolchic/nnquant/quantstep.py:20-45 and expgolomb.py:20-37)
Q_STEP_SHIFTS = {
    ("arm", "weight"): tuple(range(-8, 1)),
    ("arm", "bias"): tuple(range(-16, 1)),
    ("ifce", "weight"): tuple(range(-8, 1)),
    ("ifce", "bias"): tuple(range(-16, 1)),
    ("upsampling", "weight"): tuple(range(-12, 1)),
    ("upsampling", "bias"): (0,),
    ("synthesis", "weight"): tuple(range(-12, 1)),
    ("synthesis", "bias"): tuple(range(-24, 1)),
}
EXPGOL_COUNTS = tuple(range(13))
MODULE_ORDER = ("arm", "ifce", "upsampling", "synthesis")
WB_ORDER = ("weight", "bias")


# `tpu` bitstream profile container magic (docs/tpu_profile.md). A
# reference-format stream is headerless, so profile detection is by prefix.
TPU_PROFILE_MAGIC = b"CCTP\x01"


# ---------------------------------------------------------------------------
@dataclass
class VideoHeader:
    n_frames: int = 1
    intra_pos: tuple[int, ...] = (0,)
    p_pos: tuple[int, ...] = ()

    def to_bytes(self) -> bytes:
        w = BitWriter()
        w.write(self.n_frames, 12)
        w.write(len(self.intra_pos), 12)
        w.write(len(self.p_pos), 12)
        n_bits = w.n_bits() + 16 + 12 * (len(self.intra_pos) + len(self.p_pos))
        w.write((n_bits + 7) // 8, 16)
        for v in self.intra_pos:
            w.write(v, 12)
        for v in self.p_pos:
            w.write(v, 12)
        return w.append_pad_to_bytes()

    @classmethod
    def read(cls, data: bytes) -> tuple["VideoHeader", bytes]:
        r = BitReader(data)
        n_frames = r.read(12)
        n_intras = r.read(12)
        n_p = r.read(12)
        n_bytes_header = r.read(16)
        intra_pos = tuple(r.read(12) for _ in range(n_intras))
        p_pos = tuple(r.read(12) for _ in range(n_p))
        return cls(n_frames, intra_pos, p_pos), data[n_bytes_header:]


# ---------------------------------------------------------------------------
@dataclass
class FrameHeader:
    display_index: int
    frame_type: str  # I / P / B
    frame_data_type: str
    bitdepth: int
    index_references: tuple[int, ...] = ()
    global_flow: tuple[int, ...] = ()  # 2 signed ints per reference
    warp_filter_size: Optional[int] = None

    @property
    def n_refs(self) -> int:
        return {"I": 0, "P": 1, "B": 2}[self.frame_type]

    def to_bytes(self) -> bytes:
        w = BitWriter()
        w.write(self.display_index, 12)
        w.write(FRAME_TYPES.index(self.frame_type), 2)
        w.write(FRAME_DATA_TYPES.index(self.frame_data_type), 2)
        w.write(POSSIBLE_BITDEPTH.index(self.bitdepth), 4)
        n_refs = self.n_refs
        n_var_bits = 12 * n_refs + 14 * 2 * n_refs + (4 if n_refs else 0)
        n_bits = w.n_bits() + 16 + n_var_bits
        w.write((n_bits + 7) // 8, 16)
        for v in self.index_references:
            w.write(v, 12)
        for v in self.global_flow:
            w.write_signed(int(v), 14)
        if n_refs:
            w.write(self.warp_filter_size, 4)
        return w.append_pad_to_bytes()

    @classmethod
    def read(cls, data: bytes) -> tuple["FrameHeader", bytes]:
        r = BitReader(data)
        display_index = r.read(12)
        frame_type = FRAME_TYPES[r.read(2)]
        frame_data_type = FRAME_DATA_TYPES[r.read(2)]
        bitdepth = POSSIBLE_BITDEPTH[r.read(4)]
        n_bytes_header = r.read(16)
        n_refs = {"I": 0, "P": 1, "B": 2}[frame_type]
        refs = tuple(r.read(12) for _ in range(n_refs))
        flow = tuple(r.read_signed(14) for _ in range(2 * n_refs))
        warp = r.read(4) if n_refs else None
        hdr = cls(display_index, frame_type, frame_data_type, bitdepth, refs, flow, warp)
        return hdr, data[n_bytes_header:]


# ---------------------------------------------------------------------------
@dataclass
class CoolChicHeader:
    """Architecture + NN-codec side info of one cool-chic decoder."""

    img_size: tuple[int, int]
    layers_synthesis: tuple[str, ...]
    linear_stabiliser_synth: bool
    ups_k_size: int
    ups_preconcat_k_size: int
    output_feature_ifce: int
    spatial_context_arm: int
    linear_stabiliser_arm: bool
    n_hidden_layers_arm: int
    latent_resolution: tuple[int, int]
    n_latent_grids: int
    flag_common_randomness: bool
    final_upsampling_type: str
    ifce_resolution: Optional[tuple[int, int]] = None
    hyperlatent_resolution: Optional[tuple[int, int]] = None

    # {(module, wb): value}
    nn_q_step_shift: dict = field(default_factory=dict)
    nn_expgol_cnt: dict = field(default_factory=dict)
    nn_n_bytes: int = 0
    nn_n_bit_pad: int = 0
    n_bytes_latent: int = 0

    def to_bytes(self) -> bytes:
        w = BitWriter()
        w.write(int(self.linear_stabiliser_synth), 1)
        w.write(len(self.layers_synthesis), 3)
        w.write(self.ups_k_size, 4)
        w.write(self.ups_preconcat_k_size, 4)
        w.write(self.output_feature_ifce, 5)
        w.write(self.spatial_context_arm, 6)
        w.write(int(self.linear_stabiliser_arm), 1)
        w.write(self.n_hidden_layers_arm, 3)
        w.write(self.img_size[0], 14)
        w.write(self.img_size[1], 14)
        w.write(self.latent_resolution[0], 4)
        w.write(self.latent_resolution[1], 4)
        w.write(self.n_latent_grids, 5)
        w.write(int(self.hyperlatent_resolution is not None), 1)
        w.write(int(self.flag_common_randomness), 1)
        w.write(FINAL_UPSAMPLING_TYPES.index(self.final_upsampling_type), 2)
        for module in MODULE_ORDER:
            for wb in WB_ORDER:
                w.write(Q_STEP_SHIFTS[(module, wb)].index(
                    self.nn_q_step_shift[(module, wb)]), 5)
        for module in MODULE_ORDER:
            for wb in WB_ORDER:
                w.write(EXPGOL_COUNTS.index(self.nn_expgol_cnt[(module, wb)]), 4)
        w.write(self.nn_n_bytes, 14)
        w.write(self.nn_n_bit_pad, 3)
        w.write(self.n_bytes_latent, 28)

        n_var_bits = 0
        if self.output_feature_ifce > 0:
            n_var_bits += 8
        if self.hyperlatent_resolution is not None:
            n_var_bits += 8
        n_var_bits += 13 * len(self.layers_synthesis)
        n_bits = w.n_bits() + 16 + n_var_bits
        w.write((n_bits + 7) // 8, 16)

        if self.output_feature_ifce > 0:
            w.write(self.ifce_resolution[0], 4)
            w.write(self.ifce_resolution[1], 4)
        if self.hyperlatent_resolution is not None:
            w.write(self.hyperlatent_resolution[0], 4)
            w.write(self.hyperlatent_resolution[1], 4)
        for lay in self.layers_synthesis:
            out_ft, k_size, mode, nl = lay.split("-")
            w.write(int(out_ft), 7)
            w.write(int(k_size), 4)
            w.write(SYNTH_MODES.index(mode), 1)
            w.write(SYNTH_NON_LINEARITIES.index(nl), 1)
        return w.append_pad_to_bytes()

    @classmethod
    def read(cls, data: bytes) -> tuple["CoolChicHeader", bytes]:
        r = BitReader(data)
        linear_stabiliser_synth = bool(r.read(1))
        n_layer_synthesis = r.read(3)
        ups_k_size = r.read(4)
        ups_preconcat_k_size = r.read(4)
        output_feature_ifce = r.read(5)
        spatial_context_arm = r.read(6)
        linear_stabiliser_arm = bool(r.read(1))
        n_hidden_layers_arm = r.read(3)
        img_size = (r.read(14), r.read(14))
        latent_resolution = (r.read(4), r.read(4))
        n_latent_grids = r.read(5)
        flag_hyperlatent = bool(r.read(1))
        flag_common_randomness = bool(r.read(1))
        final_upsampling_type = FINAL_UPSAMPLING_TYPES[r.read(2)]
        nn_q_step_shift = {}
        for module in MODULE_ORDER:
            for wb in WB_ORDER:
                nn_q_step_shift[(module, wb)] = Q_STEP_SHIFTS[(module, wb)][r.read(5)]
        nn_expgol_cnt = {}
        for module in MODULE_ORDER:
            for wb in WB_ORDER:
                nn_expgol_cnt[(module, wb)] = EXPGOL_COUNTS[r.read(4)]
        nn_n_bytes = r.read(14)
        nn_n_bit_pad = r.read(3)
        n_bytes_latent = r.read(28)
        n_bytes_header = r.read(16)

        ifce_resolution = None
        if output_feature_ifce > 0:
            ifce_resolution = (r.read(4), r.read(4))
        hyperlatent_resolution = None
        if flag_hyperlatent:
            hyperlatent_resolution = (r.read(4), r.read(4))
        layers = []
        for _ in range(n_layer_synthesis):
            out_ft = r.read(7)
            k_size = r.read(4)
            mode = SYNTH_MODES[r.read(1)]
            nl = SYNTH_NON_LINEARITIES[r.read(1)]
            layers.append(f"{out_ft}-{k_size}-{mode}-{nl}")

        hdr = cls(
            img_size=img_size,
            layers_synthesis=tuple(layers),
            linear_stabiliser_synth=linear_stabiliser_synth,
            ups_k_size=ups_k_size,
            ups_preconcat_k_size=ups_preconcat_k_size,
            output_feature_ifce=output_feature_ifce,
            spatial_context_arm=spatial_context_arm,
            linear_stabiliser_arm=linear_stabiliser_arm,
            n_hidden_layers_arm=n_hidden_layers_arm,
            latent_resolution=latent_resolution,
            n_latent_grids=n_latent_grids,
            flag_common_randomness=flag_common_randomness,
            final_upsampling_type=final_upsampling_type,
            ifce_resolution=ifce_resolution,
            hyperlatent_resolution=hyperlatent_resolution,
            nn_q_step_shift=nn_q_step_shift,
            nn_expgol_cnt=nn_expgol_cnt,
            nn_n_bytes=nn_n_bytes,
            nn_n_bit_pad=nn_n_bit_pad,
            n_bytes_latent=n_bytes_latent,
        )
        return hdr, data[n_bytes_header:]

    # ------------------------------------------------------------------
    def to_config(self) -> CoolChicConfig:
        return CoolChicConfig(
            layers_synthesis=self.layers_synthesis,
            linear_stabiliser_synth=self.linear_stabiliser_synth,
            ups_k_size=self.ups_k_size,
            ups_preconcat_k_size=self.ups_preconcat_k_size,
            ifce_resolution=self.ifce_resolution,
            output_feature_ifce=self.output_feature_ifce,
            spatial_context_arm=self.spatial_context_arm,
            linear_stabiliser_arm=self.linear_stabiliser_arm,
            n_hidden_layers_arm=self.n_hidden_layers_arm,
            latent_resolution=self.latent_resolution,
            hyperlatent_resolution=self.hyperlatent_resolution,
            flag_common_randomness=self.flag_common_randomness,
            img_size=self.img_size,
            final_upsampling_type=self.final_upsampling_type,
        )

    @classmethod
    def from_config(cls, cfg: CoolChicConfig, **kw) -> "CoolChicHeader":
        return cls(
            img_size=cfg.img_size,
            layers_synthesis=tuple(cfg.layers_synthesis),
            linear_stabiliser_synth=cfg.linear_stabiliser_synth,
            ups_k_size=cfg.ups_k_size,
            ups_preconcat_k_size=cfg.ups_preconcat_k_size,
            output_feature_ifce=cfg.output_feature_ifce,
            spatial_context_arm=cfg.spatial_context_arm,
            linear_stabiliser_arm=cfg.linear_stabiliser_arm,
            n_hidden_layers_arm=cfg.n_hidden_layers_arm,
            latent_resolution=cfg.latent_resolution,
            n_latent_grids=cfg.n_latent_grids,
            flag_common_randomness=cfg.flag_common_randomness,
            final_upsampling_type=cfg.final_upsampling_type,
            ifce_resolution=cfg.ifce_resolution,
            hyperlatent_resolution=cfg.hyperlatent_resolution,
            **kw,
        )
