"""Frozen copy of the port's bitstream parsing: core/arch.py (CoolChicConfig),
bitstream/bits.py, expgolomb.py, headers.py and nncodec.py of coolchic_tpu_torch,
with tpu_cdf.arm8_from_int_layers below. It is copied, not imported, so that
the yardstick does not move when the program does; the range decoder, the
fixed-point ARM and the float tail that use it (decode.py) are written anew."""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Literal, Optional, Tuple

import numpy as np

# ---- copied from coolchic_tpu_torch/core/arch.py -------------------



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
# ---- copied from coolchic_tpu_torch/bitstream/bits.py --------------



class BitWriter:
    def __init__(self) -> None:
        self._bits: list[int] = []

    def write(self, value: int, n_bits: int) -> None:
        if value < 0 or value >= (1 << n_bits):
            raise ValueError(f"value {value} does not fit in {n_bits} bits")
        for i in range(n_bits - 1, -1, -1):
            self._bits.append((value >> i) & 1)

    def write_signed(self, value: int, n_bits: int) -> None:
        """Sign-magnitude: 1 sign bit + (n_bits - 1) magnitude bits."""
        self.write(1 if value < 0 else 0, 1)
        self.write(abs(value), n_bits - 1)

    def n_bits(self) -> int:
        return len(self._bits)

    def prepend_pad_to_bytes(self) -> tuple[bytes, int]:
        """Zero-pad at the FRONT to a whole number of bytes (exp-Golomb NN
        payload convention). Returns (bytes, n_padding_bits)."""
        pad = (8 - len(self._bits) % 8) % 8
        return self._pack([0] * pad + self._bits), pad

    def append_pad_to_bytes(self) -> bytes:
        """Zero-pad at the END to a whole number of bytes (header convention)."""
        pad = (8 - len(self._bits) % 8) % 8
        return self._pack(self._bits + [0] * pad)

    @staticmethod
    def _pack(bits: list[int]) -> bytes:
        out = bytearray(len(bits) // 8)
        for i, b in enumerate(bits):
            if b:
                out[i >> 3] |= 0x80 >> (i & 7)
        return bytes(out)


class BitReader:
    def __init__(self, data: bytes, skip_bits: int = 0) -> None:
        self._data = data
        self._pos = skip_bits

    def read(self, n_bits: int) -> int:
        v = 0
        for _ in range(n_bits):
            byte = self._data[self._pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self._pos & 7))) & 1)
            self._pos += 1
        return v

    def read_signed(self, n_bits: int) -> int:
        neg = self.read(1)
        mag = self.read(n_bits - 1)
        return -mag if neg else mag

    def read_unary_zeros(self) -> int:
        """Count zero bits until the next 1 (not consuming the 1)."""
        n = 0
        while True:
            byte = self._data[self._pos >> 3]
            bit = (byte >> (7 - (self._pos & 7))) & 1
            if bit:
                return n
            n += 1
            self._pos += 1
# ---- copied from coolchic_tpu_torch/bitstream/expgolomb.py ---------





def encode_exp_golomb(data: list[int] | np.ndarray, count: list[int] | np.ndarray
                      ) -> tuple[bytes, int]:
    """Returns (payload, n_padding_bits)."""
    data = np.asarray(data, dtype=np.int64)
    count = np.asarray(count, dtype=np.int64)
    if data.shape != count.shape:
        raise ValueError("data and count must have the same length")
    if count.size and count.min() < 0:
        raise ValueError("exp-Golomb order must be >= 0")

    w = BitWriter()
    for x, k in zip(data.tolist(), count.tolist()):
        u = -2 * x if x <= 0 else 2 * x - 1
        v = u + (1 << k) - 1
        n_bits_code = (v + 1).bit_length()
        # (n_bits_code - 1) leading zeros then binary(v+1), minus the first
        # k bits: v + 1 >= 2^k, so the removal only eats zeros.
        w.write(0, n_bits_code - 1 - k)
        w.write(v + 1, n_bits_code)
    return w.prepend_pad_to_bytes()


def decode_exp_golomb(data: bytes, n_padding_bits: int, count: list[int] | np.ndarray
                      ) -> np.ndarray:
    r = BitReader(data, skip_bits=n_padding_bits)
    out = np.empty(len(count), dtype=np.int64)
    for i, k in enumerate(np.asarray(count, dtype=np.int64).tolist()):
        n_zeros = r.read_unary_zeros()
        quotient = r.read(n_zeros + 1) - 1
        remainder = r.read(k) if k > 0 else 0
        u = (quotient << k) + remainder
        out[i] = (u + 1) // 2 if (u & 1) else -(u // 2)
    return out
# ---- copied from coolchic_tpu_torch/bitstream/headers.py -----------




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
# ---- copied from coolchic_tpu_torch/bitstream/nncodec.py -----------





# ---------------------------------------------------------------------------
# Parameter shape manifests (normative ordering).
# ---------------------------------------------------------------------------
def arm_param_shapes(cfg: CoolChicConfig) -> dict:
    dim = cfg.total_context_arm
    weights = [(dim, dim)] * cfg.n_hidden_layers_arm + [(2, dim)]
    biases = [(dim,)] * cfg.n_hidden_layers_arm + [(2,)]
    if cfg.linear_stabiliser_arm:
        weights.append((2, dim))
        biases.append((2,))
    return {"weight": weights, "bias": biases}


def ifce_param_shapes(cfg: CoolChicConfig) -> dict:
    weights, biases = [], []
    if cfg.flag_ifce:
        for in_ft in cfg.input_features_ifce:
            if in_ft == 0:
                continue
            weights.append((cfg.output_feature_ifce, in_ft))
            biases.append((cfg.output_feature_ifce,))
    return {"weight": weights, "bias": biases}


def upsampling_param_shapes(cfg: CoolChicConfig) -> dict:
    n = cfg.n_ups
    weights = [(half_param_size(cfg.ups_k_size),)] * n \
        + [(half_param_size(cfg.ups_preconcat_k_size),)] * n
    biases = [(1,)] * (2 * n)
    return {"weight": weights, "bias": biases}


def synthesis_param_shapes(cfg: CoolChicConfig) -> dict:
    out_ft_final = cfg.synthesis_out_ft
    weights = [(out_ft_final, out_ft_final, 1, 1)]  # output_transform
    biases = [(out_ft_final,)]
    if cfg.linear_stabiliser_synth:
        n_in_stab = (cfg.input_feature_synthesis // 2 if cfg.flag_common_randomness
                     else cfg.input_feature_synthesis)
        weights.append((out_ft_final, n_in_stab, 1, 1))
        biases.append((out_ft_final,))
    in_ft = cfg.input_feature_synthesis
    for out_ft, k, _, _ in cfg.parsed_synthesis:
        weights.append((out_ft, in_ft, k, k))
        biases.append((out_ft,))
        in_ft = out_ft
    return {"weight": weights, "bias": biases}


def module_param_shapes(cfg: CoolChicConfig, module: str) -> dict:
    return {
        "arm": arm_param_shapes,
        "ifce": ifce_param_shapes,
        "upsampling": upsampling_param_shapes,
        "synthesis": synthesis_param_shapes,
    }[module](cfg)


# ---------------------------------------------------------------------------
# Flatten / unflatten between the model param layout and the manifest order.
# ---------------------------------------------------------------------------
def flatten_module_params(params: dict, cfg: CoolChicConfig, module: str, wb: str
                          ) -> list[np.ndarray]:
    """The ordered list of weight (or bias) arrays of one module of a
    cool-chic param dict (models/*.py layouts), as numpy."""
    def a(x):
        return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)

    if module == "arm":
        arm = params["arm"]
        out = [a(lay[wb]) for lay in arm["layers"]]
        if cfg.linear_stabiliser_arm:
            out.append(a(arm["stabiliser"][wb]))
        return out
    if module == "ifce":
        if not cfg.flag_ifce:
            return []
        return [a(arm["layers"][0][wb]) for arm in params["ifce"]["arms"]]
    if module == "upsampling":
        ups = params["upsampling"]
        if wb == "weight":
            return [a(v) for v in ups["tconv_half"] + ups["conv_half"]]
        return [a(v) for v in ups["tconv_bias"] + ups["conv_bias"]]
    if module == "synthesis":
        syn = params["synthesis"]
        out = [a(syn["output_transform"][wb])]
        if cfg.linear_stabiliser_synth:
            out.append(a(syn["stabiliser"][wb]))
        out.extend(a(lay[wb]) for lay in syn["layers"])
        return out
    raise ValueError(module)


def unflatten_module_params(arrays: list[np.ndarray], cfg: CoolChicConfig, module: str,
                            wb: str, into: dict) -> None:
    """Writes manifest-ordered arrays of one module into the param dict."""
    it = iter(arrays)
    if module == "arm":
        arm = into.setdefault("arm", {"layers": [
            {} for _ in range(cfg.n_hidden_layers_arm + 1)]})
        for lay in arm["layers"]:
            lay[wb] = next(it)
        if cfg.linear_stabiliser_arm:
            arm.setdefault("stabiliser", {})[wb] = next(it)
    elif module == "ifce":
        if not cfg.flag_ifce:
            return
        n_active = sum(1 for f in cfg.input_features_ifce if f > 0)
        ifce = into.setdefault("ifce", {"arms": [{"layers": [{}]} for _ in range(n_active)]})
        for a in ifce["arms"]:
            a["layers"][0][wb] = next(it)
    elif module == "upsampling":
        n = cfg.n_ups
        ups = into.setdefault("upsampling", {})
        arrays = list(it)
        if wb == "weight":
            ups["tconv_half"] = arrays[:n]
            ups["conv_half"] = arrays[n:]
        else:
            ups["tconv_bias"] = arrays[:n]
            ups["conv_bias"] = arrays[n:]
    elif module == "synthesis":
        syn = into.setdefault("synthesis", {"output_transform": {}, "layers": [
            {} for _ in cfg.parsed_synthesis]})
        syn["output_transform"][wb] = next(it)
        if cfg.linear_stabiliser_synth:
            syn.setdefault("stabiliser", {})[wb] = next(it)
        for lay in syn["layers"]:
            lay[wb] = next(it)
    else:
        raise ValueError(module)


# ---------------------------------------------------------------------------
# Encode / decode
# ---------------------------------------------------------------------------
def encode_network(params: dict, cfg: CoolChicConfig, q_step_shift: dict,
                   expgol_cnt: dict) -> tuple[bytes, int]:
    """Quantize + exp-Golomb all four modules. Returns (payload, n_pad_bits).

    q_step_shift / expgol_cnt: {(module, "weight"|"bias"): value}.
    """
    all_q: list[int] = []
    all_cnt: list[int] = []
    for module in MODULE_ORDER:
        for wb in WB_ORDER:
            arrays = flatten_module_params(params, cfg, module, wb)
            if not arrays:
                continue
            q_step = 2.0 ** q_step_shift[(module, wb)]
            flat = np.concatenate([a.reshape(-1) for a in arrays]).astype(np.float64)
            q = np.round(flat / q_step).astype(np.int64)
            all_q.extend(q.tolist())
            all_cnt.extend([expgol_cnt[(module, wb)]] * q.size)
    return encode_exp_golomb(all_q, all_cnt)


def decode_network(payload: bytes, cfg: CoolChicConfig, q_step_shift: dict,
                   expgol_cnt: dict, n_pad_bits: int) -> dict:
    """Decode NN parameters. Returns a model param dict (numpy arrays):
    int64 for arm/ifce (fed to the fixed-point path), float32 (dequantized)
    for upsampling/synthesis."""
    manifests = {m: module_param_shapes(cfg, m) for m in MODULE_ORDER}
    counts: list[int] = []
    for module in MODULE_ORDER:
        for wb in WB_ORDER:
            n = sum(int(np.prod(s)) for s in manifests[module][wb])
            counts.extend([expgol_cnt[(module, wb)]] * n)

    values = decode_exp_golomb(payload, n_pad_bits, counts)

    out: dict = {}
    ptr = 0
    for module in MODULE_ORDER:
        for wb in WB_ORDER:
            arrays = []
            for shape in manifests[module][wb]:
                n = int(np.prod(shape))
                chunk = values[ptr:ptr + n].reshape(shape)
                ptr += n
                if module in ("arm", "ifce"):
                    arrays.append(chunk.astype(np.int64))
                else:
                    q_step = 2.0 ** q_step_shift[(module, wb)]
                    arrays.append((chunk.astype(np.float64) * q_step).astype(np.float32))
            unflatten_module_params(arrays, cfg, module, wb, out)
    return out

def half_param_size(target_k_size: int) -> int:
    return (target_k_size + 1) // 2

# ---- copied from coolchic_tpu_torch/bitstream/tpu_cdf.py ------------
ARM8_WEIGHT_SHIFT = 8
ARM8_BIAS_SHIFT = 16


def arm8_from_int_layers(int_layers, q_shift_weight, q_shift_bias, *,
                         stabiliser=None, subtract_last_layer=True,
                         n_inter_ft_ctx=0, no_residual_layer=False) -> dict:
    """Quantized integer params -> X.8 fixed point (same folding rules as
    bitstream.fixedpoint.arm_to_fixed_point with 8-bit scales).

    Unlike the X.16 reference pipeline (which feeds IFCE context columns
    pre-scaled by 2^8 and compensates with 8 fewer weight bits), the X.8
    pipeline feeds IFCE columns RAW (their X.8 payload IS the activation
    scale) and spatial columns << 8 -- so every weight column uses the same
    uniform X.8 representation and stays an exact integer for the normative
    q-step grids (q_shift_weight >= -8). n_inter_ft_ctx is accepted for call
    compatibility but needs no weight special-casing here."""
    assert q_shift_weight >= -ARM8_WEIGHT_SHIFT
    assert q_shift_bias >= -ARM8_BIAS_SHIFT
    del n_inter_ft_ctx
    trunk_w, trunk_b = [], []
    n_layers = len(int_layers)
    for li, lay in enumerate(int_layers):
        is_last = li == n_layers - 1
        wq = np.asarray(lay["weight"], dtype=np.int64)
        bq = np.asarray(lay["bias"], dtype=np.int64).copy()
        if is_last and subtract_last_layer:
            bq[1] += -(4 << (-q_shift_bias))
        w_fp = wq * (np.int64(1) << np.int64(ARM8_WEIGHT_SHIFT + q_shift_weight))
        if wq.shape[0] == wq.shape[1] and not no_residual_layer:
            w_fp = w_fp + np.eye(wq.shape[0], dtype=np.int64) * (
                np.int64(1) << np.int64(ARM8_WEIGHT_SHIFT))
        trunk_w.append(w_fp.T.astype(np.int64).copy())
        trunk_b.append((bq * (np.int64(1) << np.int64(ARM8_BIAS_SHIFT + q_shift_bias))
                        ).astype(np.int64))
    dim = int_layers[0]["weight"].shape[1]
    n_out = int_layers[-1]["weight"].shape[0]
    if stabiliser is not None:
        sw = np.asarray(stabiliser["weight"], dtype=np.int64)
        stab_w = (sw * (np.int64(1) << np.int64(ARM8_WEIGHT_SHIFT + q_shift_weight))
                  ).T.copy()
        stab_b = (np.asarray(stabiliser["bias"], dtype=np.int64)
                  * (np.int64(1) << np.int64(ARM8_BIAS_SHIFT + q_shift_bias)))
    else:
        stab_w = np.zeros((dim, n_out), dtype=np.int64)
        stab_b = np.zeros((n_out,), dtype=np.int64)
    return {"trunk_weights": trunk_w, "trunk_biases": trunk_b,
            "stab_weight": stab_w, "stab_bias": stab_b}


