"""Frame / video level bitstream writing (I, P and B frames).

Parameters arrive quantized (nnquant/quantize.py) as numpy arrays in the
model layout. The latents are range-coded by the host C++ coder in either
profile (bitstream/codec.py:encode_coolchic_latents).

Reference parity: coolchic/bitstream/encode.py and
coolchic_tpu/bitstream/encode.py.
"""

from __future__ import annotations

import numpy as np

from coolchic_tpu_torch.bitstream.codec import encode_coolchic_latents
from coolchic_tpu_torch.bitstream.headers import (
    TPU_PROFILE_MAGIC,
    CoolChicHeader,
    FrameHeader,
    VideoHeader,
)
from coolchic_tpu_torch.bitstream.nncodec import (
    encode_network,
    flatten_module_params,
    unflatten_module_params,
)
from coolchic_tpu_torch.core.arch import CoolChicConfig
from coolchic_tpu_torch.core.constants import AC_MAX_VAL
from coolchic_tpu_torch.models.frame import FrameConfig
from coolchic_tpu_torch.utils.codingstructure import CodingStructure


def _int_arm_params(cc_params: dict, cfg: CoolChicConfig, q_shift: dict) -> dict:
    """Integer (round(param / q_step)) ARM + IFCE params for the fixed-point
    path, in the decode_network output layout."""
    out: dict = {}
    for module in ("arm", "ifce"):
        for wb in ("weight", "bias"):
            arrays = flatten_module_params(cc_params, cfg, module, wb)
            if not arrays:
                continue
            q = 2.0 ** q_shift[(module, wb)]
            ints = [np.round(np.asarray(a, dtype=np.float64) / q).astype(np.int64)
                    for a in arrays]
            unflatten_module_params(ints, cfg, module, wb, out)
    return out


def encode_coolchic(cc_params: dict, cfg: CoolChicConfig, q_shift: dict, expgol: dict,
                    profile: str = "ref") -> bytes:
    """One cool-chic decoder -> [CoolChicHeader || NN bytes || latent bytes]."""
    bytes_nn, n_pad = encode_network(cc_params, cfg, q_shift, expgol)

    # Hardround + gain + clamp, as written to the bitstream.
    quantized_latents = [
        np.clip(np.round(np.asarray(lat, dtype=np.float32) * cfg.encoder_gain),
                -AC_MAX_VAL, AC_MAX_VAL - 1).astype(np.int64)
        for lat in cc_params["latents"]
    ]

    header = CoolChicHeader.from_config(
        cfg, nn_q_step_shift=dict(q_shift), nn_expgol_cnt=dict(expgol),
        nn_n_bytes=len(bytes_nn), nn_n_bit_pad=n_pad, n_bytes_latent=0)

    nn_int = _int_arm_params(cc_params, cfg, q_shift)
    bytes_latent = encode_coolchic_latents(header, nn_int, quantized_latents,
                                           profile=profile)
    return header.to_bytes() + bytes_nn + bytes_latent


def encode_frame(frame_params: dict, fcfg: FrameConfig, coding_structure: CodingStructure,
                 nn_side_info: dict, is_first_frame: bool = True,
                 profile: str = "ref") -> bytes:
    """Serialize one frame: [magic, video header if first] frame header
    (with a P/B frame's rounded global flows and warp filter size), then
    the residue cool-chic and, for P/B, the motion cool-chic.

    nn_side_info: {cc_name: (q_shift dict, expgol dict)} from quantize_coolchic.
    profile: "ref" = reference bit-compatible; "tpu" = parallel-stream latent
    payloads inside a CCTP container (docs/tpu_profile.md).
    """
    out = b""
    if is_first_frame and profile == "tpu":
        out += TPU_PROFILE_MAGIC
    if is_first_frame:
        out += VideoHeader(
            n_frames=coding_structure.n_frames,
            intra_pos=tuple(coding_structure.intra_pos),
            p_pos=tuple(coding_structure.p_pos),
        ).to_bytes()

    gflow = []
    for i in range({"I": 0, "P": 1, "B": 2}[fcfg.frame_type]):
        gflow += [int(v) for v in np.asarray(frame_params[f"global_flow_{i + 1}"]).round()]

    out += FrameHeader(
        display_index=fcfg.frame_display_index,
        frame_type=fcfg.frame_type,
        frame_data_type=fcfg.frame_data_type,
        bitdepth=fcfg.bitdepth,
        index_references=tuple(fcfg.index_references),
        global_flow=tuple(gflow),
        warp_filter_size=fcfg.warp_filter_size if fcfg.frame_type != "I" else None,
    ).to_bytes()

    for name in ["residue"] + (["motion"] if fcfg.frame_type != "I" else []):
        q_shift, expgol = nn_side_info[name]
        out += encode_coolchic(frame_params[name], fcfg.cc_cfgs[name], q_shift, expgol,
                               profile=profile)
    return out
