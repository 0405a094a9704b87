"""Frame / video level bitstream decoding (I, P and B frames).

A P/B frame decodes its residue and motion cool-chics (in the `tpu`
profile both go through the batched device decode), shifts its decoded
references by the header's integer global flows, warps them on the device
by the decoded flows and blends: x = alpha * pred + residue.

Reference parity: coolchic/bitstream/decode.py and
coolchic_tpu/bitstream/decode.py.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from coolchic_tpu_torch.bitstream.codec import decode_coolchic, decode_coolchic_tpu_host
from coolchic_tpu_torch.bitstream.headers import (
    TPU_PROFILE_MAGIC,
    CoolChicHeader,
    FrameHeader,
    VideoHeader,
)
from coolchic_tpu_torch.core.device import resolve_device
from coolchic_tpu_torch.io.framedata import FrameData
from coolchic_tpu_torch.io.yuv import convert_420_to_444, convert_444_to_420, yuv_dict_clamp
from coolchic_tpu_torch.models.warp import apply_global_translation, warp_fn
from coolchic_tpu_torch.utils import trace
from coolchic_tpu_torch.utils.codingstructure import CodingStructure


def decode_frame(bitstream: bytes, reference_frames: Optional[list[FrameData]] = None,
                 profile: str = "ref", device: str | torch.device = "cuda",
                 routes: Optional[list] = None) -> tuple[FrameData, bytes]:
    """Decode one frame (a P/B frame from its decoded `reference_frames`);
    returns it and the rest of the bitstream. `routes`, when given, gains
    the `tpu`-profile route record of each cool-chic's group (see
    _decode_items_batched) with its "cc" name and "display_index"."""
    device = resolve_device(device)
    frame_header, bitstream = FrameHeader.read(bitstream)
    frame_type = frame_header.frame_type
    names = ["residue"] + (["motion"] if frame_type in ("P", "B") else [])
    items = []
    for _ in names:
        cc_header, bitstream = CoolChicHeader.read(bitstream)
        bytes_nn = bitstream[:cc_header.nn_n_bytes]
        bitstream = bitstream[cc_header.nn_n_bytes:]
        bytes_latent = bitstream[:cc_header.n_bytes_latent]
        bitstream = bitstream[cc_header.n_bytes_latent:]
        items.append((cc_header, bytes_nn, bytes_latent))
    if profile == "tpu":
        outputs, recs = _decode_items_batched(items, device)
        for r in recs:
            if routes is not None:
                routes.append({**r, "cc": [names[i] for i in r["items"]],
                               "display_index": frame_header.display_index})
    else:
        outputs = [decode_coolchic(*item, profile=profile, device=device) for item in items]
    cc_out = {name: raw for name, (raw, _) in zip(names, outputs)}

    if frame_type == "I":
        decoded = cc_out["residue"]
    else:
        if frame_header.frame_data_type == "yuv420":
            raw_refs = [convert_420_to_444(r.data) for r in reference_frames]
        else:
            raw_refs = [np.asarray(r.data) for r in reference_frames]
        flows = np.asarray(frame_header.global_flow, dtype=np.float32)
        shifted = apply_global_translation(
            raw_refs, [flows[2 * i:2 * i + 2] for i in range(frame_header.n_refs)])

        def dev(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        res, mot = dev(cc_out["residue"]), dev(cc_out["motion"])
        fsize = frame_header.warp_filter_size
        with torch.no_grad():
            alpha = torch.clamp(res[:, 3:4] + 0.5, 0.0, 1.0)
            pred = warp_fn(dev(shifted[0]), mot[:, 0:2], fsize)
            if frame_type == "B":
                beta = torch.clamp(res[:, 4:5] + 0.5, 0.0, 1.0)
                pred = beta * pred + (1 - beta) * warp_fn(dev(shifted[1]), mot[:, 2:4], fsize)
            decoded = (alpha * pred + res[:, :3]).cpu().numpy()

    return _finish_frame(decoded, frame_header.bitdepth,
                         frame_header.frame_data_type), bitstream


@trace.spanned("decode.finish")
def _finish_frame(decoded: np.ndarray, bitdepth: int,
                  frame_data_type: str) -> FrameData:
    """Bitdepth rounding + 444->420 tail shared by single and batched decode
    (reference coolchic/bitstream/decode.py:188-207 semantics)."""
    max_dyn = 2**bitdepth - 1
    decoded = np.round(max_dyn * decoded) / max_dyn

    if frame_data_type == "yuv420":
        decoded = yuv_dict_clamp(convert_444_to_420(decoded), 0.0, 1.0)
        decoded = {k: np.round(v * max_dyn) / max_dyn for k, v in decoded.items()}
    else:
        decoded = np.clip(decoded, 0.0, 1.0)
        decoded = np.round(decoded * max_dyn) / max_dyn

    return FrameData(bitdepth=bitdepth, frame_data_type=frame_data_type, data=decoded)


def _decode_items_batched(items: list, device: str | torch.device = "cuda"
                          ) -> tuple[list, list[dict]]:
    """Decode `tpu`-profile payloads (header, bytes_nn, bytes_latent), one
    device batch per architecture group (bitstream/device_decode.py). A
    group that prepare_batch refuses (common randomness, a failed IFCE
    certificate, mixed groups) is decoded on the host instead. Returns
    ([(raw_out, grids), ...] in item order, one route record per group:
    {"items": indices, "path": "device" | "host", "reason": str | None})."""
    from coolchic_tpu_torch.bitstream.device_decode import _group_key, prepare_batch

    groups: dict[tuple, list[int]] = {}
    for i, (header, _, _) in enumerate(items):
        groups.setdefault(_group_key(header.to_config()), []).append(i)

    outputs: list = [None] * len(items)
    routes = []
    for idxs in groups.values():
        sub = [items[i] for i in idxs]
        try:
            batch = prepare_batch(sub, device)
        except ValueError as e:  # only what prepare_batch refuses; never a launch
            res = [decode_coolchic_tpu_host(*item, device=device) for item in sub]
            route = {"items": idxs, "path": "host", "reason": str(e)}
            n_small, n_host = 0, sub[0][0].n_latent_grids
        else:
            res = batch.decode()
            route = {"items": idxs, "path": "device", "reason": None}
            n_small, n_host = len(batch.small_levels), len(batch.host_levels)
        # grids an image sent to the small-grid kernel, and left to the host
        trace.count("decode.small_grids.device", n_small * len(sub))
        trace.count("decode.small_grids.host", n_host * len(sub))
        routes.append(route)
        for i, r in zip(idxs, res):
            outputs[i] = r
    return outputs, routes


@trace.spanned("decode.call", root=True)
def decode_images(bitstream_paths: list[str],
                  decoded_paths: Optional[list[str]] = None,
                  device: str | torch.device = "cuda",
                  return_routes: bool = False):
    """Batched decode of N single-frame intra `tpu`-profile bitstreams: the
    same-shape latent grids of different images decode together in one
    kernel launch per level. Returns the frames, or (frames, routes) with
    return_routes (see _decode_items_batched)."""
    device = resolve_device(device)
    items, metas = [], []
    with trace.span("decode.read"):
        for path in bitstream_paths:
            with open(path, "rb") as f:
                bitstream = f.read()
            if not bitstream.startswith(TPU_PROFILE_MAGIC):
                raise ValueError(f"{path}: not a tpu-profile bitstream; batched "
                                 "decode needs --profile tpu encodes")
            bitstream = bitstream[len(TPU_PROFILE_MAGIC):]
            video_header, bitstream = VideoHeader.read(bitstream)
            if video_header.n_frames != 1:
                raise ValueError(f"{path}: {video_header.n_frames} frames; "
                                 "batched decode covers single-frame bitstreams")
            frame_header, bitstream = FrameHeader.read(bitstream)
            if frame_header.frame_type != "I":
                raise ValueError(f"{path}: single-frame bitstream is not intra")
            cc_header, bitstream = CoolChicHeader.read(bitstream)
            bytes_nn = bitstream[:cc_header.nn_n_bytes]
            bitstream = bitstream[cc_header.nn_n_bytes:]
            bytes_latent = bitstream[:cc_header.n_bytes_latent]
            items.append((cc_header, bytes_nn, bytes_latent))
            metas.append(frame_header)

    outputs, routes = _decode_items_batched(items, device)

    frames = []
    for i, (frame_header, (raw_out, _)) in enumerate(zip(metas, outputs)):
        frame_data = _finish_frame(raw_out, frame_header.bitdepth,
                                   frame_header.frame_data_type)
        frames.append(frame_data)
        if decoded_paths is not None:
            from coolchic_tpu_torch.io.io import save_frame_data_to_file

            save_frame_data_to_file(frame_data, decoded_paths[i])
    return (frames, routes) if return_routes else frames


def decode_video(bitstream_path: str, decoded_path: Optional[str] = None,
                 max_decoding_order: int = -1, device: str | torch.device = "cuda",
                 routes: Optional[list] = None, verbosity: int = 0) -> dict[str, FrameData]:
    """Decode a .cool file of I, P and B frames in coding order (either
    profile, sniffed from the container magic); `decoded_path` gets every
    frame in display order (a multi-frame .yuv). Returns {display index:
    frame}; `routes` as decode_frame's. `verbosity` is taken and unused,
    as in coolchic_tpu/bitstream/decode.py:decode_video."""
    device = resolve_device(device)
    with open(bitstream_path, "rb") as f:
        bitstream = f.read()

    profile = "ref"
    if bitstream.startswith(TPU_PROFILE_MAGIC):
        profile = "tpu"
        bitstream = bitstream[len(TPU_PROFILE_MAGIC):]

    video_header, bitstream = VideoHeader.read(bitstream)
    coding_structure = CodingStructure(
        n_frames=video_header.n_frames,
        intra_pos=list(video_header.intra_pos),
        p_pos=list(video_header.p_pos),
    )

    if max_decoding_order == -1:
        max_decoding_order = coding_structure.get_max_coding_order()

    for coding_idx in range(max_decoding_order + 1):
        frame = coding_structure.get_frame_from_coding_order(coding_idx)
        refs = [coding_structure.get_frame_from_display_order(i).data
                for i in frame.index_references]
        frame.data, bitstream = decode_frame(bitstream, refs, profile=profile,
                                             device=device, routes=routes)

    all_frames: dict[str, FrameData] = {}
    for display_idx in range(coding_structure.get_max_display_order() + 1):
        frame = coding_structure.get_frame_from_display_order(display_idx)
        if frame.data is None:
            continue
        all_frames[str(display_idx)] = frame.data
        if decoded_path is not None:
            from coolchic_tpu_torch.io.io import save_frame_data_to_file

            save_frame_data_to_file(frame.data, decoded_path, append=display_idx != 0)
    return all_frames
