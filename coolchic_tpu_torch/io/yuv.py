"""Planar YUV io, BT.709 color math and 420<->444 chroma resampling.

Reference parity: coolchic/io/format/yuv.py. The filename convention
"name_WxH_<...>.yuv" carries the resolution; frames are planar Y,U,V at
8 bits (uint8) or >8 bits (uint16 little-endian).
"""

from __future__ import annotations

import os

import numpy as np

from coolchic_tpu_torch.io.framedata import FrameData

BT709 = (0.2126, 0.7152, 0.0722)  # (Kr, Kg, Kb)


def parse_yuv_size(file_path: str) -> tuple[int, int]:
    """"/a/b/name_WxH_fps_...yuv" -> (W, H)."""
    w, h = [int(v) for v in os.path.basename(file_path).split(".")[0].split("_")[1].split("x")]
    return w, h


def read_yuv(file_path: str, frame_idx: int, frame_data_type: str, bit_depth: int):
    w, h = parse_yuv_size(file_path)
    if frame_data_type == "yuv420":
        w_uv, h_uv = w // 2, h // 2
    else:
        w_uv, h_uv = w, h

    n_val_y = h * w
    n_val_uv = h_uv * w_uv
    n_val = n_val_y + 2 * n_val_uv
    dtype = np.uint8 if bit_depth <= 8 else np.uint16
    byte_per_value = 1 if bit_depth <= 8 else 2

    raw = np.memmap(file_path, mode="r", shape=n_val,
                    offset=n_val * byte_per_value * frame_idx, dtype=dtype)
    raw = np.asarray(raw, dtype=np.float32)
    norm = float(2**bit_depth - 1)
    y = raw[:n_val_y].reshape(1, 1, h, w) / norm
    u = raw[n_val_y:n_val_y + n_val_uv].reshape(1, 1, h_uv, w_uv) / norm
    v = raw[n_val_y + n_val_uv:].reshape(1, 1, h_uv, w_uv) / norm
    if frame_data_type == "yuv420":
        return {"y": y, "u": u, "v": v}
    return np.concatenate([y, u, v], axis=1)


def write_yuv(frame: FrameData, file_path: str, norm: bool = True, append: bool = False) -> None:
    norm_factor = float(2**frame.bitdepth - 1) if norm else 1.0
    dtype = np.uint8 if frame.bitdepth <= 8 else np.uint16
    if frame.frame_data_type == "yuv420":
        planes = [frame.data["y"], frame.data["u"], frame.data["v"]]
    else:
        planes = [frame.data[:, i:i + 1] for i in range(frame.data.shape[1])]
    with open(file_path, "ab" if append else "wb") as f:
        for p in planes:
            arr = np.round(np.asarray(p, dtype=np.float32) * norm_factor).astype(dtype)
            f.write(arr.tobytes())


def rgb2yuv(rgb: np.ndarray) -> np.ndarray:
    """[B, 3, H, W] RGB in [0, 1] -> BT.709 YCbCr (chroma centred on 0.5)."""
    kr, kg, kb = BT709
    r, g, b = rgb[:, 0:1], rgb[:, 1:2], rgb[:, 2:3]
    y = kr * r + kg * g + kb * b
    cb = 0.5 * (b - y) / (1 - kb) + 0.5
    cr = 0.5 * (r - y) / (1 - kr) + 0.5
    return np.concatenate([y, cb, cr], axis=1)


def yuv2rgb(yuv: np.ndarray) -> np.ndarray:
    """The inverse of rgb2yuv."""
    kr, kg, kb = BT709
    y, cb, cr = yuv[:, 0:1], yuv[:, 1:2], yuv[:, 2:3]
    r = y + (2 - 2 * kr) * (cr - 0.5)
    b = y + (2 - 2 * kb) * (cb - 0.5)
    g = (y - kr * r - kb * b) / kg
    return np.concatenate([r, g, b], axis=1)


def convert_444_to_420(yuv444: np.ndarray) -> dict:
    """U/V are 2x2 average-pooled (reference uses F.avg_pool2d)."""
    b, c, h, w = yuv444.shape
    y = yuv444[:, 0:1]
    uv = yuv444[:, 1:3]
    uv = uv.reshape(b, 2, h // 2, 2, w // 2, 2).mean(axis=(3, 5))
    return {"y": y, "u": uv[:, 0:1], "v": uv[:, 1:2]}


def convert_420_to_444(yuv420: dict) -> np.ndarray:
    """U/V are nearest-upsampled x2."""
    u = np.repeat(np.repeat(yuv420["u"], 2, axis=-2), 2, axis=-1)
    v = np.repeat(np.repeat(yuv420["v"], 2, axis=-2), 2, axis=-1)
    return np.concatenate([yuv420["y"], u, v], axis=1)


def yuv_dict_clamp(yuv: dict, lo: float, hi: float) -> dict:
    return {k: np.clip(v, lo, hi) for k, v in yuv.items()}
