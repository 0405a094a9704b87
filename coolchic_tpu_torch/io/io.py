"""Load / save FrameData from files (png / ppm / yuv), dispatched on the
extension and filename conventions. Reference parity: coolchic/io/io.py."""

from __future__ import annotations

import os

from coolchic_tpu_torch.io.framedata import FrameData
from coolchic_tpu_torch.io.images import read_png, read_ppm, write_png, write_ppm
from coolchic_tpu_torch.io.yuv import read_yuv, write_yuv


def load_frame_data_from_file(file_path: str, idx_display_order: int = 0) -> FrameData:
    ext = os.path.splitext(file_path)[1].lower()
    if ext == ".png":
        return read_png(file_path)
    if ext == ".ppm":
        return read_ppm(file_path)
    if ext == ".yuv":
        name = os.path.basename(file_path)
        bitdepth = 8
        if "_10b" in name:
            bitdepth = 10
        elif "_8b" in name:
            bitdepth = 8
        frame_data_type = "yuv420" if "420" in name else "yuv444"
        data = read_yuv(file_path, idx_display_order, frame_data_type, bitdepth)
        return FrameData(bitdepth=bitdepth, frame_data_type=frame_data_type, data=data)
    raise ValueError(f"Unknown frame extension {ext}")


def save_frame_data_to_file(frame: FrameData, file_path: str, append: bool = False) -> None:
    ext = os.path.splitext(file_path)[1].lower()
    if ext == ".png":
        write_png(frame, file_path)
    elif ext == ".ppm":
        write_ppm(frame, file_path)
    elif ext == ".yuv":
        write_yuv(frame, file_path, append=append)
    else:
        raise ValueError(f"Unknown frame extension {ext}")
