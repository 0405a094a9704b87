"""Encode-side helpers for one frame: the training target and the image
statistics of the synthesis output transform.

Reference parity: coolchic_tpu/train/encode.py:32-54.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from coolchic_tpu_torch.io.framedata import FrameData
from coolchic_tpu_torch.io.yuv import convert_420_to_444


def _target_from_frame(frame: FrameData, device: torch.device | str = "cpu"):
    """[1, C, H, W] target (a batch of one image), or a dict of planes."""
    if frame.frame_data_type == "yuv420":
        return {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
                for k, v in frame.data.items()}
    return torch.as_tensor(np.asarray(frame.data, np.float32), device=device)


def img_min_max(frame: FrameData) -> Optional[np.ndarray]:
    """Per-channel (min, max) stats for the YUV output transform
    (reference component/video.py:93-101 initializes the synthesis output
    transform from image statistics for YUV content); None for RGB."""
    if frame.frame_data_type == "rgb":
        return None
    if frame.frame_data_type == "yuv420":
        data = convert_420_to_444(frame.data)
    else:
        data = np.asarray(frame.data)
    mn = data.min(axis=(0, 2, 3))
    mx = data.max(axis=(0, 2, 3))
    return np.stack([mn, mx], axis=1).astype(np.float32)
