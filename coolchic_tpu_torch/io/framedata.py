"""Frame payload container.

Data is either a [1, C, H, W] float32 array in [0, 1] (rgb / yuv444 / flow)
or a dict {"y": [1,1,H,W], "u": [1,1,H/2,W/2], "v": [1,1,H/2,W/2]} for
yuv420. Reference parity: coolchic/io/framedata.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Union

import numpy as np

FRAME_DATA_TYPES = ("rgb", "yuv420", "yuv444", "flow")

YUVDict = dict  # {"y": ndarray, "u": ndarray, "v": ndarray}


@dataclass
class FrameData:
    bitdepth: int
    frame_data_type: str
    data: Union[np.ndarray, YUVDict]

    @property
    def img_size(self) -> tuple[int, int]:
        if self.frame_data_type == "yuv420":
            return tuple(self.data["y"].shape[-2:])
        return tuple(self.data.shape[-2:])

    @property
    def n_pixels(self) -> int:
        h, w = self.img_size
        return h * w
