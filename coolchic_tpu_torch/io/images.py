"""PNG (8-bit, via PIL) and PPM (P6, 8/16-bit) image io. PIL is imported
inside the PNG functions only, so PPM io works where PIL is not installed.

Reference parity: coolchic/io/format/png.py and ppm.py (16-bit PPM samples
are big-endian per the netpbm spec).
"""

from __future__ import annotations

import numpy as np

from coolchic_tpu_torch.io.framedata import FrameData


def read_png(path: str) -> FrameData:
    from PIL import Image

    img = np.asarray(Image.open(path).convert("RGB"), dtype=np.float32) / 255.0
    data = img.transpose(2, 0, 1)[None]  # [1, 3, H, W]
    return FrameData(bitdepth=8, frame_data_type="rgb", data=data)


def write_png(frame: FrameData, path: str) -> None:
    from PIL import Image

    x = np.asarray(frame.data)[0].transpose(1, 2, 0)
    x = np.round(np.clip(x, 0.0, 1.0) * 255.0).astype(np.uint8)
    Image.fromarray(x).save(path)


def read_ppm(path: str) -> FrameData:
    with open(path, "rb") as f:
        raw = f.read()
    # Parse "P6 <w> <h> <maxval>" header tokens (comments start with '#').
    tokens: list[bytes] = []
    pos = 0
    while len(tokens) < 4:
        while pos < len(raw) and raw[pos:pos + 1].isspace():
            pos += 1
        if raw[pos:pos + 1] == b"#":
            while raw[pos:pos + 1] not in (b"\n", b""):
                pos += 1
            continue
        start = pos
        while pos < len(raw) and not raw[pos:pos + 1].isspace():
            pos += 1
        tokens.append(raw[start:pos])
    pos += 1  # single whitespace after maxval
    if tokens[0] != b"P6":
        raise ValueError(f"Not a P6 ppm: {tokens[0]!r}")
    w, h, maxval = int(tokens[1]), int(tokens[2]), int(tokens[3])
    bitdepth = int(maxval).bit_length()
    if maxval <= 255:
        arr = np.frombuffer(raw, dtype=np.uint8, count=w * h * 3, offset=pos)
    else:
        arr = np.frombuffer(raw, dtype=">u2", count=w * h * 3, offset=pos).astype(np.uint16)
    img = arr.reshape(h, w, 3).astype(np.float32) / maxval
    return FrameData(bitdepth=bitdepth, frame_data_type="rgb",
                     data=img.transpose(2, 0, 1)[None])


def write_ppm(frame: FrameData, path: str) -> None:
    x = np.asarray(frame.data)[0].transpose(1, 2, 0)
    maxval = 2**frame.bitdepth - 1
    x = np.round(np.clip(x, 0.0, 1.0) * maxval)
    h, w, _ = x.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n{maxval}\n".encode())
        if maxval <= 255:
            f.write(x.astype(np.uint8).tobytes())
        else:
            f.write(x.astype(np.uint16).astype(">u2").tobytes())
