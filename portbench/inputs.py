"""The benchmark's frozen inputs: the manifest check, the decode pools and
the encode image (portbench/data/, made by tools/make_inputs.py)."""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np

DATA = Path(__file__).resolve().parent / "data"


def check_manifest(names: list[str]) -> None:
    """Raise unless every named data file is present with its manifest sha256."""
    manifest = json.loads((DATA / "manifest.json").read_text())
    for name in names:
        if name not in manifest:
            raise FileNotFoundError(f"portbench/data/{name} is not in the manifest")
        digest = hashlib.sha256((DATA / name).read_bytes()).hexdigest()
        if digest != manifest[name]:
            raise ValueError(f"portbench/data/{name}: sha256 {digest} != manifest's")


def pool(name: str) -> list[str]:
    """The data names of a decode pool (a directory of data/), sorted."""
    manifest = json.loads((DATA / "manifest.json").read_text())
    files = sorted(k for k in manifest if k.startswith(name + "/"))
    if not files:
        raise FileNotFoundError(f"no pool {name!r} in portbench/data")
    return files


def read_ppm(path: Path) -> np.ndarray:
    """An 8-bit binary PPM as float32 [3, H, W] in [0, 1]."""
    data = Path(path).read_bytes()
    fields, pos = [], 0
    while len(fields) < 4:      # magic, width, height, maxval
        while data[pos:pos + 1].isspace():
            pos += 1
        end = pos
        while not data[end:end + 1].isspace():
            end += 1
        fields.append(data[pos:end])
        pos = end
    if fields[0] != b"P6" or int(fields[3]) != 255:
        raise ValueError(f"{path}: not an 8-bit binary PPM")
    w, h = int(fields[1]), int(fields[2])
    px = np.frombuffer(data, dtype=np.uint8, offset=pos + 1, count=3 * w * h)
    return px.reshape(h, w, 3).transpose(2, 0, 1).astype(np.float32) / 255.0
