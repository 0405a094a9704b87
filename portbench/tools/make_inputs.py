#!/usr/bin/env python3
"""Makes the benchmark's frozen inputs under portbench/data/ (run once; the
benchmark checks them by sha256 at set-up and never remakes them).

    python portbench/tools/make_inputs.py hop        # CPU, about a minute
    python portbench/tools/make_inputs.py image      # CPU (needs PIL)
    python portbench/tools/make_inputs.py lop --out chiprun_out/lop   # on the card
    python portbench/tools/make_inputs.py manifest

hop: the 29 round-5 Kodak files (results/round5/kodak/*.cool, the hop
  reference profile at 3000 iterations) decoded on the host and their
  latents re-coded to the `tpu` profile by the port's own coder.
image: tools/golden/kodim14_ref.png as a binary PPM (the card's machine has
  no PNG reader).
lop: 8 `tpu` files encoded by the port's encode_images_batched (production
  intra preset, --n_itr 3000, RDOQ on, seed 0): the six channel
  permutations of kodim14 at lambda 1e-3, and p012 at 1e-4 and 2e-2.
manifest: data/manifest.json, the sha256 of every data file.
"""

from __future__ import annotations

import argparse
import copy
import hashlib
import json
import sys
from itertools import permutations
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
DATA = ROOT / "portbench" / "data"
PERMS = ["".join(map(str, p)) for p in permutations(range(3))]
LOP_POOL = [(p, 1e-3) for p in PERMS] + [("012", 1e-4), ("012", 2e-2)]


def make_hop() -> None:
    sys.path.insert(0, str(ROOT))
    from coolchic_tpu_torch.bitstream import codec
    from coolchic_tpu_torch.bitstream.headers import (
        TPU_PROFILE_MAGIC, CoolChicHeader, FrameHeader, VideoHeader)
    from coolchic_tpu_torch.bitstream.nncodec import decode_network

    out = DATA / "hop"
    out.mkdir(parents=True, exist_ok=True)
    files = sorted((ROOT / "results/round5/kodak").glob("*.cool"))
    for path in files:
        rest = path.read_bytes()
        _, rest = VideoHeader.read(rest)
        fh, rest = FrameHeader.read(rest)
        ch, rest = CoolChicHeader.read(rest)
        bnn = rest[:ch.nn_n_bytes]
        blat = rest[ch.nn_n_bytes:ch.nn_n_bytes + ch.n_bytes_latent]
        cfg = ch.to_config()
        _, grids = codec.decode_coolchic(ch, bnn, blat, profile="ref", device="cpu")
        nn = decode_network(bnn, cfg, ch.nn_q_step_shift, ch.nn_expgol_cnt, ch.nn_n_bit_pad)
        tpu_ch = copy.copy(ch)
        pay = codec.encode_coolchic_latents(tpu_ch, nn, grids, profile="tpu")
        (out / path.name).write_bytes(TPU_PROFILE_MAGIC + VideoHeader().to_bytes()
                                      + fh.to_bytes() + tpu_ch.to_bytes() + bnn + pay)
        print(f"{path.name}: {len(pay)} latent bytes", flush=True)


def make_image() -> None:
    from PIL import Image

    img = Image.open(ROOT / "tools/golden/kodim14_ref.png").convert("RGB")
    w, h = img.size
    (DATA / "kodim14.ppm").write_bytes(f"P6\n{w} {h}\n255\n".encode() + img.tobytes())


def make_lop(out: Path) -> None:
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from coolchic_tpu_torch.io.framedata import FrameData
    from coolchic_tpu_torch.parallel.encode_batch import encode_images_batched
    from coolchic_tpu_torch.train.presets import PresetIntra
    from coolchic_tpu_torch.utils.parsecli import coolchic_config_from_args, intra_operating_points

    from portbench.inputs import read_ppm

    rgb = read_ppm(DATA / "kodim14.ppm")            # [3, H, W] float32 in [0, 1]
    frames = [FrameData(bitdepth=8, frame_data_type="rgb",
                        data=np.ascontiguousarray(rgb[[int(c) for c in p]][None]))
              for p, _ in LOP_POOL]
    cfgs = {"residue": coolchic_config_from_args(intra_operating_points()["lop"],
                                                 frames[0].img_size)}
    preset = PresetIntra(lmbda=1e-3, start_lr=1e-2, itr_main_training=3000)
    out.mkdir(parents=True, exist_ok=True)
    paths = [str(out / f"kodim14_p{p}_l{lam}.cool") for p, lam in LOP_POOL]
    res = encode_images_batched(frames, cfgs, preset, paths, seed=0, rdoq=True,
                                profile="tpu", lmbdas=[lam for _, lam in LOP_POOL],
                                device="cuda", verbose=False)
    for p, r in zip(paths, res):
        print(json.dumps({"file": Path(p).name, **r}), flush=True)


def make_manifest() -> None:
    files = sorted(p for p in DATA.rglob("*") if p.is_file() and p.name != "manifest.json")
    manifest = {str(p.relative_to(DATA)): hashlib.sha256(p.read_bytes()).hexdigest()
                for p in files}
    (DATA / "manifest.json").write_text(json.dumps(manifest, indent=1, sort_keys=True) + "\n")
    print(f"{len(manifest)} files")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("what", choices=["hop", "image", "lop", "manifest"])
    ap.add_argument("--out", type=Path, default=DATA / "lop")
    args = ap.parse_args()
    if args.what == "hop":
        make_hop()
    elif args.what == "image":
        make_image()
    elif args.what == "lop":
        make_lop(args.out)
    else:
        make_manifest()
    return 0


if __name__ == "__main__":
    sys.exit(main())
