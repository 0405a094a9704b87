"""Batched decode of many single-frame `tpu`-profile bitstreams on one
card: the latent grids of the same level across images decode together,
one launch of the CUDA wavefront kernel per 128-stream level
(bitstream/decode.py:decode_images). The reference decoder is one process
per bitstream; this driver is the batch counterpart of encode_batch.

Usage:
  python -m coolchic_tpu_torch.samples.decode_batch -i 'out/*.cool' -o decoded/
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time

from coolchic_tpu_torch.bitstream.decode import decode_images
from coolchic_tpu_torch.samples import add_device_args, check_device_args


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("-i", "--input", required=True,
                        help="glob of .cool bitstreams (quote it)")
    parser.add_argument("-o", "--output", required=True,
                        help="output directory (one image per bitstream)")
    parser.add_argument("--ext", default="png", choices=["png", "ppm", "yuv"])
    add_device_args(parser)
    args = parser.parse_args(argv)
    check_device_args(parser, args)

    paths = sorted(glob.glob(args.input))
    if not paths:
        parser.error(f"no bitstreams match {args.input!r}")
    os.makedirs(args.output, exist_ok=True)
    outs = [os.path.join(args.output, os.path.splitext(os.path.basename(p))[0]
                         + "." + args.ext) for p in paths]

    t0 = time.perf_counter()
    frames = decode_images(paths, outs, device=args.device)
    dt = time.perf_counter() - t0
    n_pix = sum(f.img_size[0] * f.img_size[1] for f in frames)
    print(f"decoded {len(paths)} bitstreams ({n_pix / 1e6:.2f} Mpix) on {args.device} "
          f"in {dt:.2f}s -> {n_pix / dt / 1e6:.2f} Mpix/s")
    for p, o in zip(paths, outs):
        print(f"  {p} -> {o}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
