"""Decode a .cool bitstream with the PyTorch port (intra frames, either
profile).

Example: python -m coolchic_tpu_torch.cc_decode -i bitstream.cool -o decoded.ppm
"""

from __future__ import annotations

import argparse
import sys


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-i", "--input", required=True, help=".cool bitstream")
    p.add_argument("-o", "--output", required=True, help="decoded png / ppm / yuv")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda without a card is an error")
    args = p.parse_args(argv)

    from coolchic_tpu_torch.bitstream.decode import decode_video

    decode_video(args.input, decoded_path=args.output, device=args.device)
    print(f"decoded {args.input} -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
