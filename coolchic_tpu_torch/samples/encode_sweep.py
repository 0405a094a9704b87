"""Batched RD sweep: N images x M λ points as chunked batch encodes on one
card, with NN quantization, RDOQ and a decode-back check per bitstream.
Writes a reference-schema TSV (lmbda seq_name n_pixels loss psnr_db
rate_bpp) and a JSON line with the full-encode throughput (images/s
including warm-up, quantization, RDOQ and the bitstream write).

The reference runs this sweep as one cc_encode.py process per (image, λ)
pair (samples/encode.py:147-183); here every chunk of images trains as one
batch (parallel/encode_batch.py:encode_images_batched).

Image set: --kodim14-set derives distinct targets from one decoded image
(--source: a .cool bitstream, decoded by the port, or a png/ppm; by default
the reference decode of kodim14 in tests/data, 512x768) by flips,
inversion and channel rotations: a recompression throughput and RD
demonstration, not a Kodak reproduction (the TSV says so in seq_name).

Usage:
  python -m coolchic_tpu_torch.samples.encode_sweep --kodim14-set --out sweep \\
      --lmbdas 1e-3 4e-3 --n-itr 3000 --chunk 4
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from coolchic_tpu_torch.bitstream.decode import decode_video
from coolchic_tpu_torch.io.framedata import FrameData
from coolchic_tpu_torch.io.io import load_frame_data_from_file
from coolchic_tpu_torch.parallel.encode_batch import encode_images_batched
from coolchic_tpu_torch.samples import add_device_args, check_device_args
from coolchic_tpu_torch.train.presets import PresetIntra
from coolchic_tpu_torch.utils.parsecli import coolchic_config_from_args, intra_operating_points

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
KODIM14 = os.path.join(REPO, "tests", "data", "kodim14_ref_decode.png")


def kodim14_set(n: int, source: str = KODIM14, device: str = "cuda") -> list:
    """n distinct recompression targets from one decoded image."""
    if source.endswith(".cool"):
        frame = decode_video(source, device=device)["0"]
    else:
        frame = load_frame_data_from_file(source)
    base = np.asarray(frame.data)  # [1, 3, H, W]
    out = []
    for i in range(n):
        x = base
        if i % 2:
            x = x[:, :, :, ::-1]
        if (i // 2) % 2:
            x = x[:, :, ::-1, :]
        if (i // 4) % 2:
            x = 1.0 - x
        x = np.roll(x, shift=i // 8, axis=1)  # channel rotation
        out.append(FrameData(bitdepth=8, frame_data_type="rgb",
                             data=np.ascontiguousarray(x, dtype=np.float32)))
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--kodim14-set", action="store_true")
    ap.add_argument("--source", default=KODIM14,
                    help="the image the set derives from: .cool, .png or .ppm")
    ap.add_argument("--n-images", type=int, default=24)
    ap.add_argument("--lmbdas", type=float, nargs="+", default=[1e-4, 4e-4, 1e-3, 4e-3, 2e-2])
    ap.add_argument("--n-itr", type=int, default=3000)
    ap.add_argument("--itr-floor", type=int, default=2000,
                    help="least --n-itr (2000 in production; less runs a smoke schedule)")
    ap.add_argument("--chunk", type=int, default=4)
    ap.add_argument("--op", default="hop")
    ap.add_argument("--out", default="sweep")
    ap.add_argument("--profile", default="tpu")
    add_device_args(ap)
    args = ap.parse_args(argv)
    check_device_args(ap, args)
    if not args.kodim14_set:
        ap.error("only the --kodim14-set targets are available")

    frames = kodim14_set(args.n_images, args.source, args.device)
    os.makedirs(args.out, exist_ok=True)
    h, w = frames[0].img_size
    cfgs = {"residue": coolchic_config_from_args(intra_operating_points()[args.op], (h, w))}

    rows = []
    t_all = time.time()
    n_done = 0
    for lmbda in args.lmbdas:
        preset = PresetIntra(lmbda=lmbda, start_lr=1e-2, itr_main_training=args.n_itr,
                             itr_floor=args.itr_floor)
        for c0 in range(0, len(frames), args.chunk):
            chunk = frames[c0:c0 + args.chunk]
            paths = [os.path.join(args.out, f"kodim14var{c0 + i:02d}_l{lmbda:g}.cool")
                     for i in range(len(chunk))]
            t0 = time.time()
            res = encode_images_batched(chunk, cfgs, preset, paths, seed=c0, verbose=True,
                                        rdoq=True, profile=args.profile, device=args.device)
            dt = time.time() - t0
            for i, r in enumerate(res):
                # decode-back check (reference cc_encode.py:447-504)
                dec = decode_video(paths[i], device=args.device)["0"]
                d = np.asarray(dec.data) - np.asarray(chunk[i].data)
                dec_psnr = -10 * np.log10(max(float((d * d).mean()), 1e-10))
                if abs(dec_psnr - r["psnr_db"]) >= 0.3:
                    raise RuntimeError(f"{paths[i]}: decoder psnr {dec_psnr:.3f} dB, "
                                       f"encoder {r['psnr_db']:.3f} dB")
                rows.append((lmbda, f"kodim14-recompression-var{c0 + i:02d}",
                             r["n_pixels"], r["loss"], dec_psnr, r["rate_bpp"]))
            n_done += len(chunk)
            print(f"[sweep] lmbda {lmbda:g} chunk {c0}: {len(chunk)} imgs in {dt:.0f}s "
                  f"({len(chunk) / dt:.3f} img/s)", flush=True)

    wall = time.time() - t_all
    tsv = os.path.join(args.out, "image-kodak-recompression-sweep.tsv")
    with open(tsv, "w") as f:
        f.write("lmbda\tseq_name\tn_pixels\tloss\tpsnr_db\trate_bpp\n")
        for r in rows:
            f.write(f"{r[0]:g}\t{r[1]}\t{r[2]}\t{r[3]:.6f}\t{r[4]:.4f}\t{r[5]:.4f}\n")
    bench = {"metric": "batch_encode_img_per_s_full_pipeline", "value": n_done / wall,
             "unit": "img/s",
             "device": (torch.cuda.get_device_name(torch.device(args.device))
                        if torch.device(args.device).type == "cuda" else "cpu"),
             "detail": {"n_images": n_done, "wall_s": wall, "n_itr": args.n_itr,
                        "op": args.op, "size": [h, w],
                        "incl": "warmup+train+quantize+rdoq+bitstream+decode-back"}}
    with open(os.path.join(args.out, "batch_encode.json"), "w") as f:
        f.write(json.dumps(bench) + "\n")
    print(json.dumps(bench), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
