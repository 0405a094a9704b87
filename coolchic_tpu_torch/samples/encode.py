"""Video / image-set encoding driver (reference CLI parity:
samples/encode.py).

Walks a GOP in coding order with per-depth operating points and λ scaling
(train/video.py:encode_video; --waves trains each dependency wave's
same-depth frames as one batch), or sweeps an image directory over λ
points into a results TSV in the published schema.

Examples:
  # random-access video, intra every 32 frames
  python -m coolchic_tpu_torch.samples.encode --input vid_1920x1080_yuv420_8b.yuv \\
      --output out.cool --n_frames 65 --intra_pos 0,-1 --lmbda 1e-3 --workdir work

  # Kodak-style sweep producing results.tsv
  python -m coolchic_tpu_torch.samples.encode --image_dir kodak/ \\
      --lmbdas 1e-4,4e-4,1e-3,4e-3,2e-2 --results results.tsv --n_itr 10000
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

from coolchic_tpu_torch.io.io import load_frame_data_from_file
from coolchic_tpu_torch.samples import add_device_args, check_device_args
from coolchic_tpu_torch.train.encode import encode_image_to_bitstream
from coolchic_tpu_torch.train.presets import AVAILABLE_PRESETS, PresetIntra
from coolchic_tpu_torch.train.video import encode_video
from coolchic_tpu_torch.utils.parsecli import (
    coolchic_config_from_args,
    intra_operating_points,
    parse_frame_positions,
)
from coolchic_tpu_torch.utils.results import SequenceResult, write_results_tsv


def encode_video_main(args) -> int:
    res = encode_video(args.input, args.output, args.workdir, n_frames=args.n_frames,
                       intra_pos=parse_frame_positions(args.intra_pos, args.n_frames),
                       p_pos=parse_frame_positions(args.p_pos, args.n_frames),
                       lmbda=args.lmbda, itr_scale=args.itr_scale, seed=args.seed,
                       verbose=args.verbose, waves=args.waves, itr_floor=args.itr_floor,
                       device=args.device)
    print(f"wrote {res['n_bytes']} bytes to {args.output}")
    return 0


def encode_images_main(args) -> int:
    images = sorted(sum((glob.glob(os.path.join(args.image_dir, pat))
                         for pat in ("*.png", "*.ppm")), []))
    lmbdas = [float(v) for v in args.lmbdas.split(",")]
    os.makedirs(args.workdir, exist_ok=True)
    rows = []
    for lmbda in lmbdas:
        for img_path in images:
            seq = os.path.splitext(os.path.basename(img_path))[0]
            frame = load_frame_data_from_file(img_path)
            h, w = frame.img_size
            cfgs = {"residue": coolchic_config_from_args(
                intra_operating_points()[args.dec_cfg_residue], (h, w))}
            kw = dict(lmbda=lmbda, start_lr=args.start_lr, itr_main_training=args.n_itr)
            preset = (PresetIntra(**kw, itr_floor=args.itr_floor) if args.recipe == "intra"
                      else AVAILABLE_PRESETS[args.recipe](**kw))
            out_path = os.path.join(args.workdir, f"{seq}_{lmbda}.cool")
            res = encode_image_to_bitstream(frame, cfgs, preset, out_path, seed=args.seed,
                                            verbose=args.verbose, device=args.device)
            loss = 10 ** (-res["psnr_db"] / 10) + lmbda * res["rate_bpp"]
            rows.append(SequenceResult(lmbda=lmbda, seq_name=seq, n_pixels=h * w, loss=loss,
                                       psnr_db=res["psnr_db"], rate_bpp=res["rate_bpp"]))
            print(f"{seq} lmbda={lmbda}: {res['psnr_db']:.3f} dB "
                  f"{res['rate_bpp']:.4f} bpp", flush=True)
            if args.results:
                write_results_tsv(args.results, rows)
    return 0


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--input", help="video .yuv (video mode)")
    p.add_argument("--image_dir", help="directory of images (sweep mode)")
    p.add_argument("--output", default="out.cool")
    p.add_argument("--workdir", default="./workdir")
    p.add_argument("--results", default="", help="results TSV path (sweep mode)")
    p.add_argument("--n_frames", type=int, default=1)
    p.add_argument("--intra_pos", default="0")
    p.add_argument("--p_pos", default="")
    p.add_argument("--lmbda", type=float, default=1e-3)
    p.add_argument("--lmbdas", default="1e-3")
    p.add_argument("--n_itr", type=int, default=10000)
    p.add_argument("--itr_scale", type=float, default=1.0)
    p.add_argument("--itr_floor", type=int, default=2000,
                   help="least main-training budget of a frame (2000 in production; "
                        "less runs a short smoke schedule)")
    p.add_argument("--start_lr", type=float, default=1e-2)
    p.add_argument("--recipe", default="intra")
    p.add_argument("--dec_cfg_residue", default="hop")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--waves", action="store_true",
                   help="encode each GOP dependency wave's same-depth frames as ONE "
                        "batched training program (replaces the reference's "
                        "one-slurm-job-per-frame afterok DAG)")
    p.add_argument("--verbose", action="store_true")
    add_device_args(p)
    args = p.parse_args(argv)
    check_device_args(p, args)
    if args.image_dir:
        return encode_images_main(args)
    if args.input:
        return encode_video_main(args)
    p.print_help()
    return 1


if __name__ == "__main__":
    sys.exit(main())
