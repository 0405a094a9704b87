"""Batched Kodak-set encode: N same-size images x M λ points, each λ as a
few batched programs on one card (parallel/encode_batch.py).

The reference sweeps the Kodak set with one process per image chained by
slurm `afterok` (reference samples/encode.py:147-183); here the image batch
is the program, so the figure of merit is full-encode throughput in
images/s including warm-up, training, NN quantization, RDOQ and the
bitstream write.

The only full-size Kodak content in the repo is the reference-decoded
kodim14 (512x768, tests/data/kodim14_ref_decode.png). The 24-image set is
built as 24 distinct targets, 4 spatial flips x 6 channel permutations of
that image: every slot overfits its own network to different pixels, so
the throughput stands for 24 same-size images (the RD numbers stay a
recompression task).

Usage:
  python -m coolchic_tpu_torch.samples.encode_kodak_batch --n_images 24 --chunk 4 \\
      --n_itr 3000 --lmbdas 1e-3 --out kodak_batch
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import os
import re
import sys
import time

import numpy as np

from coolchic_tpu_torch.io.framedata import FrameData
from coolchic_tpu_torch.io.io import load_frame_data_from_file
from coolchic_tpu_torch.parallel.encode_batch import encode_images_batched
from coolchic_tpu_torch.samples import add_device_args, check_device_args
from coolchic_tpu_torch.train.presets import PresetDebug, PresetIntra
from coolchic_tpu_torch.train.video import intra_gain_for_lmbda
from coolchic_tpu_torch.utils.parsecli import coolchic_config_from_args, intra_operating_points

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
KODIM14 = os.path.join(REPO, "tests", "data", "kodim14_ref_decode.png")


def build_kodak_targets(n_images: int, image: str = KODIM14):
    """n distinct [1, 3, H, W] rgb FrameData variants of the base image:
    flips x channel permutations (24 = 4 x 6 unique combinations, then
    wraps). n_images = 1 returns the base image itself."""
    base = load_frame_data_from_file(image)
    img = np.asarray(base.data)  # [1, 3, H, W]
    flips = [(False, False), (True, False), (False, True), (True, True)]
    perms = list(itertools.permutations(range(3)))
    frames, names = [], []
    for i in range(n_images):
        fv, fh = flips[(i // 6) % 4]
        perm = perms[i % 6]
        v = img[:, list(perm)]
        if fv:
            v = v[:, :, ::-1]
        if fh:
            v = v[:, :, :, ::-1]
        frames.append(FrameData(base.bitdepth, "rgb", np.ascontiguousarray(v)))
        if image != KODIM14:
            # the full stem, less a leading WxH size token (two images that
            # share a size prefix still get unique slot names)
            stem = os.path.splitext(os.path.basename(image))[0]
            parts = stem.split("_")
            if len(parts) > 1 and re.fullmatch(r"\d+x\d+", parts[0]):
                stem = "_".join(parts[1:])
        else:
            stem = "kodim14"
        names.append(f"{stem}_p{''.join(map(str, perm))}"
                     f"{'_fv' if fv else ''}{'_fh' if fh else ''}")
    return frames, names


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--n_images", type=int, default=24)
    ap.add_argument("--image", default=KODIM14,
                    help="base image for the flip/permutation variants")
    ap.add_argument("--first_image", type=int, default=0,
                    help="start at this image index (resume a partial sweep)")
    ap.add_argument("--chunk", type=int, default=4,
                    help="images per batch (activation-memory bound)")
    ap.add_argument("--n_itr", type=int, default=3000)
    ap.add_argument("--start_lr", type=float, default=1e-2)
    ap.add_argument("--lmbdas", default="1e-3", help="comma-separated lambda list")
    ap.add_argument("--op", default="hop", help="intra operating point")
    ap.add_argument("--profile", default="ref", choices=["ref", "tpu"])
    ap.add_argument("--no_rdoq", action="store_true")
    ap.add_argument("--out", default="kodak_batch")
    ap.add_argument("--crop", default="", help="HxW center crop for smoke tests, e.g. 64x96")
    ap.add_argument("--recipe", default="intra", choices=["intra", "debug"])
    ap.add_argument("--pairs", action="store_true",
                    help="sweep (image, lambda) PAIRS as mixed batch slots: lambda is per "
                         "slot, so a 24x5 sweep runs as ceil(120/chunk) chunks instead of "
                         "5 x ceil(24/chunk)")
    ap.add_argument("--first_slot", type=int, default=0,
                    help="with --pairs: resume at this slot index")
    ap.add_argument("--order", default="image_major", choices=["image_major", "lambda_major"],
                    help="pair order: image_major completes full lambda curves "
                         "image-by-image (best for partial sweeps); lambda_major keeps "
                         "chunks single-lambda")
    ap.add_argument("--skip_done", action="store_true",
                    help="skip slots whose .cool already exists")
    add_device_args(ap)
    args = ap.parse_args(argv)
    check_device_args(ap, args)

    frames, names = build_kodak_targets(args.first_image + args.n_images, image=args.image)
    frames, names = frames[args.first_image:], names[args.first_image:]
    if args.crop:
        ch, cw = (int(x) for x in args.crop.split("x"))
        for fr in frames:
            hh, ww = fr.img_size
            y0, x0 = (hh - ch) // 2, (ww - cw) // 2
            fr.data = np.ascontiguousarray(fr.data[:, :, y0:y0 + ch, x0:x0 + cw])
    h, w = frames[0].img_size
    cfgs = {"residue": coolchic_config_from_args(intra_operating_points()[args.op], (h, w))}
    os.makedirs(args.out, exist_ok=True)
    lmbdas = [float(x) for x in args.lmbdas.split(",")]
    mk = PresetIntra if args.recipe == "intra" else PresetDebug

    tsv = os.path.join(args.out, "image-kodak-batch.tsv")
    new = not os.path.exists(tsv)
    t_all = time.time()
    n_done = 0
    with open(tsv, "a") as f:
        if new:
            f.write("lmbda\tseq_name\tpsnr_db\trate_bpp\tn_bytes\tn_pixels\t"
                    "chunk_s\timg_per_s_chunk\n")
        if args.pairs:
            if args.order == "lambda_major":
                slots = [(fi, lm) for lm in lmbdas for fi in range(len(frames))]
            else:
                slots = [(fi, lm) for fi in range(len(frames)) for lm in lmbdas]
            # keep each slot's absolute index: the chunk seed derives from
            # it, so a --first_slot / --skip_done resume that lands on the
            # same chunk boundaries reproduces the uninterrupted run
            slots = list(enumerate(slots))[args.first_slot:]
            if args.skip_done:
                slots = [(si, (fi, lm)) for si, (fi, lm) in slots if not os.path.exists(
                    os.path.join(args.out, f"{names[fi]}_l{lm:g}.cool"))]
            # the λ-adaptive encoder gain (24 / 20 / 16) is part of the
            # config, so a chunk holds one gain; within it λ mixes freely
            groups: dict[int, list] = {}
            for s in slots:
                groups.setdefault(intra_gain_for_lmbda(s[1][1]), []).append(s)
            gain_chunks = []
            for gain in sorted(groups, reverse=True):
                g_slots = groups[gain]
                for c0 in range(0, len(g_slots), args.chunk):
                    gain_chunks.append((gain, g_slots[c0:c0 + args.chunk]))
            side = os.path.join(args.out, "image-kodak-rows.tsv")
            if not os.path.exists(side):
                with open(side, "w") as sf:
                    sf.write("lmbda\tseq_name\tpsnr_db\trate_bpp\tn_bytes\tn_pixels\t"
                             "chunk_s\timg_per_s_chunk\n")
            for chunk_idx, (gain, sl) in enumerate(gain_chunks):
                chunk = [frames[fi] for _, (fi, _) in sl]
                cnames = [names[fi] for _, (fi, _) in sl]
                clams = [lm for _, (_, lm) in sl]
                g_cfgs = {k: dataclasses.replace(v, encoder_gain=gain) for k, v in cfgs.items()}
                # the preset's λ only sets the schedule: each slot trains
                # at its own λ, its warm-up noise derived from it
                preset = mk(lmbda=clams[0], start_lr=args.start_lr,
                            itr_main_training=args.n_itr)
                outs = [os.path.join(args.out, f"{n_}_l{lm:g}.cool")
                        for n_, lm in zip(cnames, clams)]
                t0 = time.time()

                # one row per image as soon as its file is written
                def on_image(i, r, _names=cnames, _lams=clams, _t0=t0):
                    with open(side, "a") as sf:
                        sf.write(f"{_lams[i]:g}\t{_names[i]}\t{r['psnr_db']:.4f}\t"
                                 f"{r['rate_bpp']:.6f}\t{r['n_bytes']}\t{r['n_pixels']}\t"
                                 f"{time.time() - _t0:.1f}\t0.0000\n")

                res = encode_images_batched(chunk, g_cfgs, preset, outs, seed=sl[0][0],
                                            verbose=True, rdoq=not args.no_rdoq,
                                            profile=args.profile, lmbdas=clams,
                                            on_image=on_image, device=args.device)
                dt = time.time() - t0
                for r, n_, lm in zip(res, cnames, clams):
                    f.write(f"{lm:g}\t{n_}\t{r['psnr_db']:.4f}\t{r['rate_bpp']:.6f}\t"
                            f"{r['n_bytes']}\t{r['n_pixels']}\t{dt:.1f}\t"
                            f"{len(res) / dt:.4f}\n")
                f.flush()
                n_done += len(res)
                print(f"[{n_done + args.first_slot}/{len(frames) * len(lmbdas)}] "
                      f"pair-chunk {chunk_idx} (gain {gain}): {len(res)} slots in "
                      f"{dt:.1f}s = {len(res) / dt:.3f} img/s", flush=True)
        else:
            for lmbda in lmbdas:
                preset = mk(lmbda=lmbda, start_lr=args.start_lr, itr_main_training=args.n_itr)
                for c0 in range(0, len(frames), args.chunk):
                    chunk = frames[c0:c0 + args.chunk]
                    cnames = names[c0:c0 + args.chunk]
                    outs = [os.path.join(args.out, f"{n}_l{lmbda:g}.cool") for n in cnames]
                    t0 = time.time()
                    res = encode_images_batched(chunk, cfgs, preset, outs, seed=c0,
                                                verbose=True, rdoq=not args.no_rdoq,
                                                profile=args.profile, device=args.device)
                    dt = time.time() - t0
                    for r, n in zip(res, cnames):
                        f.write(f"{lmbda:g}\t{n}\t{r['psnr_db']:.4f}\t{r['rate_bpp']:.6f}\t"
                                f"{r['n_bytes']}\t{r['n_pixels']}\t{dt:.1f}\t"
                                f"{len(res) / dt:.4f}\n")
                    f.flush()
                    n_done += len(res)
                    print(f"[{n_done}/{len(frames) * len(lmbdas)}] lmbda {lmbda:g} chunk "
                          f"{c0 // args.chunk}: {len(res)} imgs in {dt:.1f}s = "
                          f"{len(res) / dt:.3f} img/s", flush=True)

    wall = time.time() - t_all
    print(f"TOTAL {n_done} full encodes (n_itr={args.n_itr}, "
          f"{'no ' if args.no_rdoq else ''}rdoq) on {args.device} in {wall:.1f}s = "
          f"{n_done / wall:.4f} img/s -> {tsv}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
