"""Batch-encode a set of same-sized images as ONE batched program
(parallel/encode_batch.py:encode_images_batched): on one card, or, with
more than one card and an image count that divides over them, over a data
mesh of every card (each card trains its share of the images).

The dataset-sweep driver behind BD-rate tables: the reference runs one
process per image (samples/encode.py:147-183); here the images are the
batch slots of one training program.

Example:
  python -m coolchic_tpu_torch.samples.encode_batch --inputs 'kodak/*.png' \\
      --out_dir out --lmbda 1e-3 --n_itr 10000 --dec_cfg_residue hop
Writes out/<name>.cool per image plus a results TSV in the reference
results/v5.0 schema (lmbda seq_name n_pixels loss psnr_db rate_bpp).
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

import torch

from coolchic_tpu_torch.core.device import resolve_device
from coolchic_tpu_torch.io.io import load_frame_data_from_file
from coolchic_tpu_torch.parallel.batch import make_mesh
from coolchic_tpu_torch.parallel.encode_batch import encode_images_batched
from coolchic_tpu_torch.samples import add_device_args, check_device_args
from coolchic_tpu_torch.train.presets import PresetDebug, PresetIntra
from coolchic_tpu_torch.utils.parsecli import coolchic_config_from_args, intra_operating_points


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--inputs", required=True, help="glob of same-sized png/ppm images")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--lmbda", type=float, default=1e-3)
    p.add_argument("--n_itr", type=int, default=10000)
    p.add_argument("--start_lr", type=float, default=1e-2)
    p.add_argument("--recipe", default="intra", choices=["intra", "debug"])
    p.add_argument("--dec_cfg_residue", default="hop")
    p.add_argument("--profile", default="ref", choices=["ref", "tpu"])
    p.add_argument("--results", default=None, help="results TSV path")
    p.add_argument("--seed", type=int, default=0)
    add_device_args(p)
    args = p.parse_args(argv)
    check_device_args(p, args)

    paths = sorted(glob.glob(args.inputs))
    if not paths:
        print(f"no inputs match {args.inputs}")
        return 1
    frames = [load_frame_data_from_file(p_) for p_ in paths]
    names = [os.path.splitext(os.path.basename(p_))[0] for p_ in paths]
    os.makedirs(args.out_dir, exist_ok=True)
    out_paths = [os.path.join(args.out_dir, n + ".cool") for n in names]

    cfgs = {"residue": coolchic_config_from_args(
        intra_operating_points()[args.dec_cfg_residue], frames[0].img_size)}
    preset = (PresetIntra if args.recipe == "intra" else PresetDebug)(
        lmbda=args.lmbda, start_lr=args.start_lr, itr_main_training=args.n_itr)
    mesh = None
    n_cards = torch.cuda.device_count() if resolve_device(args.device).type == "cuda" else 0
    if n_cards > 1 and len(frames) % n_cards == 0:
        mesh = make_mesh(n_cards, device=args.device)
        print(f"sharding {len(frames)} images over {n_cards} cards")
    results = encode_images_batched(frames, cfgs, preset, out_paths, seed=args.seed,
                                    profile=args.profile, device=args.device, mesh=mesh)

    results_path = args.results or os.path.join(args.out_dir, "results.tsv")
    with open(results_path, "w") as f:
        f.write("lmbda\tseq_name\tn_pixels\tloss\tpsnr_db\trate_bpp\n")
        for name, r in zip(names, results):
            f.write(f"{args.lmbda}\t{name}\t{r['n_pixels']}\t{r['loss'] * 1e3:.6f}\t"
                    f"{r['psnr_db']:.6f}\t{r['rate_bpp']:.6f}\n")
    print(f"wrote {results_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
