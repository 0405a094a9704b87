"""Encode one frame (I, P or B) of an image or video with the PyTorch port.

    python -m coolchic_tpu_torch.cc_encode -i img.ppm -o out.cool \\
        --dec_cfg_residue hop --lmbda 1e-3 [--profile tpu] [--device cpu] \\
        [--no_rdoq] [--tune wasserstein]
    python -m coolchic_tpu_torch.cc_encode -i clip_768x512_yuv420_8b.yuv \\
        -o out.cool --workdir w --n_frames 3 --intra_pos 0 --p_pos -1 \\
        --coding_idx 1          # after --coding_idx 0, same workdir

The counterpart of the repo's cc_encode.py: the same 3-level
configuration (argument defaults < config file or operating-point name
given by --dec_cfg_residue / --dec_cfg_motion < explicit command line; a
residue name resolves against the intra table for I frames and the residue
table for P/B), the same recipes (auto = intra or inter by frame type),
bitstream profiles and RDOQ (on unless --no_rdoq), `--tune wasserstein`
(common randomness, the serial trainer, refused for .yuv input),
`--device` (default cuda) in place of `--cpu`. The workdir gets param.txt,
archi.txt, the summary and reference-schema encoder TSVs, the detailed
logs and the decoder TSV. A P/B frame reads its decoded references from
the workdir, so the frames of a clip are encoded in coding order into one
workdir and one output file (frame 0 writes it, later frames append).
Every encode is decoded back by the port's own decoder (the whole file up
to this coding index); a PSNR more than 0.3 dB off the encoder's, or a
real rate more than 20 % off its estimate, exits non-zero.

`--spatial_shard` (default auto) splits one large frame's training along
its height over N devices (parallel/spatial.py): auto is 0 unless the
device is cuda, more than one card is visible and the frame has at least
2 * 1024 * 1024 pixels, and then every card; on cuda an N above the card
count is refused; on the CPU, N shards of the CPU (how the tests run it).
"""

from __future__ import annotations

import json
import os
import sys

from coolchic_tpu_torch.utils.configfile import ConfigArgParser

# Reference defaults (cc_encode.py:160-330) = the intra hop operating point.
DEC_DEFAULTS = {
    "layers_synthesis_residue": "48-1-linear-relu,X-1-linear-none,"
                                "X-3-residual-relu,X-3-residual-none/stabiliser",
    "layers_synthesis_motion": "16-1-linear-relu,X-1-linear-none/stabiliser",
    "arm_residue": "14,2/stabiliser",
    "arm_motion": "6,2/stabiliser",
    "output_feature_ifce_residue": 6,
    "output_feature_ifce_motion": 6,
    "ifce_resolution_residue": "0-2",
    "ifce_resolution_motion": "2-2",
    "hyperlatent_resolution_residue": "auto",
    "hyperlatent_resolution_motion": "no",
    "latent_resolution_residue": "auto",
    "latent_resolution_motion": "2-6",
    "ups_k_size_residue": 8,
    "ups_k_size_motion": 8,
    "ups_preconcat_k_size_residue": 7,
    "ups_preconcat_k_size_motion": 7,
}
_DEC_KEYS = ("latent_resolution", "hyperlatent_resolution", "arm", "output_feature_ifce",
             "ifce_resolution", "layers_synthesis", "ups_k_size", "ups_preconcat_k_size")


def build_parser() -> ConfigArgParser:
    p = ConfigArgParser(description=__doc__)
    # -------- not in configuration files
    p.add("-i", "--input", required=True, help="png / ppm / yuv input")
    p.add("-o", "--output", default="./bitstream.cool", help="output .cool bitstream")
    p.add("--nobitstream", action="store_true", help="don't write a bitstream")
    p.add("--workdir", default=None, help="working directory (decoded refs etc.)")
    p.add("--lmbda", type=float, default=1e-3, help="rate constraint lambda")
    p.add("--print_detailed_archi", action="store_true")
    p.add("--print_detailed_struct", action="store_true")
    p.add("--intra_pos", default="0", help='intra display positions, e.g. "0,4-7,-2"')
    p.add("--p_pos", default="", help="P-frame display positions, same format")
    p.add("--n_frames", type=int, default=1)
    p.add("--frame_offset", type=int, default=0,
          help="skip the first N frames of the video")
    p.add("--coding_idx", type=int, default=0,
          help="index (in coding order) of the frame to code")
    p.add("--profile", default="ref", choices=["ref", "tpu"],
          help="bitstream profile: ref = reference bit-compatible, "
               "tpu = parallel-stream latents (docs/tpu_profile.md)")
    p.add("--seed", type=int, default=0)
    p.add("--device", default="cuda", help="torch device: cuda (default) or cpu")
    p.add("-v", "--verbose", action="count", default=1)
    # -------- configuration-file sources
    p.add("--dec_cfg_residue", default="hop",
          help="residue (or intra) decoder: operating point name "
               "(vlop/lop/mop/hop/vhop) or cfg file path")
    p.add("--dec_cfg_motion", default="mop",
          help="motion decoder: operating point name (lop/mop) or cfg file path")
    # -------- encoder-side (overridable from cfg files)
    p.add("--start_lr", type=float, default=1e-2)
    p.add("--n_itr", type=int, default=int(1e4),
          help="iterations of the main training stage")
    p.add("--n_itr_pretrain_motion", type=int, default=3000)
    p.add("--tune", default="mse", choices=["mse", "wasserstein"])
    p.add("--debug", action="store_true", help="extremely quick training")
    p.add("--recipe", default="auto",
          choices=["auto", "intra", "inter", "debug", "measure_speed"])
    p.add("--no_rdoq", action="store_true", help="skip rate-distortion-optimized "
          "quantization of the NN parameters")
    # -------- decoder-side architecture (overridable from cfg files)
    for key, default in DEC_DEFAULTS.items():
        p.add(f"--{key}", type=type(default), default=default)
    p.add("--warp_filter_size", type=int, default=8,
          help="taps of the warping interpolation filter")
    p.add("--spatial_shard", default="auto",
          help="shard the frame's training along image height over N devices (for "
               "2K/4K frames). 0 disables; 'auto' enables over every card when the "
               "device is cuda, more than one card is visible and the frame is >= 2 "
               "Mpix. On --device cpu, N shards of the CPU")
    return p


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)

    import torch

    from coolchic_tpu_torch.core.device import resolve_device
    from coolchic_tpu_torch.io.io import load_frame_data_from_file
    from coolchic_tpu_torch.parallel.spatial import resolve_spatial_shard
    from coolchic_tpu_torch.train.presets import AVAILABLE_PRESETS
    from coolchic_tpu_torch.train.video import encode_one_frame
    from coolchic_tpu_torch.utils.codingstructure import CodingStructure
    from coolchic_tpu_torch.utils.parsecli import (
        intra_operating_points,
        motion_operating_points,
        parse_frame_positions,
        residue_operating_points,
    )

    device = resolve_device(args.device)
    workdir = args.workdir or os.path.join(os.path.dirname(args.output) or ".", "workdir")
    os.makedirs(workdir, exist_ok=True)

    intra_pos = parse_frame_positions(args.intra_pos, args.n_frames)
    p_pos = parse_frame_positions(args.p_pos, args.n_frames)
    seq_name = os.path.splitext(os.path.basename(args.input))[0]
    cs = CodingStructure(n_frames=args.n_frames, intra_pos=intra_pos, p_pos=p_pos,
                         seq_name=seq_name, frame_offset=args.frame_offset)
    if args.print_detailed_struct:
        print(cs.pretty_string(), flush=True)
    frame = cs.get_frame_from_coding_order(args.coding_idx)
    if frame is None:
        print(f"no frame with coding_idx {args.coding_idx}")
        return 1
    # the table for --dec_cfg_residue depends on the frame type (intra and
    # residue operating points share their names)
    inter = frame.frame_type != "I"
    parser.apply_config(args, args.dec_cfg_residue,
                        table=residue_operating_points() if inter else intra_operating_points(),
                        suffix="_residue")
    if inter:
        parser.apply_config(args, args.dec_cfg_motion, table=motion_operating_points(),
                            suffix="_motion")
    with open(os.path.join(workdir, "param.txt"), "w") as f:
        f.write(parser.format_values())

    if args.tune == "wasserstein":
        if args.input.endswith(".yuv"):
            print("--tune=wasserstein cannot be used with YUV files; use --tune=mse")
            return 1
        # Empirical weighting ("Perceptually optimised Cool-chic for CLIC 2025").
        dist_weight = {"mse": 0.2, "wasserstein": 0.8 / 200}
    else:
        dist_weight = {"mse": 1.0}

    recipe = args.recipe
    if args.debug:
        recipe = "debug"
    elif recipe == "auto":
        recipe = "inter" if inter else "intra"
    preset = AVAILABLE_PRESETS[recipe](
        lmbda=args.lmbda, start_lr=args.start_lr, itr_main_training=args.n_itr,
        itr_motion_pretrain=args.n_itr_pretrain_motion, dist_weight=dist_weight)

    cfg_args = {name: {k: str(getattr(args, f"{k}_{name}")) for k in _DEC_KEYS}
                for name in (("residue", "motion") if inter else ("residue",))}

    n_cards = torch.cuda.device_count() if device.type == "cuda" else 0
    n_pixels = 0
    if str(args.spatial_shard) == "auto" and n_cards > 1:
        n_pixels = load_frame_data_from_file(
            args.input, frame.display_order + frame.frame_offset).n_pixels
    try:
        spatial_shard = resolve_spatial_shard(args.spatial_shard, device, n_cards, n_pixels)
    except ValueError as e:
        print(f"cc_encode: {e}", file=sys.stderr)
        return 2
    if spatial_shard > 1 and args.verbose > 0:
        print(f"spatial sharding: H over {spatial_shard} devices", flush=True)

    res = encode_one_frame(frame, cs, args.input, workdir, preset, cfg_args,
                           warp_filter_size=args.warp_filter_size, seed=args.seed,
                           verbose=args.verbose > 0, tune=args.tune,
                           rdoq=not args.no_rdoq, profile=args.profile, device=device,
                           spatial_shard=spatial_shard)
    _write_archi(os.path.join(workdir, "archi.txt"), res, verbose=args.print_detailed_archi)

    if args.nobitstream:
        print(f"--nobitstream: skipped writing {args.output} "
              f"(psnr {res['logs'].psnr_db:.3f} dB)")
        return 0

    mode = "wb" if frame.coding_order == 0 else "ab"
    with open(args.output, mode) as f:
        f.write(res["payload"])
    print(f"wrote {len(res['payload'])} bytes to {args.output} "
          f"(psnr {res['logs'].psnr_db:.3f} dB)")

    monitor = res["monitor"]
    with monitor.timed("decode_back"):
        rc = verify_decode_back(args, frame, res, workdir, seq_name, device)
    with open(os.path.join(workdir, f"{frame.display_order:04d}-encoder_stages.json"),
              "w") as f:
        json.dump({"stages_s": monitor.phase_time_sec, "iterations":
                   monitor.iterations_counter, "peak_device_bytes":
                   monitor.peak_device_bytes, "device": str(device)}, f)
    if args.verbose > 0:
        print(monitor.report(), flush=True)
    return rc


def verify_decode_back(args, frame, res, workdir: str, seq_name: str, device) -> int:
    """Decode the file back with the port's decoder (reference
    cc_encode.py:447-504): the decoder-measured quality goes to
    NNNN-results_decoder.tsv; decoder PSNR within 0.3 dB of the encoder's,
    real rate within 20 % of the encoder's estimate (the detailed logs'
    rate_bpp, latent + NN)."""
    import numpy as np

    from coolchic_tpu_torch.bitstream.decode import decode_video
    from coolchic_tpu_torch.io.io import load_frame_data_from_file
    from coolchic_tpu_torch.train.logs import write_reference_decoder_tsv
    from coolchic_tpu_torch.train.loss import dist_to_db

    decoded = decode_video(args.output, max_decoding_order=args.coding_idx, device=device)
    dec = decoded[str(frame.display_order)]
    original = load_frame_data_from_file(args.input,
                                         frame.display_order + args.frame_offset)
    if isinstance(dec.data, dict):
        n = {k: v.size for k, v in original.data.items()}
        mse = sum(float(np.mean(np.square(dec.data[k] - original.data[k]))) * n[k]
                  for k in n) / sum(n.values())
    else:
        mse = float(np.mean(np.square(np.asarray(dec.data, np.float32)
                                      - np.asarray(original.data, np.float32))))
    psnr_dec = dist_to_db(mse)
    rate_dec_bpp = 8 * res["n_bytes"] / original.n_pixels
    write_reference_decoder_tsv(
        os.path.join(workdir, f"{frame.display_order:04d}-results_decoder.tsv"),
        loss=mse + args.lmbda * rate_dec_bpp, psnr_db=psnr_dec, rate_bpp=rate_dec_bpp,
        lmbda=args.lmbda, seq_name=seq_name, n_pixels=original.n_pixels,
        display_order=frame.display_order, coding_order=frame.coding_order)

    psnr_enc = float(res["logs"].psnr_db)
    est_bpp = float(res["detailed"]["rate_bpp"])
    print(f"decoder check: psnr {psnr_dec:.3f} dB (encoder {psnr_enc:.3f}), "
          f"rate {rate_dec_bpp:.4f} bpp (encoder estimate {est_bpp:.4f})")
    if abs(psnr_dec - psnr_enc) > 0.3:
        print(f"ERROR: encoder/decoder PSNR diverge by "
              f"{abs(psnr_dec - psnr_enc):.3f} dB (> 0.3 dB)", file=sys.stderr)
        return 2
    if est_bpp > 0 and abs(rate_dec_bpp - est_bpp) / est_bpp > 0.2:
        print(f"ERROR: real rate {rate_dec_bpp:.4f} bpp diverges from encoder "
              f"estimate {est_bpp:.4f} by more than 20%", file=sys.stderr)
        return 2
    return 0


def _write_archi(path: str, res: dict, verbose: bool = False) -> None:
    """archi.txt: each cool-chic's config and its MAC per decoded pixel,
    per module (the JAX CLI's _write_archi)."""
    from coolchic_tpu_torch.utils.complexity import macs_per_module, total_mac_per_pixel

    lines = []
    for cc_name, cfg in res["fcfg"].cc_cfgs.items():
        lines.append(f"== {cc_name} ==")
        lines.append(repr(cfg))
        lines.append(f"mac_per_pixel total: {total_mac_per_pixel(cfg):.1f}")
        for mod, macs in macs_per_module(cfg).items():
            lines.append(f"mac_per_pixel {mod}: {macs:.1f}")
        lines.append("")
    text = "\n".join(lines)
    with open(path, "w") as f:
        f.write(text)
    if verbose:
        print(text, flush=True)


if __name__ == "__main__":
    sys.exit(main())
