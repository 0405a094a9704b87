"""Detailed per-frame logs (the reference's FrameEncoderLogs,
coolchic/training/test.py:32-234): loss breakdown, per-grid and per-module
rates, decoder complexity, and the reference-schema TSV writers.

For I frames the alpha / beta and prediction fields stay 0, as the JAX
package writes them. The text files are byte-identical to the JAX
package's for the same values.

Reference parity: coolchic_tpu/train/logs.py.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from coolchic_tpu_torch.bitstream.nncodec import flatten_module_params
from coolchic_tpu_torch.io.yuv import convert_420_to_444
from coolchic_tpu_torch.models.frame import FrameConfig, frame_encoder_forward
from coolchic_tpu_torch.models.params import tree_from_numpy
from coolchic_tpu_torch.nnquant.quantize import exp_golomb_nbins
from coolchic_tpu_torch.train.loss import compute_mse, dist_to_db, loss_function
from coolchic_tpu_torch.train.params import tree_map
from coolchic_tpu_torch.utils.complexity import macs_per_module, total_mac_per_pixel


def detailed_test(params: dict, fcfg: FrameConfig, target, *, refs: Optional[list] = None,
                  cr: Optional[dict] = None,
                  dist_weight: Optional[dict] = None, lmbda: float = 1e-3,
                  nn_side_info: Optional[dict] = None,
                  encoding_time_second: float = 0.0,
                  encoding_iterations_cnt: int = 0,
                  display_order: int = 0, coding_order: int = 0,
                  frame_offset: int = 0, seq_name: str = "",
                  device: torch.device | str = "cuda") -> dict:
    """Hardround eval of one frame with an exhaustive log dictionary (the
    reference's FrameEncoderLogs field set). `params`: one image's params
    (numpy or tensors, no batch axis); `target`: its [1, C, H, W] tensor
    (or planes) on `device`; `refs`: a P/B frame's [1, 3, H, W] references
    on `device`."""
    dist_weight = dist_weight or {"mse": 1.0}
    params_dev = tree_map(lambda x: x[None], tree_from_numpy(
        tree_map(lambda x: x.detach().cpu().numpy() if torch.is_tensor(x) else x, params),
        device))
    with torch.no_grad():
        out = frame_encoder_forward(params_dev, fcfg, reference_frames=refs,
                                    training=False, cr=cr)

    n_pixels = fcfg.cc_cfgs["residue"].img_size[0] * fcfg.cc_cfgs["residue"].img_size[1]

    # --- NN rate per module (from the chosen q-steps / exp-Golomb orders).
    total_nn_bits = 0.0
    nn_rates = {}
    if nn_side_info:
        for cc_name, (q_shift, expgol) in nn_side_info.items():
            cfg = fcfg.cc_cfgs[cc_name]
            for module in ("arm", "ifce", "upsampling", "synthesis"):
                for wb in ("weight", "bias"):
                    arrays = flatten_module_params(params[cc_name], cfg, module, wb)
                    if not arrays:
                        continue
                    q = 2.0 ** q_shift[(module, wb)]
                    ints = np.concatenate([np.round(np.asarray(a) / q).reshape(-1)
                                           for a in arrays])
                    bits = exp_golomb_nbins(ints, expgol[(module, wb)])
                    nn_rates[f"{cc_name}_{module}_{wb}_bpp"] = bits / n_pixels
                    total_nn_bits += bits

    with torch.no_grad():
        lo = loss_function(out.decoded_image, out.rate, target, dist_weight, lmbda,
                           total_rate_nn_bit=total_nn_bits)

    logs = {
        "loss": float(lo.loss[0]),
        "psnr_db": dist_to_db(float(lo.mse[0])),
        "dist": float(lo.dist[0]),
        "rate_bpp": float(lo.rate_bpp[0]),
        "rate_latent_bpp": float(lo.total_rate_latent_bpp[0]),
        "rate_nn_bpp": total_nn_bits / n_pixels,
        "n_pixels": n_pixels,
    }
    logs.update(nn_rates)

    # --- Per-cool-chic and per-grid latent rates.
    rates = {name: out.rate[name][0].cpu().numpy() for name in fcfg.cc_cfgs}
    for cc_name, cfg in fcfg.cc_cfgs.items():
        rate = rates[cc_name]
        logs[f"{cc_name}_rate_bpp"] = float(rate.sum()) / n_pixels
        ptr = 0
        for i, (h, w) in enumerate(cfg.size_per_latent):
            n = h * w
            logs[f"{cc_name}_grid{i}_bpp"] = float(rate[ptr:ptr + n].sum()) / n_pixels
            ptr += n
        logs[f"{cc_name}_mac_per_pixel"] = total_mac_per_pixel(cfg)
        for mod, macs in macs_per_module(cfg).items():
            logs[f"{cc_name}_{mod}_mac_per_pixel"] = macs

    # --- Inter-frame intermediates: alpha/beta means, prediction quality
    # (reference test.py:160-207); the dummy prediction is the mean of the
    # unshifted references.
    logs["alpha_mean"] = 0.0
    logs["beta_mean"] = 0.0
    logs["pred_psnr_db"] = 0.0
    logs["dummy_pred_psnr_db"] = 0.0
    if out.additional_data is not None:
        ad = out.additional_data
        logs["alpha_mean"] = float(ad["alpha"].mean())
        if ad["beta"] is not None:
            logs["beta_mean"] = float(ad["beta"].mean())
        if isinstance(target, dict):
            tgt_dense = torch.as_tensor(convert_420_to_444(
                {k: v.cpu().numpy() for k, v in target.items()}), device=ad["pred"].device)
        else:
            tgt_dense = target
        with torch.no_grad():
            logs["pred_psnr_db"] = dist_to_db(float(compute_mse(ad["pred"], tgt_dense)[0]))
            if refs:
                dummy = sum(refs) / len(refs)
                logs["dummy_pred_psnr_db"] = dist_to_db(
                    float(compute_mse(dummy, tgt_dense)[0]))

    # --- Per-feature rate list + spatial rate map summary (reference
    # test.py:208-234: per-latent-grid bpp is the feature axis; the spatial
    # map is each grid's rate nearest-upsampled to img_size and summed).
    h_img, w_img = fcfg.cc_cfgs["residue"].img_size
    spatial = np.zeros((h_img, w_img), np.float32)
    feature_rate_bpp = []
    for cc_name, cfg in fcfg.cc_cfgs.items():
        rate = rates[cc_name]
        ptr = 0
        for (h, w) in cfg.size_per_latent:
            n = h * w
            grid_rate = rate[ptr:ptr + n].reshape(h, w)
            feature_rate_bpp.append(float(grid_rate.sum()) / n_pixels)
            # nearest-upsample to image size, normalized per covered pixels
            yy = (np.arange(h_img) * h // h_img).clip(0, h - 1)
            xx = (np.arange(w_img) * w // w_img).clip(0, w - 1)
            spatial += grid_rate[np.ix_(yy, xx)] / ((h_img * w_img) / n)
            ptr += n
    logs["feature_rate_bpp"] = feature_rate_bpp
    logs["spatial_rate_bit_max"] = float(spatial.max())
    logs["spatial_rate_bit_mean"] = float(spatial.mean())

    # --- Frame metadata + encoder counters (reference-named columns).
    logs["lmbda"] = lmbda
    logs["time_sec"] = encoding_time_second
    logs["itr"] = encoding_iterations_cnt
    logs["img_size"] = f"{h_img}x{w_img}"
    logs["display_order"] = display_order
    logs["coding_order"] = coding_order
    logs["frame_offset"] = frame_offset
    logs["seq_name"] = seq_name

    # YUV420 per-channel PSNR.
    if isinstance(out.decoded_image, dict):
        for k in ("y", "u", "v"):
            mse_k = float(compute_mse(out.decoded_image[k], target[k])[0])
            logs[f"psnr_{k}_db"] = dist_to_db(mse_k)

    return logs


# --------------------------------------------------------------------------
# Reference-schema TSV writers + pretty printer (training/test.py:236-443).
# --------------------------------------------------------------------------
_NN_COLS = [f"{cc}_{mod}_{wb}_rate_bpp"
            for cc in ("residue", "motion")
            for mod in ("arm", "ifce", "upsampling", "synthesis")
            for wb in ("weight", "bias")]

# results_encoder.tsv column order, matched to the reference dump
# (see results/round3/ref/kodim15_l1e-3/0000-results_encoder.tsv header).
REFERENCE_ENCODER_COLUMNS = (
    ["loss", "nn_bpp", "latent_bpp", "dist_db", "psnr_db", "rate_bpp",
     "lmbda", "time_sec", "itr", "mac_decoded_pixel", "residue_bpp",
     "motion_bpp", "alpha", "beta", "pred_db", "dummy_pred", "img_size",
     "n_pixels", "display_order", "coding_order", "frame_offset", "seq_name"]
    + _NN_COLS)

_COL_WIDTH = 10


def _fmt(v, acc: int = 6) -> str:
    if isinstance(v, float):
        return f"{v:.{acc}f}"
    return str(v)


def reference_encoder_row(logs: dict) -> dict:
    """Map a detailed_test dict onto the reference encoder-TSV columns."""
    row = {
        "loss": _fmt(logs["loss"]),
        "nn_bpp": _fmt(logs.get("rate_nn_bpp", 0.0)),
        "latent_bpp": _fmt(logs.get("rate_latent_bpp", 0.0)),
        "dist_db": _fmt(logs.get("psnr_db", 0.0)),
        "psnr_db": _fmt(logs.get("psnr_db", 0.0)),
        "rate_bpp": _fmt(logs.get("rate_bpp", 0.0)),
        "lmbda": _fmt(float(logs.get("lmbda", 0.0))),
        "time_sec": _fmt(float(logs.get("time_sec", 0.0)), 1),
        "itr": str(logs.get("itr", 0)),
        "mac_decoded_pixel": _fmt(float(
            sum(v for k, v in logs.items() if k.endswith("_mac_per_pixel")
                and k.count("_") == 3))),
        "residue_bpp": _fmt(logs.get("residue_rate_bpp", 0.0)),
        "motion_bpp": _fmt(logs.get("motion_rate_bpp", 0)) if
        "motion_rate_bpp" in logs else "0",
        "alpha": _fmt(logs.get("alpha_mean", 0.0), 3),
        "beta": _fmt(logs.get("beta_mean", 0.0), 3),
        "pred_db": _fmt(logs.get("pred_psnr_db", 0.0), 3),
        "dummy_pred": _fmt(logs.get("dummy_pred_psnr_db", 0.0), 3),
        "img_size": str(logs.get("img_size", "")),
        "n_pixels": str(logs.get("n_pixels", 0)),
        "display_order": str(logs.get("display_order", 0)),
        "coding_order": str(logs.get("coding_order", 0)),
        "frame_offset": str(logs.get("frame_offset", 0)),
        "seq_name": str(logs.get("seq_name", "")),
    }
    for col in _NN_COLS:
        src = col[: -len("_rate_bpp")] + "_bpp"   # e.g. residue_arm_weight_bpp
        row[col] = _fmt(logs[src]) if src in logs else "0"
    return row


def write_reference_encoder_tsv(path: str, logs: dict) -> None:
    """results_encoder.tsv with the reference's exact column set/order."""
    row = reference_encoder_row(logs)
    with open(path, "w") as f:
        f.write("".join(f"{c:<{max(_COL_WIDTH, len(c))}} "
                        for c in REFERENCE_ENCODER_COLUMNS).rstrip() + " \n")
        f.write("".join(f"{row[c]:<{max(_COL_WIDTH, len(c))}} "
                        for c in REFERENCE_ENCODER_COLUMNS).rstrip() + " \n")


def write_reference_decoder_tsv(path: str, *, loss: float, psnr_db: float,
                                rate_bpp: float, lmbda: float, seq_name: str,
                                n_pixels: int, display_order: int = 0,
                                coding_order: int = 0) -> None:
    """results_decoder.tsv, column-identical to the reference
    (cc_encode.py:470-504): loss psnr_db rate_bpp lmbda seq_name n_pixels
    display_order coding_order."""
    cols = [("loss", f"{loss:.7f}"), ("psnr_db", f"{psnr_db:.7f}"),
            ("rate_bpp", f"{rate_bpp:.7f}"), ("lmbda", f"{lmbda:g}"),
            ("seq_name", seq_name), ("n_pixels", str(n_pixels)),
            ("display_order", str(display_order)),
            ("coding_order", str(coding_order))]
    with open(path, "w") as f:
        f.write("".join(f"{k:<{max(_COL_WIDTH, len(v), len(k))}}   "
                        for k, v in cols).rstrip() + " \n")
        f.write("".join(f"{v:<{max(_COL_WIDTH, len(v), len(k))}}   "
                        for k, v in cols).rstrip() + " \n")


def write_detailed_tsv(path: str, logs: dict) -> None:
    """NNNN-logs_detailed.tsv: every key of a detailed_test dict, one row
    (coolchic_tpu/train/video.py:_finalize_frame's layout)."""
    keys = list(logs)
    with open(path, "w") as f:
        f.write("\t".join(keys) + "\n")
        f.write("\t".join(f"{logs[k]:.6f}" if isinstance(logs[k], float)
                          else str(logs[k]) for k in keys) + "\n")


def pretty_string(logs: dict, show_col_name: bool = True,
                  mode: str = "all") -> str:
    """Reference-style fixed-width log row (training/test.py:236-443):
    'short' = the always-printed subset, 'all' = every column incl. the
    per-feature rates and the per-module NN rates."""
    short_cols = ["loss", "psnr_db", "latent_bpp", "nn_bpp", "rate_bpp",
                  "time_sec", "itr"]
    row = reference_encoder_row(logs)
    row["loss"] = f"{logs['loss'] * 1000:.6f}"   # reference prints loss x1e3
    cols = short_cols if mode == "short" else list(REFERENCE_ENCODER_COLUMNS)
    if mode != "short":
        for i, v in enumerate(logs.get("feature_rate_bpp", [])):
            c = f"feature_rate_bpp_{i:02d}"
            cols.append(c)
            row[c] = _fmt(v)
    header = "".join(f"{c:<{max(_COL_WIDTH, len(c))}} " for c in cols)
    values = "".join(f"{row.get(c, '0'):<{max(_COL_WIDTH, len(c))}} "
                     for c in cols)
    return header + "\n" + values if show_col_name else values


def pretty_logs(logs: dict) -> str:
    keys = ["loss", "psnr_db", "rate_bpp", "rate_latent_bpp", "rate_nn_bpp"]
    s = " | ".join(f"{k} {logs[k]:.5f}" for k in keys if k in logs)
    extras = {k: v for k, v in logs.items() if k.endswith("mac_per_pixel")}
    if extras:
        s += " | " + " ".join(f"{k}={v:.0f}" for k, v in extras.items())
    return s
