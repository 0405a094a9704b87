"""Result TSV writers in the reference's published schema, and the
Bjontegaard delta-rate.

results/vX.Y/*.tsv columns: lmbda seq_name n_pixels loss psnr_db rate_bpp
(reference results/v5.0/image-kodak.tsv). The per-frame encoder TSV
mirrors workdir/results_encoder.tsv (one header row, one value row).

Reference parity: coolchic_tpu/utils/results.py.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np


@dataclass
class SequenceResult:
    lmbda: float
    seq_name: str
    n_pixels: int
    loss: float
    psnr_db: float
    rate_bpp: float


RESULT_HEADER = "lmbda\tseq_name\tn_pixels\tloss\tpsnr_db\trate_bpp\n"


def write_results_tsv(path: str, rows: list[SequenceResult], append: bool = False) -> None:
    """One row per result; the header is written unless appending to an
    existing file."""
    exists = os.path.exists(path) and append
    with open(path, "a" if append else "w") as f:
        if not exists:
            f.write(RESULT_HEADER)
        for r in rows:
            f.write(f"{r.lmbda}\t{r.seq_name}\t{r.n_pixels}\t{r.loss:.6f}\t"
                    f"{r.psnr_db:.4f}\t{r.rate_bpp:.6f}\n")


def write_frame_results(path: str, *, seq_name: str, lmbda: float, n_pixels: int,
                        logs, rate_bpp: float, extra: dict | None = None) -> None:
    cols = {
        "seq_name": seq_name,
        "lmbda": lmbda,
        "n_pixels": n_pixels,
        "loss": f"{logs.loss:.6f}",
        "psnr_db": f"{logs.psnr_db:.4f}",
        "rate_latent_bpp": f"{logs.total_rate_latent_bpp:.6f}",
        "rate_bpp": f"{rate_bpp:.6f}",
    }
    if extra:
        cols.update({k: str(v) for k, v in extra.items()})
    with open(path, "w") as f:
        f.write("\t".join(cols.keys()) + "\n")
        f.write("\t".join(str(v) for v in cols.values()) + "\n")


def bd_rate(rate_a: list[float], psnr_a: list[float],
            rate_b: list[float], psnr_b: list[float]) -> float:
    """Bjontegaard delta-rate of codec A against codec B in percent
    (negative: A needs fewer bits), a cubic fit of log-rate over the
    overlapping PSNR range."""
    lr_a, lr_b = np.log(rate_a), np.log(rate_b)
    pa = np.polyfit(psnr_a, lr_a, 3)
    pb = np.polyfit(psnr_b, lr_b, 3)
    lo = max(min(psnr_a), min(psnr_b))
    hi = min(max(psnr_a), max(psnr_b))
    ia = np.polyint(pa)
    ib = np.polyint(pb)
    int_a = np.polyval(ia, hi) - np.polyval(ia, lo)
    int_b = np.polyval(ib, hi) - np.polyval(ib, lo)
    avg_exp_diff = (int_a - int_b) / (hi - lo)
    return float((np.exp(avg_exp_diff) - 1) * 100)
