"""Per-frame encoder results TSV (one header row, one value row), mirroring
workdir/results_encoder.tsv.

Reference parity: coolchic_tpu/utils/results.py:write_frame_results.
"""

from __future__ import annotations


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
