"""End to end: the port's CLI (python -m coolchic_tpu_torch.cc_encode) on
the CPU (intra lop, debug recipe: warm-up 3x10 + 2x10, training 50 + 10).
It encodes a 64x96 crop of kodim15 with --no_rdoq in both bitstream
profiles, and the whole 192x128 kodim15 with its defaults (RDOQ on). Its
own decode-back check passes (exit code 0), and the file decodes with the
JAX package's decode_video and with the port's, to images equal within one
8-bit code value on under 1 % of the samples (ROADMAP.md Queue 3: f32
summation order in the float tail) and to the encoder's own decoded frame;
the workdir holds archi.txt and the summary, reference-schema, detailed
and decoder TSVs, which parse. (tests/test_torch_wasserstein.py runs the
--tune wasserstein CLI.)

The slow test holds the port's encoder to the JAX encoder at a matched
budget (192x128 kodim15, lop, debug recipe, seeds 0 and 1, with --no_rdoq
and with RDOQ), by the repo's trainer-against-trainer bar
(tests/test_waves_e2e.py): per encode PSNR within 0.5 dB and bytes within
0.85-1.15 of JAX's, pooled over the seeds PSNR within 0.3 dB and bytes
within 0.85-1.15. The noise streams differ (JAX's PRNG cannot be reproduced
in torch), so the two encodes are equal in RD terms, not bit for bit.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from coolchic_tpu.bitstream.decode import decode_video as j_decode_video
from coolchic_tpu_torch import cc_encode
from coolchic_tpu_torch.bitstream.decode import decode_video as p_decode_video
from coolchic_tpu_torch.io.framedata import FrameData
from coolchic_tpu_torch.io.io import load_frame_data_from_file, save_frame_data_to_file

torch.set_num_threads(2)
REPO = __import__("pathlib").Path(__file__).resolve().parent.parent
IMG = str(REPO / "tests/data/192x128_kodim15.png")


def _crop_ppm(path, h=64, w=96):
    frame = load_frame_data_from_file(IMG)
    save_frame_data_to_file(FrameData(8, "rgb", frame.data[..., 32:32 + h, 48:48 + w]),
                            path)
    return path


def _close_8bit(a, b):
    diff = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    assert diff.max() <= 1 / 255 + 1e-6 and (diff > 1e-6).mean() < 1e-2


@pytest.mark.parametrize("profile", ["ref", "tpu"])
def test_cli_encode_decodes_with_jax_and_port(profile, tmp_path):
    src = _crop_ppm(str(tmp_path / "crop.ppm"))
    out = str(tmp_path / "out.cool")
    rc = cc_encode.main(["-i", src, "-o", out, "--workdir", str(tmp_path / "wd"),
                         "--recipe", "debug", "--dec_cfg_residue", "lop", "--lmbda", "1e-3",
                         "--profile", profile, "--no_rdoq", "--device", "cpu"])
    assert rc == 0
    with open(out, "rb") as f:
        assert (f.read(4) == b"CCTP") == (profile == "tpu")
    j_dec = j_decode_video(out)["0"].data
    p_dec = p_decode_video(out, device="cpu")["0"].data
    assert np.asarray(p_dec).shape == (1, 3, 64, 96)
    _close_8bit(p_dec, j_dec)
    enc_dec = load_frame_data_from_file(str(tmp_path / "wd" / "0000-decoded.ppm")).data
    _close_8bit(p_dec, enc_dec)
    assert (tmp_path / "wd" / "0000-results_encoder.tsv").exists()


def check_workdir_logs(wd):
    """archi.txt and the four TSVs of frame 0 exist and parse; returns the
    detailed log row."""
    assert "mac_per_pixel total" in (wd / "archi.txt").read_text()
    for name in ("results_encoder_ref", "results_decoder"):
        head, row = (wd / f"0000-{name}.tsv").read_text().splitlines()
        assert len(head.split()) == len(row.split()) > 5, name
    head, row = (wd / "0000-logs_detailed.tsv").read_text().splitlines()
    detailed = dict(zip(head.split("\t"), row.split("\t")))
    assert len(detailed) == len(head.split("\t")) == len(row.split("\t"))
    assert float(detailed["rate_bpp"]) > float(detailed["rate_latent_bpp"]) > 0
    return detailed


def test_cli_rdoq_default_decodes_with_jax_and_port(tmp_path):
    """192x128 kodim15, lop, debug recipe, RDOQ on (the CLI's default)."""
    out, wd = str(tmp_path / "out.cool"), tmp_path / "wd"
    rc = cc_encode.main(["-i", IMG, "-o", out, "--workdir", str(wd), "--recipe", "debug",
                         "--dec_cfg_residue", "lop", "--lmbda", "1e-3", "--device", "cpu"])
    assert rc == 0
    stages = __import__("json").loads((wd / "0000-encoder_stages.json").read_text())
    assert stages["stages_s"]["rdoq"] > 0
    j_dec = j_decode_video(out)["0"].data
    p_dec = p_decode_video(out, device="cpu")["0"].data
    assert np.asarray(p_dec).shape == (1, 3, 128, 192)
    _close_8bit(p_dec, j_dec)
    _close_8bit(p_dec, load_frame_data_from_file(str(wd / "0000-decoded.png")).data)
    check_workdir_logs(wd)


def _rd(result_tsv):
    with open(result_tsv) as f:
        head, row = f.read().strip().splitlines()[:2]
    vals = dict(zip(head.split("\t"), row.split("\t")))
    return float(vals["psnr_db"]), int(vals["n_bytes"])


# The JAX CLI run as on an accelerator, where it trains the warm-up
# candidates as one batch (train/video.py picks the serial tournament when
# jax.default_backend() is "cpu"): the port's warm-up is that batched one.
_JAX_BATCHED_WARMUP = ("import runpy, sys, jax; jax.default_backend = lambda: 'gpu'; "
                       "sys.argv = sys.argv[1:]; "
                       "runpy.run_path(sys.argv[0], run_name='__main__')")


@pytest.mark.slow
@pytest.mark.parametrize("rdoq", [False, True])
def test_rd_matches_jax_encoder(rdoq, tmp_path):
    """Seeds 0 and 1, each encoded by both CLIs (with --no_rdoq, or with
    RDOQ); per encode |dPSNR| < 0.5 dB and bytes ratio within 0.85-1.15,
    pooled (MSE and bytes summed over the two) |dPSNR| < 0.3 dB and bytes
    ratio within 0.85-1.15. The JAX CLI with its batched warm-up is printed
    beside them, with each encode's RD loss (MSE + lambda * bpp, the
    training objective)."""
    common = ["-i", IMG, "--recipe", "debug", "--dec_cfg_residue", "lop", "--lmbda", "1e-3",
              *([] if rdoq else ["--no_rdoq"])]
    mse, n_bytes = {"jax": 0.0, "port": 0.0}, {"jax": 0, "port": 0}
    n_px = 192 * 128
    for seed in ("0", "1"):
        wd = {k: tmp_path / f"{k}{seed}" for k in ("jax", "jax_batched_warmup", "port")}
        for k, pre in (("jax", []), ("jax_batched_warmup", ["-c", _JAX_BATCHED_WARMUP])):
            subprocess.run([sys.executable, *pre, str(REPO / "cc_encode.py"), *common,
                            "--cpu", "--seed", seed, "-o", str(wd[k] / "out.cool"),
                            "--workdir", str(wd[k])], cwd=REPO, check=True, timeout=3000)
        assert cc_encode.main([*common, "--device", "cpu", "--seed", seed, "-o",
                               str(wd["port"] / "out.cool"), "--workdir",
                               str(wd["port"])]) == 0
        rd = {k: _rd(d / "0000-results_encoder.tsv") for k, d in wd.items()}
        print(f"RD kodim15 lop debug rdoq={rdoq} seed {seed}: " + ", ".join(
            f"{k} {p:.3f} dB {b} B (loss {10 ** (-p / 10) + 1e-3 * 8 * b / n_px:.5e})"
            for k, (p, b) in rd.items()))
        (j_psnr, j_bytes), (p_psnr, p_bytes) = rd["jax"], rd["port"]
        assert abs(p_psnr - j_psnr) < 0.5
        assert 0.85 < p_bytes / j_bytes < 1.15
        for k, psnr, b in (("jax", j_psnr, j_bytes), ("port", p_psnr, p_bytes)):
            mse[k] += 10 ** (-psnr / 10)
            n_bytes[k] += b
    dp = 10 * np.log10(mse["jax"] / mse["port"])
    ratio = n_bytes["port"] / n_bytes["jax"]
    print(f"RD pooled rdoq={rdoq}: port - jax {dp:+.3f} dB, bytes ratio {ratio:.3f}")
    assert abs(dp) < 0.3
    assert 0.85 < ratio < 1.15
