"""The port's sample drivers (python -m coolchic_tpu_torch.samples.<name>)
run on the CPU at small sizes: getcodingstruct prints what the JAX
package's samples/getcodingstruct.py prints; encode_batch writes one file
per image and the results TSV, which decode_batch decodes back; the image
sweep of encode writes the published results schema; encode_kodak_batch
(mixed-λ pairs) and encode_sweep (with its decode-back check) run on
small images; the JAX drivers' --cpu flag is refused with a message that names
--device and the multi-device roadmap item. The video mode of encode
(encode_video, --waves) runs in the slow tests/test_torch_gop_e2e.py."""

import glob
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from coolchic_tpu_torch.io.framedata import FrameData
from coolchic_tpu_torch.io.io import load_frame_data_from_file, save_frame_data_to_file
from coolchic_tpu_torch.samples import (
    decode_batch,
    encode,
    encode_batch,
    encode_kodak_batch,
    encode_sweep,
    getcodingstruct,
)
from coolchic_tpu_torch.utils.results import RESULT_HEADER

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
IMG = str(REPO / "tests/data/192x128_kodim15.png")


def _crops(tmp_path, n=2, h=32, w=48):
    base = np.asarray(load_frame_data_from_file(IMG).data)
    d = tmp_path / "imgs"
    d.mkdir()
    for i in range(n):
        y, x = 24 * i, 40 * i
        save_frame_data_to_file(FrameData(8, "rgb", np.ascontiguousarray(
            base[:, :, y:y + h, x:x + w])), str(d / f"img{i}.ppm"))
    return d


@pytest.mark.parametrize("argv", [["--n_frames", "9", "--p_pos", "-1", "--diagram",
                                   "--slurm_template", "encode_frame.sh"],
                                  ["--n_frames", "17", "--intra_pos", "0,8", "--p_pos", "4,16"]])
def test_getcodingstruct_prints_as_jax(argv, capsys):
    assert getcodingstruct.main(argv) == 0
    got = capsys.readouterr()
    want = subprocess.run([sys.executable, str(REPO / "samples/getcodingstruct.py"), *argv],
                          cwd=REPO, capture_output=True, text=True, check=True, timeout=120)
    assert got.out == want.stdout
    assert got.err == want.stderr


def test_encode_batch_then_decode_batch(tmp_path):
    imgs = _crops(tmp_path)
    out = tmp_path / "out"
    assert encode_batch.main(["--inputs", str(imgs / "*.ppm"), "--out_dir", str(out),
                              "--recipe", "debug", "--dec_cfg_residue", "lop",
                              "--profile", "tpu", "--device", "cpu"]) == 0
    head, *rows = (out / "results.tsv").read_text().splitlines()
    assert head + "\n" == RESULT_HEADER and len(rows) == 2
    dec = tmp_path / "dec"
    assert decode_batch.main(["-i", str(out / "*.cool"), "-o", str(dec), "--ext", "ppm",
                              "--device", "cpu"]) == 0
    for row in rows:
        name, psnr = row.split("\t")[1], float(row.split("\t")[4])
        d = (np.asarray(load_frame_data_from_file(str(dec / f"{name}.ppm")).data, np.float64)
             - np.asarray(load_frame_data_from_file(str(imgs / f"{name}.ppm")).data))
        assert abs(-10 * math.log10(float(np.mean(d * d))) - psnr) < 0.3


def test_encode_image_sweep_writes_results(tmp_path):
    imgs = _crops(tmp_path, n=1)
    res = tmp_path / "results.tsv"
    assert encode.main(["--image_dir", str(imgs), "--lmbdas", "1e-3,4e-3", "--recipe", "debug",
                        "--dec_cfg_residue", "lop", "--results", str(res),
                        "--workdir", str(tmp_path / "w"), "--device", "cpu"]) == 0
    head, *rows = res.read_text().splitlines()
    assert head + "\n" == RESULT_HEADER
    assert [r.split("\t")[:2] for r in rows] == [["0.001", "img0"], ["0.004", "img0"]]
    assert len(glob.glob(str(tmp_path / "w" / "*.cool"))) == 2


def test_encode_kodak_batch_pairs(tmp_path):
    out = tmp_path / "k"
    assert encode_kodak_batch.main(["--n_images", "1", "--chunk", "2", "--crop", "32x48",
                                    "--recipe", "debug", "--op", "lop", "--pairs",
                                    "--lmbdas", "1e-3,2e-3", "--no_rdoq", "--out", str(out),
                                    "--device", "cpu"]) == 0
    rows = (out / "image-kodak-batch.tsv").read_text().splitlines()[1:]
    assert [r.split("\t")[0] for r in rows] == ["0.001", "0.002"]
    assert len(glob.glob(str(out / "*.cool"))) == 2
    assert len((out / "image-kodak-rows.tsv").read_text().splitlines()) == 3


def test_encode_sweep_checks_decode_back(tmp_path):
    out = tmp_path / "s"
    src = _crops(tmp_path, n=1) / "img0.ppm"
    assert encode_sweep.main(["--kodim14-set", "--source", str(src), "--n-images", "2",
                              "--chunk", "2", "--lmbdas", "1e-3", "--n-itr", "30",
                              "--itr-floor", "30", "--op", "lop", "--out", str(out),
                              "--device", "cpu"]) == 0
    rows = (out / "image-kodak-recompression-sweep.tsv").read_text().splitlines()
    assert rows[0] + "\n" == RESULT_HEADER and len(rows) == 3
    assert (out / "batch_encode.json").exists()


@pytest.mark.parametrize("driver", [encode_batch, encode_kodak_batch, encode_sweep, encode,
                                    decode_batch])
def test_jax_cpu_flag_refused(driver, capsys):
    argv = {encode_batch: ["--inputs", "x", "--out_dir", "y"],
            decode_batch: ["-i", "x", "-o", "y"]}.get(driver, [])
    with pytest.raises(SystemExit) as exc:
        driver.main([*argv, "--cpu"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "--device cpu" in err and "1.12" in err
