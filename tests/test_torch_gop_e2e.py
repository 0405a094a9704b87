"""The port's GOP driver end to end (slow; run once, results recorded in
ROADMAP.md): the mirrored 5-frame BQSquare clip (224x128, frames 0, 1, 2,
1, 0: I0, P4, B2, B1, B3) through train/video.py:encode_video with RDOQ
on, the production presets at itr_scale 0.02 with the iteration floor
relaxed to 100, once serially and once with waves=True through the sample
driver (python -m coolchic_tpu_torch.samples.encode --waves).

Bars (ROADMAP 1.10b/c): each frame of each file decodes in the port
within 0.3 dB of its encoder estimate, and in the JAX package within one
code value of the port's decode on under 0.1 % of the samples; I0, P4 and
B2 form one-frame waves, whose slot draws the serial path's noise, so
their bytes equal the serial encode's; the wave (B1, B3) against the
serial frames, pooled, within 0.3 dB and bytes within 0.85-1.15. Also the
port's batched multi-image encode against the JAX package's, as JAX's
tests/test_batch_encode.py runs it less the mesh: kodim15 and its mirror
image as one batch, each file decoding within 0.3 dB of the encoder's
PSNR in both decoders; both packages' PSNR and bytes are printed.
"""

import math
import os

import numpy as np
import pytest
import torch

from coolchic_tpu.bitstream.decode import decode_video as j_decode_video
from coolchic_tpu_torch.bitstream.decode import decode_video
from coolchic_tpu_torch.io.io import load_frame_data_from_file
from coolchic_tpu_torch.samples import encode as sample_encode
from coolchic_tpu_torch.train.presets import Preset, TrainerPhase, Warmup
from coolchic_tpu_torch.train.video import encode_video
from tests.test_torch_waves import _psnr, make_5frame_clip

pytestmark = pytest.mark.slow
torch.set_num_threads(2)

REPO = __import__("pathlib").Path(__file__).resolve().parent.parent
KW = dict(n_frames=5, intra_pos=[0], p_pos=[4], lmbda=1e-3, itr_scale=0.02, itr_floor=100,
          seed=0, verbose=False, device="cpu")


def test_encode_video_serial_and_waves(tmp_path):
    video = make_5frame_clip(tmp_path, crop=(0, 0, 128, 224))
    serial = encode_video(video, str(tmp_path / "serial.cool"), str(tmp_path / "ws"), **KW)
    assert sample_encode.main([
        "--input", video, "--output", str(tmp_path / "waves.cool"), "--workdir",
        str(tmp_path / "ww"), "--n_frames", "5", "--intra_pos", "0", "--p_pos", "-1",
        "--lmbda", "1e-3", "--itr_scale", "0.02", "--itr_floor", "100", "--waves",
        "--device", "cpu"]) == 0
    order = [0, 4, 2, 1, 3]   # coding order
    by_disp = dict(zip(order, serial["results"]))
    w_results = {}
    for tag, path, results in (("serial", tmp_path / "serial.cool", by_disp),
                               ("waves", tmp_path / "waves.cool", None)):
        frames = decode_video(str(path), device="cpu")
        jframes = j_decode_video(str(path))
        assert sorted(frames) == sorted(jframes) == [str(i) for i in range(5)]
        for d in range(5):
            orig = load_frame_data_from_file(video, d)
            psnr = _psnr(frames[str(d)], orig)
            if results is not None:
                est = results[d]["logs"].psnr_db
            else:
                head, row = (tmp_path / "ww" / f"{d:04d}-results_encoder.tsv").read_text() \
                    .splitlines()
                rec = dict(zip(head.split("\t"), row.split("\t")))
                est = float(rec["psnr_db"])
                w_results[d] = {"psnr_db": est, "n_bytes": int(rec["n_bytes"])}
            print(f"{tag} frame {d}: decoder {psnr:.3f} dB, encoder {est:.3f} dB")
            assert abs(psnr - est) < 0.3, (tag, d, psnr, est)
            for k in ("y", "u", "v"):
                diff = np.abs(np.round(np.asarray(jframes[str(d)].data[k]) * 255)
                              - np.round(frames[str(d)].data[k] * 255))
                assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, (tag, d, k)
    for d in (0, 4, 2):
        assert w_results[d]["n_bytes"] == by_disp[d]["n_bytes"], d
    mse_w = sum(10 ** (-w_results[d]["psnr_db"] / 10) for d in (1, 3)) / 2
    mse_s = sum(10 ** (-by_disp[d]["logs"].psnr_db / 10) for d in (1, 3)) / 2
    dp = -10 * math.log10(mse_w) + 10 * math.log10(mse_s)
    ratio = sum(w_results[d]["n_bytes"] for d in (1, 3)) / sum(by_disp[d]["n_bytes"]
                                                                 for d in (1, 3))
    for d in (1, 3):
        print(f"wave vs serial frame {d}: dPSNR "
              f"{w_results[d]['psnr_db'] - by_disp[d]['logs'].psnr_db:+.3f} dB, bytes "
              f"{w_results[d]['n_bytes']} / {by_disp[d]['n_bytes']}")
    print(f"wave vs serial pooled (B1, B3): dPSNR {dp:+.3f} dB, bytes ratio {ratio:.3f}; "
          f"files serial {serial['n_bytes']} B, waves "
          f"{os.path.getsize(tmp_path / 'waves.cool')} B")
    assert abs(dp) < 0.3 and 0.85 < ratio < 1.15, (dp, ratio)


class _Fast(Preset):
    """JAX's tests/test_e2e.py:FastPreset: no warm-up, 40 + 10 iterations."""

    def __post_init__(self):
        self.preset_name = "ci"
        self.training_phases = [
            TrainerPhase(lr=self.start_lr, max_itr=40, freq_valid=20, patience=10000,
                         schedule_lr=True, quantizer_type="softround",
                         quantizer_noise_type="gaussian", softround_temperature=(0.35, 0.08),
                         noise_parameter=(0.22, 0.15), lmbda=self.lmbda,
                         dist_weight=self.dist_weight),
            TrainerPhase(lr=1e-4, max_itr=10, freq_valid=10, quantizer_type="hardround",
                         quantizer_noise_type="none", lmbda=self.lmbda,
                         dist_weight=self.dist_weight),
        ]
        self.warmup = Warmup([])


def test_batched_two_images_against_jax(tmp_path):
    from coolchic_tpu.io.images import read_png
    from coolchic_tpu.parallel.encode_batch import encode_images_batched as j_batched
    from coolchic_tpu.utils.parsecli import INTRA_OPERATING_POINTS
    from coolchic_tpu.utils.parsecli import coolchic_config_from_args as j_cfg
    from coolchic_tpu_torch.io.framedata import FrameData
    from coolchic_tpu_torch.parallel.encode_batch import encode_images_batched
    from coolchic_tpu_torch.utils.parsecli import coolchic_config_from_args, \
        intra_operating_points
    from tests.test_e2e import FastPreset

    img = str(REPO / "tests/data/192x128_kodim15.png")
    base = load_frame_data_from_file(img)
    frames = [base, FrameData(8, "rgb", np.ascontiguousarray(base.data[:, :, ::-1]))]
    jbase = read_png(img)
    jframes = [jbase, type(jbase)(bitdepth=8, frame_data_type="rgb",
                                  data=np.asarray(jbase.data)[:, :, ::-1].copy())]
    p_paths = [str(tmp_path / f"p{i}.cool") for i in range(2)]
    j_paths = [str(tmp_path / f"j{i}.cool") for i in range(2)]
    p_res = encode_images_batched(
        frames, {"residue": coolchic_config_from_args(intra_operating_points()["lop"],
                                                      base.img_size)},
        _Fast(lmbda=1e-3, start_lr=1e-2, itr_main_training=50), p_paths, seed=0,
        verbose=False, rdoq=False, device="cpu")
    j_res = j_batched(jframes, {"residue": j_cfg(INTRA_OPERATING_POINTS["lop"],
                                                 jbase.img_size)},
                      FastPreset(lmbda=1e-3, start_lr=1e-2, itr_main_training=50), j_paths,
                      seed=0, verbose=False, rdoq=False)
    for i, frame in enumerate(frames):
        for path, res in ((p_paths[i], p_res[i]), (j_paths[i], j_res[i])):
            for dec in (decode_video(path, device="cpu")["0"], j_decode_video(path)["0"]):
                d = np.asarray(dec.data, np.float64) - np.asarray(frame.data, np.float64)
                dec_psnr = -10 * math.log10(max(float((d * d).mean()), 1e-10))
                assert abs(dec_psnr - res["psnr_db"]) < 0.3, (path, dec_psnr, res["psnr_db"])
                assert dec_psnr > 20.0
        print(f"image {i}: port {p_res[i]['psnr_db']:.3f} dB {p_res[i]['n_bytes']} B, "
              f"JAX {j_res[i]['psnr_db']:.3f} dB {j_res[i]['n_bytes']} B")
