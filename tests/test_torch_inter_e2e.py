"""RD of the port's video encoder against the JAX encoder at a matched
budget (slow): BQSquare 224x128, I0 (intra lop), P2 and B1 (residue lop,
motion lop), tests/test_e2e_video.py's FastVideoPreset (40 + 10 steps, no
warm-up, 20 motion-pretraining steps for P/B), --no_rdoq, CPU, seeds 0 and
1, each frame encoded by train/video.py:encode_one_frame of both packages
into its own workdir. Pooled over the frames and seeds (MSE and bytes
summed) |dPSNR| < 0.3 dB and a bytes ratio within 0.85-1.15. Each package
decodes its own file back within 0.3 dB. A single encode is not held to
JAX's: at this budget (50 steps from scratch) one frame's RD moves by
0.8 dB and 40 % of its bytes from one seed to the next, in either
package.
"""

import numpy as np
import pytest
import torch

from coolchic_tpu.bitstream.decode import decode_video as j_decode_video
from coolchic_tpu.train.video import encode_one_frame as j_encode_one_frame
from coolchic_tpu.utils.codingstructure import CodingStructure as JCodingStructure
from coolchic_tpu.utils.parsecli import (
    INTRA_OPERATING_POINTS,
    MOTION_OPERATING_POINTS,
    RESIDUE_OPERATING_POINTS,
)
from coolchic_tpu_torch.bitstream.decode import decode_video as p_decode_video
from coolchic_tpu_torch.io.io import load_frame_data_from_file
from coolchic_tpu_torch.train import presets as PP
from coolchic_tpu_torch.train.video import encode_one_frame as p_encode_one_frame
from coolchic_tpu_torch.utils.codingstructure import CodingStructure
from tests.test_e2e_video import FastVideoPreset as JFastVideoPreset

torch.set_num_threads(2)
REPO = __import__("pathlib").Path(__file__).resolve().parent.parent
VIDEO = str(REPO / "tests/data/D-BQSquare-3frames_224x128_60p_yuv420_8b.yuv")


class FastVideoPreset(PP.Preset):
    """tests/test_e2e_video.py's FastVideoPreset with the port's phases."""

    def __post_init__(self):
        self.preset_name = "ci-video"
        self.training_phases = [
            PP.TrainerPhase(lr=self.start_lr, max_itr=40, freq_valid=20, patience=10000,
                            schedule_lr=True, quantizer_type="softround",
                            quantizer_noise_type="gaussian",
                            softround_temperature=(0.3, 0.1), noise_parameter=(0.25, 0.1),
                            lmbda=self.lmbda),
            PP.TrainerPhase(lr=1e-4, max_itr=10, freq_valid=10, quantizer_type="hardround",
                            quantizer_noise_type="none", lmbda=self.lmbda),
        ]
        self.warmup = PP.Warmup([])
        if self.itr_motion_pretrain > 0:
            self.motion_pretrain_phase = [
                PP.TrainerPhase(lr=1e-2, max_itr=self.itr_motion_pretrain,
                                freq_valid=self.itr_motion_pretrain, patience=10**6,
                                quantizer_type="softround", quantizer_noise_type="kumaraswamy",
                                softround_temperature=(0.3, 0.3), noise_parameter=(2.0, 2.0),
                                lmbda=20 * self.lmbda),
            ]


def _psnr(dec, orig) -> float:
    num = sum(float(np.sum(np.square(np.asarray(dec.data[k], np.float64) - orig.data[k])))
              for k in ("y", "u", "v"))
    return -10 * np.log10(num / sum(orig.data[k].size for k in ("y", "u", "v")))


@pytest.mark.slow
def test_video_rd_matches_jax_encoder(tmp_path):
    mse = {"jax": 0.0, "port": 0.0}
    n_bytes = {"jax": 0, "port": 0}
    for seed in (0, 1):
        for pkg in ("jax", "port"):
            cs = (JCodingStructure if pkg == "jax" else CodingStructure)(
                n_frames=3, intra_pos=[0], p_pos=[2])
            work = tmp_path / f"{pkg}{seed}"
            work.mkdir()
            payload = b""
            psnr_enc = {}
            for coding_idx in range(3):
                frame = cs.get_frame_from_coding_order(coding_idx)
                inter = frame.frame_type != "I"
                kw = dict(lmbda=1e-3, start_lr=1e-2, itr_main_training=50,
                          itr_motion_pretrain=20 if inter else 0)
                preset = (JFastVideoPreset if pkg == "jax" else FastVideoPreset)(**kw)
                cfg_args = ({"residue": RESIDUE_OPERATING_POINTS["lop"],
                             "motion": MOTION_OPERATING_POINTS["lop"]} if inter
                            else {"residue": INTRA_OPERATING_POINTS["lop"]})
                if pkg == "jax":
                    res = j_encode_one_frame(frame, cs, VIDEO, str(work), preset, cfg_args,
                                             seed=seed, verbose=False, rdoq=False)
                else:
                    res = p_encode_one_frame(frame, cs, VIDEO, str(work), preset, cfg_args,
                                             seed=seed, verbose=False, rdoq=False,
                                             device="cpu")
                payload += res["payload"]
                psnr_enc[frame.display_order] = res["logs"].psnr_db
                n_bytes[pkg] += res["n_bytes"]
            (work / "out.cool").write_bytes(payload)
            decoded = (j_decode_video if pkg == "jax" else
                       lambda p: p_decode_video(p, device="cpu"))(str(work / "out.cool"))
            for disp, psnr in psnr_enc.items():
                orig = load_frame_data_from_file(VIDEO, disp)
                assert abs(_psnr(decoded[str(disp)], orig) - psnr) < 0.3
                mse[pkg] += 10 ** (-psnr / 10)
            print(f"seed {seed} {pkg}: " + ", ".join(
                f"frame {d} {p:.3f} dB" for d, p in sorted(psnr_enc.items()))
                + f", {len(payload)} bytes")
    dp = 10 * np.log10(mse["jax"] / mse["port"])
    ratio = n_bytes["port"] / n_bytes["jax"]
    print(f"video RD pooled: port - jax {dp:+.3f} dB, bytes ratio {ratio:.3f}")
    assert abs(dp) < 0.3
    assert 0.85 < ratio < 1.15


def test_fast_video_preset_matches_jax():
    """The port's copy of the preset has JAX's phases."""
    kw = dict(lmbda=1e-3, start_lr=1e-2, itr_main_training=50, itr_motion_pretrain=20)
    j, p = JFastVideoPreset(**kw), FastVideoPreset(**kw)
    assert repr(p.training_phases) == repr(j.training_phases)
    assert repr(p.warmup) == repr(j.warmup)
    assert repr(p.motion_pretrain_phase) == repr(j.motion_pretrain_phase)
