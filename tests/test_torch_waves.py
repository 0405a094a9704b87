"""Wave encoding of a hierarchical GOP (train/video.py:encode_wave_group),
as the JAX package's tests/test_waves_e2e.py drives it: the mirrored
5-frame BQSquare clip (frames 0, 1, 2, 1, 0; here a 48x64 crop), I0, P4
and B2 encoded serially by encode_one_frame, then the widest wave (B1, B3)
as ONE batch, a cut debug recipe, `ref` profile, no RDOQ. The file of the
five frames decodes in the port within 0.3 dB of each frame's estimate,
and in the JAX package within one code value of the port's decode; a
second call on the same workdir finalizes both wave frames from their
checkpoints to the same bytes."""

import math

import numpy as np
import pytest
import torch

from coolchic_tpu.bitstream.decode import decode_video as j_decode_video
from coolchic_tpu_torch.bitstream.decode import decode_video
from coolchic_tpu_torch.io.framedata import FrameData
from coolchic_tpu_torch.io.io import load_frame_data_from_file
from coolchic_tpu_torch.io.yuv import write_yuv
from coolchic_tpu_torch.parallel.gop import gop_waves
from coolchic_tpu_torch.train.presets import PresetDebug, TrainerPhase, Warmup, WarmupPhase
from coolchic_tpu_torch.train.video import encode_one_frame, encode_wave_group
from coolchic_tpu_torch.utils.codingstructure import CodingStructure
from coolchic_tpu_torch.utils.parsecli import (
    intra_operating_points,
    motion_operating_points,
    residue_operating_points,
)
from tests.test_torch_inter_forward import load_frames

torch.set_num_threads(2)

CROP = (16, 40, 48, 64)


def make_5frame_clip(tmp_path, crop=CROP) -> str:
    """BQSquare's three frames mirrored to five (0, 1, 2, 1, 0), cropped."""
    frames = load_frames(crop)
    path = str(tmp_path / f"bqsquare5_{crop[3]}x{crop[2]}_60p_yuv420_8b.yuv")
    for t, i in enumerate((0, 1, 2, 1, 0)):
        write_yuv(FrameData(8, "yuv420", frames[i].data), path, append=t > 0)
    return path


def short_preset(lmbda: float) -> PresetDebug:
    """The debug recipe cut further (the test checks the plumbing, not the
    RD): a warm-up of 2 candidates x 5 steps, 20 + 5 main steps, 10 motion
    pretraining steps."""
    p = PresetDebug(lmbda=lmbda, start_lr=1e-2, itr_main_training=1)
    p.warmup = Warmup([WarmupPhase(candidates=2,
                                   training_phase=TrainerPhase(max_itr=5, lmbda=lmbda))])
    p.training_phases[0].max_itr = 20
    p.training_phases[1].max_itr = p.training_phases[1].patience = 5
    p.motion_pretrain_phase[0].max_itr = p.motion_pretrain_phase[0].patience = 10
    return p


def _psnr(dec, orig) -> float:
    num = sum(float(np.sum(np.square(np.asarray(dec.data[k], np.float64)
                                     - np.asarray(orig.data[k], np.float64))))
              for k in ("y", "u", "v"))
    return -10 * math.log10(num / sum(orig.data[k].size for k in ("y", "u", "v")))


@pytest.fixture(scope="module")
def waved(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("waves")
    video, work = make_5frame_clip(tmp), tmp / "work"
    work.mkdir()
    cs = CodingStructure(n_frames=5, intra_pos=[0], p_pos=[4])
    waves = gop_waves(cs)
    assert [[f.display_order for f in w] for w in waves] == [[0], [4], [2], [1, 3]]
    preset = short_preset(1e-3)
    intra = {"residue": intra_operating_points()["lop"]}
    inter = {"residue": residue_operating_points()["lop"],
             "motion": motion_operating_points()["lop"]}
    kw = dict(verbose=False, rdoq=False, device="cpu")
    results = {}
    for wave in waves[:3]:
        frame = wave[0]
        results[frame.display_order] = encode_one_frame(
            frame, cs, video, str(work), preset, intra if frame.frame_type == "I" else inter,
            **kw)
    wave = encode_wave_group(waves[3], cs, video, str(work), preset, inter, **kw)
    again = encode_wave_group(waves[3], cs, video, str(work), preset, inter, **kw)
    for frame, r in zip(waves[3], wave):
        results[frame.display_order] = r
    path = tmp / "clip.cool"
    order = sorted(range(5), key=lambda d: cs.get_frame_from_display_order(d).coding_order)
    path.write_bytes(b"".join(results[d]["payload"] for d in order))
    return video, str(path), results, wave, again


def test_wave_file_decodes_within_estimates(waved):
    video, path, results, wave, _ = waved
    assert "wave_train_phase_0" in wave[0]["monitor"].phase_time_sec
    frames = decode_video(path, device="cpu")
    assert sorted(frames) == [str(i) for i in range(5)]
    for i in range(5):
        psnr = _psnr(frames[str(i)], load_frame_data_from_file(video, i))
        assert abs(psnr - results[i]["logs"].psnr_db) < 0.3, (i, psnr,
                                                              results[i]["logs"].psnr_db)
        assert psnr > 20.0


def test_jax_decodes_the_wave_file(waved):
    _, path, _, _, _ = waved
    want = decode_video(path, device="cpu")
    got = j_decode_video(path)
    assert sorted(got) == sorted(want)
    for disp in want:
        for k in ("y", "u", "v"):
            d = np.abs(np.round(np.asarray(got[disp].data[k]) * 255)
                       - np.round(want[disp].data[k] * 255))
            assert d.max() <= 1 and (d > 0).mean() < 1e-3, (disp, k)


def test_wave_resumes_from_checkpoints(waved):
    _, _, _, wave, again = waved
    assert [r["payload"] for r in again] == [r["payload"] for r in wave]
    assert all("wave_train_phase_0" not in r["monitor"].phase_time_sec for r in again)
