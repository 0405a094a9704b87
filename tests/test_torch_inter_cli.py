"""The port's CLI on a clip: I0, P2 and B1 of a 3-frame 48x64 crop of
BQSquare (yuv420, written to tmp_path), coding indices 0, 1, 2 into one
workdir and one file, through coolchic_tpu_torch.cc_encode.main with
--recipe debug --profile tpu --device cpu, residue lop (motion at the
CLI's default mop, filter 8), RDOQ on for P and B. Each exits 0, which
carries its own decode-back bars (PSNR within 0.3 dB, real rate within
20 % of the estimate). At lambda 1e-3 the `tpu` profile's per-stream
overhead alone breaks the rate bar on a frame this small (ROADMAP.md
Queue 3), so the clip runs at 1e-4. The JAX package's decode_video reads
the port's file within one code value of the port's own decode.
"""

import numpy as np
import pytest
import torch

from coolchic_tpu.bitstream.decode import decode_video as j_decode_video
from coolchic_tpu_torch import cc_encode
from coolchic_tpu_torch.bitstream.decode import decode_video as p_decode_video
from coolchic_tpu_torch.io.framedata import FrameData
from coolchic_tpu_torch.io.yuv import write_yuv
from tests.test_torch_inter_forward import load_frames

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def encoded(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("clip")
    clip = tmp / "crop_64x48_60p_yuv420_8b.yuv"
    for t, f in enumerate(load_frames((16, 40, 48, 64))):
        write_yuv(FrameData(8, "yuv420", f.data), str(clip), append=t > 0)
    out, work = tmp / "out.cool", tmp / "work"
    rcs = []
    for coding_idx in range(3):
        rcs.append(cc_encode.main(
            ["-i", str(clip), "-o", str(out), "--workdir", str(work), "--n_frames", "3",
             "--intra_pos", "0", "--p_pos", "-1", "--coding_idx", str(coding_idx),
             "--recipe", "debug", "--profile", "tpu", "--device", "cpu", "--lmbda", "1e-4",
             "--dec_cfg_residue", "lop"] + (["--no_rdoq"] if coding_idx == 0 else [])))
    return rcs, out, work


def test_cli_encodes_i_p_b(encoded):
    import json

    rcs, out, work = encoded
    assert rcs == [0, 0, 0]
    for disp, ftype in ((0, "I"), (2, "P"), (1, "B")):
        stages = json.loads((work / f"{disp:04d}-encoder_stages.json").read_text())["stages_s"]
        if ftype != "I":
            for k in ("global_translation", "flow", "motion_pretrain", "warmup",
                      "nn_quantize", "rdoq", "rdoq_motion", "decode_back"):
                assert stages[k] > 0, (ftype, k)
        head, row = (work / f"{disp:04d}-logs_detailed.tsv").read_text().splitlines()
        logs = dict(zip(head.split("\t"), row.split("\t")))
        assert logs["frame_type"] == ftype
        assert (float(logs["alpha_mean"]) > 0) == (ftype != "I")
        assert (float(logs["beta_mean"]) > 0) == (ftype == "B")
        assert (work / f"{disp:04d}-results_decoder.tsv").exists()
    assert "== motion ==" in (work / "archi.txt").read_text()


def test_cc_decode_writes_every_frame(encoded, tmp_path):
    """python -m coolchic_tpu_torch.cc_decode on the I+P+B file: one .yuv
    holding the three frames in display order, as decode_video returns
    them."""
    from coolchic_tpu_torch import cc_decode
    from coolchic_tpu_torch.io.io import load_frame_data_from_file

    _, out, _ = encoded
    yuv = tmp_path / "dec_64x48_60p_yuv420_8b.yuv"
    assert cc_decode.main(["-i", str(out), "-o", str(yuv), "--device", "cpu"]) == 0
    want = p_decode_video(str(out), device="cpu")
    assert yuv.stat().st_size == 3 * 48 * 64 * 3 // 2
    for disp in range(3):
        got = load_frame_data_from_file(str(yuv), disp)
        for k in ("y", "u", "v"):
            np.testing.assert_array_equal(np.round(got.data[k] * 255),
                                          np.round(want[str(disp)].data[k] * 255))


def test_jax_decodes_the_port_file(encoded):
    _, out, _ = encoded
    want = p_decode_video(str(out), device="cpu")
    got = j_decode_video(str(out))
    assert sorted(got) == sorted(want) == ["0", "1", "2"]
    for disp in want:
        for k in ("y", "u", "v"):
            d = np.abs(np.round(np.asarray(got[disp].data[k]) * 255)
                       - np.round(want[disp].data[k] * 255))
            assert d.max() <= 1 and (d > 0).mean() < 1e-3, (disp, k, d.max(), (d > 0).mean())
