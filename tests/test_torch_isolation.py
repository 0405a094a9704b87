"""The PyTorch port stands alone: no module of coolchic_tpu_torch loads JAX or
any module of the JAX package, it pins the full-f32 float policy, and its
entry points refuse to fall back to the CPU when a card is asked for."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, json, pkgutil, sys
import coolchic_tpu_torch as pkg
names = []
for m in pkgutil.walk_packages(pkg.__path__, prefix="coolchic_tpu_torch."):
    importlib.import_module(m.name)
    names.append(m.name)
import torch
leaked = sorted(n for n in sys.modules
                if n == "jax" or n.startswith("jax.") or n == "coolchic_tpu"
                or n.startswith("coolchic_tpu."))
print(json.dumps({"modules": names, "leaked": leaked,
                  "cudnn_tf32": torch.backends.cudnn.allow_tf32,
                  "matmul_precision": torch.get_float32_matmul_precision()}))
"""


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, check=True,
                         capture_output=True, text=True, timeout=120)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "coolchic_tpu_torch.ops.wavefront_decode" in res["modules"]
    assert "coolchic_tpu_torch.bitstream.device_decode" in res["modules"]
    for name in ("cc_encode", "train.video", "train.soap", "parallel.encode_batch",
                 "nnquant.quantize", "bitstream.encode", "nnquant.rdoq", "train.logs",
                 "train.wasserstein", "utils.complexity", "models.warp", "models.flow",
                 "models.globalmotion", "parallel.gop", "utils.results", "train.encode",
                 "samples.getcodingstruct", "samples.encode", "samples.encode_batch",
                 "samples.encode_sweep", "samples.encode_kodak_batch",
                 "samples.decode_batch"):
        assert f"coolchic_tpu_torch.{name}" in res["modules"]
    assert res["leaked"] == []
    assert res["cudnn_tf32"] is False
    assert res["matmul_precision"] == "highest"


IMG = str(REPO / "tests/data/192x128_kodim15.png")


def _encode_one_frame(tmp_path):
    from coolchic_tpu_torch.train.presets import PresetDebug
    from coolchic_tpu_torch.train.video import encode_one_frame
    from coolchic_tpu_torch.utils.codingstructure import CodingStructure
    from coolchic_tpu_torch.utils.parsecli import intra_operating_points

    cs = CodingStructure(n_frames=1, intra_pos=[0])
    return encode_one_frame(cs.get_frame_from_coding_order(0), cs, IMG, str(tmp_path),
                            PresetDebug(lmbda=1e-3, start_lr=1e-2, itr_main_training=1),
                            {"residue": intra_operating_points()["lop"]}, rdoq=False)


def _encode_video(tmp_path):
    from coolchic_tpu_torch.train.video import encode_video

    return encode_video(str(REPO / "tests/data/D-BQSquare-3frames_224x128_60p_yuv420_8b.yuv"),
                        str(tmp_path / "o.cool"), str(tmp_path), n_frames=3, intra_pos=[0],
                        p_pos=[2], waves=True)


def _encode_wave_group(tmp_path):
    from coolchic_tpu_torch.train.presets import PresetDebug
    from coolchic_tpu_torch.train.video import encode_wave_group
    from coolchic_tpu_torch.utils.codingstructure import CodingStructure
    from coolchic_tpu_torch.utils.parsecli import intra_operating_points

    cs = CodingStructure(n_frames=1, intra_pos=[0])
    return encode_wave_group([cs.get_frame_from_coding_order(0)], cs, IMG, str(tmp_path),
                             PresetDebug(lmbda=1e-3, start_lr=1e-2, itr_main_training=1),
                             {"residue": intra_operating_points()["lop"]}, rdoq=False)


def _encode_images_batched(tmp_path):
    from coolchic_tpu_torch.io.io import load_frame_data_from_file
    from coolchic_tpu_torch.parallel.encode_batch import encode_images_batched
    from coolchic_tpu_torch.train.presets import PresetDebug
    from coolchic_tpu_torch.utils.parsecli import coolchic_config_from_args
    from coolchic_tpu_torch.utils.parsecli import intra_operating_points

    frame = load_frame_data_from_file(IMG)
    cfgs = {"residue": coolchic_config_from_args(intra_operating_points()["lop"],
                                                 frame.img_size)}
    return encode_images_batched([frame], cfgs, PresetDebug(lmbda=1e-3, start_lr=1e-2,
                                                            itr_main_training=1),
                                 [str(tmp_path / "o.cool")])


def _encode_image(tmp_path):
    from coolchic_tpu_torch.io.io import load_frame_data_from_file
    from coolchic_tpu_torch.train.encode import encode_image_to_bitstream
    from coolchic_tpu_torch.train.presets import PresetDebug
    from coolchic_tpu_torch.utils.parsecli import coolchic_config_from_args
    from coolchic_tpu_torch.utils.parsecli import intra_operating_points

    frame = load_frame_data_from_file(IMG)
    cfgs = {"residue": coolchic_config_from_args(intra_operating_points()["lop"],
                                                 frame.img_size)}
    return encode_image_to_bitstream(frame, cfgs, PresetDebug(lmbda=1e-3, start_lr=1e-2,
                                                              itr_main_training=1),
                                     str(tmp_path / "o.cool"))


def _sample_encode_batch(tmp_path):
    from coolchic_tpu_torch.samples import encode_batch

    return encode_batch.main(["--inputs", IMG, "--out_dir", str(tmp_path), "--recipe",
                              "debug"])


@pytest.mark.parametrize("entry", ["decode_video", "decode_images", "resolve_device",
                                   "cc_encode", "encode_one_frame", "encode_video",
                                   "encode_wave_group", "encode_images_batched",
                                   "encode_image_to_bitstream", "samples.encode_batch"])
def test_default_device_refuses_cpu_fallback(entry, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from coolchic_tpu_torch import cc_encode
    from coolchic_tpu_torch.bitstream.decode import decode_images, decode_video
    from coolchic_tpu_torch.core.device import resolve_device

    ref_file = str(REPO / "results/round4/h2h_kodim15_v3/kodim15_p012_l0.02.cool")
    call = {"decode_video": lambda: decode_video(ref_file),
            "decode_images": lambda: decode_images([]),
            "resolve_device": lambda: resolve_device("cuda"),
            "cc_encode": lambda: cc_encode.main(
                ["-i", IMG, "-o", str(tmp_path / "o.cool"), "--no_rdoq"]),
            "encode_one_frame": lambda: _encode_one_frame(tmp_path),
            "encode_video": lambda: _encode_video(tmp_path),
            "encode_wave_group": lambda: _encode_wave_group(tmp_path),
            "encode_images_batched": lambda: _encode_images_batched(tmp_path),
            "encode_image_to_bitstream": lambda: _encode_image(tmp_path),
            "samples.encode_batch": lambda: _sample_encode_batch(tmp_path)}[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    assert not (tmp_path / "o.cool").exists()


def test_cc_encode_refuses_without_no_rdoq(tmp_path, monkeypatch):
    """RDOQ is the CLI's default, as in the JAX CLI: without --no_rdoq the
    encode runs it, with --no_rdoq it does not (while RDOQ was not ported,
    the CLI refused to run without --no_rdoq)."""
    import coolchic_tpu_torch.train.video as video
    from coolchic_tpu_torch import cc_encode

    class Stop(Exception):
        pass

    seen = []

    def fake_encode(*args, rdoq, **kwargs):
        seen.append(rdoq)
        raise Stop

    monkeypatch.setattr(video, "encode_one_frame", fake_encode)
    for extra in ([], ["--no_rdoq"]):
        with pytest.raises(Stop):
            cc_encode.main(["-i", IMG, "-o", str(tmp_path / "o.cool"), "--device", "cpu",
                            "--workdir", str(tmp_path), *extra])
    assert seen == [True, False]
    assert not (tmp_path / "o.cool").exists()
