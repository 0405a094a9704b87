"""The port's batched multi-image encode (parallel/encode_batch.py:
encode_images_batched) and per-image encode (train/encode.py:encode_image,
encode_image_to_bitstream), against the JAX package's properties and
decoders, on small crops (kodim15, lop, the debug recipe).

  - Mixed λ (JAX's tests/test_lambda_pairs.py): slot 0 of a mixed-λ batch
    is byte-identical to slot 0 of a uniform batch, and the higher-λ slot of
    the same pixels is smaller.
  - The batched files decode in the port's decoder and in JAX's, with the
    decoder's PSNR within 0.3 dB of the encoder's: an RGB batch (`ref`
    profile) and a yuv420 batch with RDOQ (`tpu` profile; the batched
    encode refines only ARM and IFCE of a yuv420 frame, as JAX's does).
  - A mixed-λ batch warms each slot up at its own λ's noise level.
  - encode_image_to_bitstream writes a file both decoders read back at the
    PSNR it reports.
"""

import numpy as np
import pytest
import torch

from coolchic_tpu.bitstream.decode import decode_video as j_decode_video
from coolchic_tpu_torch.bitstream.decode import decode_video as p_decode_video
from coolchic_tpu_torch.io.framedata import FrameData
from coolchic_tpu_torch.io.io import load_frame_data_from_file
from coolchic_tpu_torch.parallel import encode_batch
from coolchic_tpu_torch.parallel.encode_batch import encode_images_batched
from coolchic_tpu_torch.train.encode import encode_image_to_bitstream
from coolchic_tpu_torch.train.presets import PresetDebug, PresetIntra
from coolchic_tpu_torch.utils.parsecli import coolchic_config_from_args, intra_operating_points

torch.set_num_threads(2)

REPO = __import__("pathlib").Path(__file__).resolve().parent.parent
IMG = str(REPO / "tests/data/192x128_kodim15.png")
YUV = str(REPO / "tests/data/kodim15_192x128_01p_yuv420_8b.yuv")
LAM_LO, LAM_HI = 1e-3, 2e-2


def _crop(frame, y0, x0, h, w):
    if frame.frame_data_type == "yuv420":
        data = {"y": frame.data["y"][..., y0:y0 + h, x0:x0 + w],
                **{k: frame.data[k][..., y0 // 2:(y0 + h) // 2, x0 // 2:(x0 + w) // 2]
                   for k in ("u", "v")}}
        data = {k: np.ascontiguousarray(v) for k, v in data.items()}
    else:
        data = np.ascontiguousarray(np.asarray(frame.data)[:, :, y0:y0 + h, x0:x0 + w])
    return FrameData(frame.bitdepth, frame.frame_data_type, data)


def _cfgs(frame):
    return {"residue": coolchic_config_from_args(intra_operating_points()["lop"],
                                                 frame.img_size)}


def _psnr(dec, ref) -> float:
    if isinstance(ref.data, dict):
        num = sum(float(np.sum(np.square(np.asarray(dec.data[k], np.float64)
                                         - np.asarray(ref.data[k], np.float64))))
                  for k in ref.data)
        mse = num / sum(v.size for v in ref.data.values())
    else:
        mse = float(np.mean(np.square(np.asarray(dec.data, np.float64)
                                      - np.asarray(ref.data, np.float64))))
    return -10 * np.log10(mse)


def _decodes_in_both(path, frame, psnr_enc):
    for decode in (lambda p: p_decode_video(p, device="cpu"), j_decode_video):
        dec = decode(path)["0"]
        assert abs(_psnr(dec, frame) - psnr_enc) < 0.3, (path, _psnr(dec, frame), psnr_enc)


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mixed")
    base = _crop(load_frame_data_from_file(IMG), 40, 72, 32, 48)
    preset = PresetDebug(lmbda=LAM_LO, start_lr=1e-2, itr_main_training=1)
    out = {}
    for tag, lmbdas in (("mixed", [LAM_LO, LAM_HI]), ("uniform", None)):
        paths = [str(tmp / f"{tag}{i}.cool") for i in range(2)]
        res = encode_images_batched([base, base], _cfgs(base), preset, paths, seed=0,
                                    verbose=False, rdoq=False, lmbdas=lmbdas, device="cpu")
        out[tag] = (paths, res)
    return base, out


def test_mixed_lambda_slot0_byte_identical(mixed):
    _, out = mixed
    (m_paths, m_res), (u_paths, _) = out["mixed"], out["uniform"]
    with open(m_paths[0], "rb") as f, open(u_paths[0], "rb") as g:
        assert f.read() == g.read(), "slot 0 (same λ, same seed) must be byte-identical"
    assert m_res[1]["n_bytes"] < m_res[0]["n_bytes"], m_res


def test_batched_files_decode_in_both_decoders(mixed):
    base, out = mixed
    paths, res = out["mixed"]
    for path, r in zip(paths, res):
        _decodes_in_both(path, base, r["psnr_db"])
        assert set(r) == {"psnr_db", "loss", "rate_bpp", "latent_rate_bpp", "n_bytes",
                          "n_pixels"}


def test_yuv420_batch_with_rdoq_decodes_in_both_decoders(tmp_path):
    full = load_frame_data_from_file(YUV)
    frames = [_crop(full, 32, 48, 32, 48), _crop(full, 64, 96, 32, 48)]
    paths = [str(tmp_path / f"y{i}.cool") for i in range(2)]
    seen = []
    res = encode_images_batched(frames, _cfgs(frames[0]),
                                PresetDebug(lmbda=1e-3, start_lr=1e-2, itr_main_training=1),
                                paths, seed=1, verbose=False, rdoq=True, profile="tpu",
                                on_image=lambda i, r: seen.append(i), device="cpu")
    assert seen == [0, 1]
    for frame, path, r in zip(frames, paths, res):
        _decodes_in_both(path, frame, r["psnr_db"])


def test_mixed_lambda_warmup_noise_per_slot(monkeypatch, tmp_path):
    """Each slot's warm-up noise row is its own λ's
    (Preset.warmup_noise_parameter), and λ rides the batch."""
    base = _crop(load_frame_data_from_file(IMG), 0, 0, 16, 32)
    preset = PresetIntra(lmbda=1e-3, start_lr=1e-2, itr_main_training=40, itr_floor=40)
    seen = {}

    class Stop(Exception):
        pass

    def fake_phase(params_b, targets_b, fcfg, phase, monitor, verbose, **kw):
        seen.update(kw)
        raise Stop

    monkeypatch.setattr(encode_batch, "_batched_phase", fake_phase)
    with pytest.raises(Stop):
        encode_images_batched([base, base], _cfgs(base), preset,
                              [str(tmp_path / "a"), str(tmp_path / "b")],
                              lmbdas=[1e-4, 2e-2], device="cpu", verbose=False)
    assert seen["lmbda_b"] == [1e-4, 2e-2]
    np.testing.assert_array_equal(seen["noise_b"], np.asarray(
        [preset.warmup_noise_parameter(1e-4), preset.warmup_noise_parameter(2e-2)],
        np.float32))


def test_encode_image_to_bitstream_decodes_in_both(tmp_path):
    frame = _crop(load_frame_data_from_file(IMG), 40, 72, 32, 48)
    path = str(tmp_path / "one.cool")
    res = encode_image_to_bitstream(
        frame, _cfgs(frame), PresetDebug(lmbda=1e-3, start_lr=1e-2, itr_main_training=1),
        path, seed=0, verbose=False, rdoq=True, device="cpu")
    assert set(res) == {"psnr_db", "rate_bpp", "latent_rate_bpp", "n_bytes"}
    with open(path, "rb") as f:
        assert len(f.read()) == res["n_bytes"]
    _decodes_in_both(path, frame, res["psnr_db"])
