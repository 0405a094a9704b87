"""The port's serving slice on the CPU: `tpu`-profile transcoding, the batched
device decode (plain wavefront decode, int32 IFCE, float tail) and the
frame-level entry points, against the JAX package on the same bitstreams.

Three 128x192 hop bitstreams of the repo are transcoded to the `tpu` profile
with 128 streams forced down to 384-pixel grids in BOTH packages (as
tests/test_device_decode.py does), so the wavefront path covers levels
0..3, the small-grid decode levels 4 and 5, and the host levels 6..9. Grids are bit-exact; the float output agrees within 2e-5 (f32
summation order only)."""

import glob
from pathlib import Path

import numpy as np
import pytest
import torch

from coolchic_tpu.bitstream import codec as jcodec
from coolchic_tpu.bitstream import headers as jh
from coolchic_tpu.bitstream.decode import decode_video as j_decode_video
from coolchic_tpu.bitstream.nncodec import decode_network as j_decode_network
from coolchic_tpu_torch.bitstream import codec as pcodec
from coolchic_tpu_torch.bitstream import headers as ph
from coolchic_tpu_torch.bitstream.decode import _finish_frame
from coolchic_tpu_torch.bitstream.decode import decode_images as p_decode_images
from coolchic_tpu_torch.bitstream.decode import decode_video as p_decode_video
from coolchic_tpu_torch.bitstream.device_decode import (
    _shear_maps,
    decode_images_device,
    prepare_batch,
)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
FILES = sorted(glob.glob(str(REPO / "results/round4/h2h_kodim15_v3/*.cool")))[:3]


def _split(raw: bytes, mod):
    vh, rest = mod.VideoHeader.read(raw)
    fh, rest = mod.FrameHeader.read(rest)
    ch, rest = mod.CoolChicHeader.read(rest)
    return vh, fh, ch, rest[:ch.nn_n_bytes], rest[ch.nn_n_bytes:ch.nn_n_bytes + ch.n_bytes_latent]


@pytest.fixture(scope="module")
def transcoded(tmp_path_factory):
    """Per file: the JAX host decode of the ref payload, the `tpu` payloads
    of both packages' encoders, the JAX host decode of the tpu payload and
    a tpu-profile .cool file written from the port's payload."""
    j_orig, p_orig = jcodec.grid_n_streams, pcodec.grid_n_streams
    jcodec.grid_n_streams = lambda h, w: 128 if h * w >= 384 else j_orig(h, w)
    pcodec.grid_n_streams = lambda h, w: 128 if h * w >= 384 else p_orig(h, w)
    tmp = tmp_path_factory.mktemp("torch_devdec")
    out = []
    try:
        for i, path in enumerate(FILES):
            raw = Path(path).read_bytes()
            _, _, jch, bnn, blat = _split(raw, jh)
            _, pfh, pch, _, _ = _split(raw, ph)
            jcfg = jch.to_config()
            _, grids = jcodec.decode_coolchic(jch, bnn, blat, profile="ref")
            nn = j_decode_network(bnn, jcfg, jch.nn_q_step_shift, jch.nn_expgol_cnt,
                                  jch.nn_n_bit_pad)
            lat = [np.asarray(g, np.int64) for g in grids]
            j_pay = jcodec.encode_coolchic_latents(jch, nn, lat, profile="tpu")
            p_pay = pcodec.encode_coolchic_latents(pch, nn, lat, profile="tpu")
            raw_host, grids_host = jcodec.decode_coolchic(jch, bnn, j_pay, profile="tpu")
            tpu_file = tmp / f"im{i}.cool"
            tpu_file.write_bytes(ph.TPU_PROFILE_MAGIC + ph.VideoHeader().to_bytes()
                                 + pfh.to_bytes() + pch.to_bytes() + bnn + p_pay)
            out.append({"ref_file": path, "tpu_file": str(tpu_file), "frame": pfh,
                        "ref_grids": grids, "j_pay": j_pay, "p_pay": p_pay,
                        "item": (pch, bnn, p_pay), "raw_host": raw_host,
                        "grids_host": grids_host})
    finally:
        jcodec.grid_n_streams, pcodec.grid_n_streams = j_orig, p_orig
    return out


def test_tpu_payloads_byte_identical(transcoded):
    for t in transcoded:
        assert t["p_pay"] == t["j_pay"]
        for a, b in zip(t["grids_host"], t["ref_grids"]):
            np.testing.assert_array_equal(a, b)


def test_device_decode_matches_jax_host(transcoded):
    items = [t["item"] for t in transcoded]
    batch = prepare_batch(items, device="cpu")
    assert batch.device_levels == (3, 2, 1, 0)
    # the 8x12 grids (one stream) on the small-grid decode, the narrower
    # ones (raster-coded) on the host
    assert batch.small_levels == (5, 4) and batch.host_levels == (9, 8, 7, 6)
    for t, (raw_dev, grids_dev) in zip(transcoded, decode_images_device(items, "cpu")):
        assert len(grids_dev) == len(t["grids_host"])
        for a, b in zip(t["grids_host"], grids_dev):
            np.testing.assert_array_equal(a, b)
        assert raw_dev.shape == t["raw_host"].shape
        np.testing.assert_allclose(raw_dev, t["raw_host"], atol=2e-5, rtol=0)


def test_decode_images_routes_and_frames(transcoded):
    """decode_images end to end: every group on the device path; the 8-bit
    planes within one code value of the JAX host decode's (the float
    tails differ by f32 summation order only, which can move a value across
    a rounding boundary)."""
    frames, routes = p_decode_images([t["tpu_file"] for t in transcoded],
                                     device="cpu", return_routes=True)
    assert [r["path"] for r in routes] == ["device"]
    assert sorted(routes[0]["items"]) == [0, 1, 2]
    for t, f in zip(transcoded, frames):
        want = _finish_frame(t["raw_host"], t["frame"].bitdepth,
                             t["frame"].frame_data_type)
        assert np.abs(f.data - want.data).max() <= 1.0 / 255 + 1e-9


def test_decode_coolchic_tpu_profile_routes_to_device(transcoded):
    t = transcoded[0]
    raw, grids = pcodec.decode_coolchic(*t["item"], profile="tpu", device="cpu")
    for a, b in zip(t["grids_host"], grids):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(raw, t["raw_host"], atol=2e-5, rtol=0)


def test_decode_video_ref_matches_jax(transcoded):
    path = transcoded[0]["ref_file"]
    want = j_decode_video(path)
    got = p_decode_video(path, device="cpu")
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].data, np.asarray(want[k].data), atol=1.0 / 255 + 1e-9,
                                   rtol=0)
        assert np.mean(got[k].data != np.asarray(want[k].data)) < 1e-3


def test_shear_map_covers_every_pixel_once():
    for h, w in ((64, 96), (33, 47), (128, 256), (6, 700)):
        src, D = _shear_maps(h, w)
        assert src.shape == (D * 128,)
        live = np.sort(src[src < h * w])
        np.testing.assert_array_equal(live, np.arange(h * w))


def test_cc_decode_cli_writes_ppm(transcoded, tmp_path):
    """python -m coolchic_tpu_torch.cc_decode on a tpu-profile file: the PPM
    it writes holds the frame decode_video returns."""
    from coolchic_tpu_torch.cc_decode import main
    from coolchic_tpu_torch.io.images import read_ppm

    out = tmp_path / "dec.ppm"
    assert main(["-i", transcoded[1]["tpu_file"], "-o", str(out), "--device", "cpu"]) == 0
    want = p_decode_video(transcoded[1]["tpu_file"], device="cpu")["0"]
    np.testing.assert_allclose(read_ppm(str(out)).data, want.data, atol=1e-6, rtol=0)


def test_refused_group_takes_host_route(transcoded, monkeypatch):
    """A group prepare_batch refuses (here: forced) is decoded by the host
    route, recorded as such, with the JAX host path's grids."""
    from coolchic_tpu_torch.bitstream import decode as pdecode
    from coolchic_tpu_torch.bitstream import device_decode as pdd

    def refuse(items, device="cuda"):
        raise ValueError("common-randomness decode takes the host path")

    monkeypatch.setattr(pdd, "prepare_batch", refuse)
    outputs, routes = pdecode._decode_items_batched([t["item"] for t in transcoded[:2]],
                                                    "cpu")
    assert routes == [{"items": [0, 1], "path": "host",
                       "reason": "common-randomness decode takes the host path"}]
    for t, (raw, grids) in zip(transcoded, outputs):
        for a, b in zip(t["grids_host"], grids):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(raw, t["raw_host"], atol=2e-5, rtol=0)
