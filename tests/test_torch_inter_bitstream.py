"""The port's P/B encode tail and decode against the JAX package's, on the
same float parameters made from a seed (BQSquare 64x96 crop; residue and
motion lop / mop):

  - NN quantization of both cool-chics (train/video.py:_quantize_frame,
    the residue first, the motion cool-chic against the quantized
    residue, the references broadcast over the trials): the same
    (q_shift, expgol) per module and the same integers, at P and B;
  - encode_frame: byte-identical P and B payloads in the `ref` and `tpu`
    profiles, the rounded global flows and warp_filter_size in the header;
  - an I+P+B file written by the JAX package from those quantized
    parameters decodes in the port as in JAX (8-bit planes within one
    code value on under 0.1 % of the samples, ROADMAP.md Queue 3), in both
    profiles; the port writes the same bytes, so the other way round is
    the same file;
  - the motion cool-chic's grid as 128 streams: the wavefront kernel's
    plain version decodes it as the host C++ does (its IFCE input from the
    four coarser grids).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coolchic_tpu.bitstream.decode import decode_video as j_decode_video
from coolchic_tpu.bitstream.encode import encode_frame as j_encode_frame
from coolchic_tpu.models.frame import FrameConfig as JFrameConfig
from coolchic_tpu.models.frame import frame_encoder_init as j_frame_init
from coolchic_tpu.train.presets import PresetDebug as JPresetDebug
from coolchic_tpu.train.train import EncoderMonitor as JMonitor
from coolchic_tpu.train.video import _quantize_frame as j_quantize_frame
from coolchic_tpu.utils.codingstructure import CodingStructure as JCodingStructure
from coolchic_tpu.utils.parsecli import INTRA_OPERATING_POINTS
from coolchic_tpu.utils.parsecli import coolchic_config_from_args as j_cfg_from_args
from coolchic_tpu_torch.bitstream import codec
from coolchic_tpu_torch.bitstream import rangecoder as rc
from coolchic_tpu_torch.bitstream.decode import decode_video as p_decode_video
from coolchic_tpu_torch.bitstream.encode import _int_arm_params
from coolchic_tpu_torch.bitstream.encode import encode_frame as p_encode_frame
from coolchic_tpu_torch.bitstream.headers import CoolChicHeader, FrameHeader, VideoHeader
from coolchic_tpu_torch.core.constants import non_zero_pixel_ctx_index
from coolchic_tpu_torch.ops import wavefront_decode as wfd
from coolchic_tpu_torch.train.presets import PresetDebug
from coolchic_tpu_torch.train.train import EncoderMonitor
from coolchic_tpu_torch.train.video import _quantize_frame
from coolchic_tpu_torch.utils.codingstructure import CodingStructure
from tests.test_torch_encode_bitstream import _assert_same_params
from tests.test_torch_inter_forward import inter_setup, load_frames

torch.set_num_threads(2)
CROP = (16, 40, 64, 96)
OPS = ("lop", "mop")
LMBDA = 1e-3


def _quantize_both(frame_type):
    jf, pf, params, target, refs = inter_setup(frame_type, OPS, crop=CROP)
    fdata = load_frames(CROP)[jf.frame_display_index]
    kw = dict(lmbda=LMBDA, start_lr=1e-2, itr_main_training=1)
    j_q, j_side = j_quantize_frame(
        params, jf, JPresetDebug(**kw), {k: jnp.asarray(v) for k, v in target.items()},
        [jnp.asarray(r) for r in refs], None, fdata, JMonitor(), rdoq=False, verbose=False)
    p_q, p_side = _quantize_frame(
        params, pf, PresetDebug(**kw), {k: torch.tensor(v) for k, v in target.items()},
        fdata, EncoderMonitor(), False, torch.device("cpu"),
        refs=[torch.tensor(r) for r in refs])
    return jf, pf, jax.tree_util.tree_map(np.asarray, j_q), j_side, p_q, p_side


@pytest.fixture(scope="module")
def quantized():
    return {ft: _quantize_both(ft) for ft in ("P", "B")}


@pytest.mark.parametrize("frame_type", ["P", "B"])
def test_nn_quantization_both_coolchics(quantized, frame_type):
    _, _, j_q, j_side, p_q, p_side = quantized[frame_type]
    assert set(p_side) == {"residue", "motion"}
    assert p_side == j_side
    _assert_same_params(p_q, j_q)


@pytest.mark.parametrize("frame_type", ["P", "B"])
@pytest.mark.parametrize("profile", ["ref", "tpu"])
def test_encode_frame_byte_identical(quantized, frame_type, profile):
    jf, pf, j_q, j_side, _, _ = quantized[frame_type]
    j_bytes = j_encode_frame(j_q, jf, JCodingStructure(n_frames=3, intra_pos=[0], p_pos=[2]),
                             j_side, is_first_frame=False, profile=profile)
    p_bytes = p_encode_frame(j_q, pf, CodingStructure(n_frames=3, intra_pos=[0], p_pos=[2]),
                             j_side, is_first_frame=False, profile=profile)
    assert p_bytes == j_bytes
    header, _ = FrameHeader.read(p_bytes)
    flows = [round(float(v)) for i in range(pf.n_refs) for v in j_q[f"global_flow_{i + 1}"]]
    assert list(header.global_flow) == flows and header.warp_filter_size == 8


def _intra_quantized():
    frames = load_frames(CROP)
    size = frames[0].img_size
    jcfg = j_cfg_from_args(INTRA_OPERATING_POINTS["lop"], size)
    jf = JFrameConfig(coolchic_cfg={"residue": jcfg}, frame_data_type="yuv420")
    params = jax.tree_util.tree_map(np.asarray, j_frame_init(jax.random.PRNGKey(3), jf))
    rng = np.random.default_rng(3)
    params["residue"]["latents"] = [rng.normal(0, 2.5, x.shape).astype(np.float32) / 16
                                    for x in params["residue"]["latents"]]
    q, side = j_quantize_frame(params, jf, JPresetDebug(lmbda=LMBDA, start_lr=1e-2,
                                                        itr_main_training=1),
                               {k: jnp.asarray(v) for k, v in frames[0].data.items()}, None,
                               None, frames[0], JMonitor(), rdoq=False, verbose=False)
    return jf, jax.tree_util.tree_map(np.asarray, q), side


@pytest.mark.parametrize("profile", ["ref", "tpu"])
def test_ipb_file_decodes_as_jax(quantized, profile, tmp_path):
    jcs = JCodingStructure(n_frames=3, intra_pos=[0], p_pos=[2])
    pcs = CodingStructure(n_frames=3, intra_pos=[0], p_pos=[2])
    jf_i, q_i, side_i = _intra_quantized()
    j_bytes = j_encode_frame(q_i, jf_i, jcs, side_i, is_first_frame=True, profile=profile)
    p_bytes = p_encode_frame(q_i, jf_i, pcs, side_i, is_first_frame=True, profile=profile)
    for ft in ("P", "B"):   # coding order: I0, P2, B1
        jf, pf, j_q, j_side, _, _ = quantized[ft]
        j_bytes += j_encode_frame(j_q, jf, jcs, j_side, is_first_frame=False, profile=profile)
        p_bytes += p_encode_frame(j_q, pf, pcs, j_side, is_first_frame=False, profile=profile)
    assert p_bytes == j_bytes
    path = tmp_path / "ipb.cool"
    path.write_bytes(j_bytes)
    want = j_decode_video(str(path))
    got = p_decode_video(str(path), device="cpu")
    assert sorted(got) == sorted(want) == ["0", "1", "2"]
    for disp in ("0", "1", "2"):
        for k in ("y", "u", "v"):
            d = np.abs(np.round(got[disp].data[k] * 255) - np.round(want[disp].data[k] * 255))
            assert d.max() <= 1 and (d > 0).mean() < 1e-3, (disp, k, d.max(), (d > 0).mean())


def test_motion_grid_128_streams_plain_kernel_equals_host(quantized):
    """The motion cool-chic's level-0 grid (the IFCE level of mop) coded as
    128 streams, the tpu profile's layout on a big frame, decoded by the
    kernel's plain version (the CPU stand-in for the CUDA kernel) and by
    the host C++."""
    _, pf, j_q, j_side, _, _ = quantized["B"]
    cfg = pf.cc_cfgs["motion"]
    q_shift, expgol = j_side["motion"]
    cc = j_q["motion"]
    header = CoolChicHeader.from_config(cfg, nn_q_step_shift=dict(q_shift),
                                        nn_expgol_cnt=dict(expgol), nn_n_bytes=0,
                                        nn_n_bit_pad=0, n_bytes_latent=0)
    nn_int = _int_arm_params(cc, cfg, q_shift)
    arm8 = codec._main_arm_params(nn_int, header, cfg, 1)
    grids = [np.clip(np.round(np.asarray(lat) * cfg.encoder_gain), -64, 63).astype(np.int64)
             for lat in cc["latents"]]
    h, w = cfg.size_per_latent[0]
    assert cfg.input_features_ifce[0] > 0
    ifce = codec._ifce_context_for_grid(nn_int, cfg, header, 0, grids[1:], h, w, model=1)
    ctx_idx = non_zero_pixel_ctx_index(cfg.spatial_context_arm)
    encoders = [rc.RangeEncoder() for _ in range(wfd.LANES)]
    rc.code_grid_streams(encoders, True, h, w, cfg.spatial_context_arm, ifce, arm8, ctx_idx,
                         data=np.ascontiguousarray(grids[0]), model=1)
    words = [np.frombuffer(e.get_bytes(), np.uint32).copy() for e in encoders]
    host = rc.code_grid_streams([rc.RangeDecoder(ws.tobytes()) for ws in words], False, h, w,
                                cfg.spatial_context_arm, ifce, arm8, ctx_idx, model=1)
    np.testing.assert_array_equal(host, grids[0])
    plain = wfd.decode_grids([{"words": words, "arm8": arm8, "ifce": ifce}], h, w, ctx_idx,
                             cfg.output_feature_ifce, device="cpu", plain=True)
    np.testing.assert_array_equal(plain[0], host)
