"""The port's encode tail against the JAX package's, on the same float
parameters made from a seed (intra lop and hop, 192x128):

  - NN quantization (nnquant/quantize.py through train/video.py:
    _quantize_frame): the same (q_shift, expgol) per module and the same
    integer parameters, exactly;
  - the bitstream write (bitstream/encode.py:encode_frame) from the same
    quantized parameters: byte-identical payloads in the `ref` and `tpu`
    profiles;
  - the checkpoint (utils/checkpoint.py): a JAX-written
    save_frame_encoder file loads into the port and finalizes to the same
    bytes, and a port-written one loads into JAX.
"""

import jax
import numpy as np
import pytest
import torch

from coolchic_tpu.bitstream.encode import encode_frame as j_encode_frame
from coolchic_tpu.io.io import load_frame_data_from_file as j_load
from coolchic_tpu.models.frame import FrameConfig as JFrameConfig
from coolchic_tpu.models.frame import frame_encoder_init as j_frame_init
from coolchic_tpu.train.presets import PresetDebug as JPresetDebug
from coolchic_tpu.train.train import EncoderMonitor as JMonitor
from coolchic_tpu.train.video import _quantize_frame as j_quantize_frame
from coolchic_tpu.utils.checkpoint import load_frame_encoder as j_load_ckpt
from coolchic_tpu.utils.checkpoint import save_frame_encoder as j_save_ckpt
from coolchic_tpu.utils.codingstructure import CodingStructure as JCodingStructure
from coolchic_tpu.utils.parsecli import INTRA_OPERATING_POINTS
from coolchic_tpu.utils.parsecli import coolchic_config_from_args as j_cfg_from_args
from coolchic_tpu_torch.bitstream.encode import encode_frame as p_encode_frame
from coolchic_tpu_torch.io.io import load_frame_data_from_file as p_load
from coolchic_tpu_torch.models.frame import FrameConfig
from coolchic_tpu_torch.train.encode import _target_from_frame
from coolchic_tpu_torch.train.presets import PresetDebug
from coolchic_tpu_torch.train.train import EncoderMonitor
from coolchic_tpu_torch.train.video import _finalize_frame, _quantize_frame
from coolchic_tpu_torch.utils.checkpoint import load_frame_encoder as p_load_ckpt
from coolchic_tpu_torch.utils.checkpoint import save_frame_encoder as p_save_ckpt
from coolchic_tpu_torch.utils.codingstructure import CodingStructure
from coolchic_tpu_torch.utils.parsecli import coolchic_config_from_args as p_cfg_from_args
from coolchic_tpu_torch.utils.parsecli import intra_operating_points

torch.set_num_threads(2)
REPO = __import__("pathlib").Path(__file__).resolve().parent.parent
IMG = str(REPO / "tests/data/192x128_kodim15.png")
LMBDA = 1e-3


def _float_params(op: str, seed: int = 0):
    """JAX frame configs, port frame config, numpy float params that look
    trained (latents of a few quantization steps, weights away from init)."""
    frame = j_load(IMG)
    jcfg = j_cfg_from_args(INTRA_OPERATING_POINTS[op], frame.img_size)
    pcfg = p_cfg_from_args(intra_operating_points()[op], frame.img_size)
    jf = JFrameConfig(coolchic_cfg={"residue": jcfg})
    pf = FrameConfig(coolchic_cfg={"residue": pcfg})
    params = jax.tree_util.tree_map(np.asarray, j_frame_init(jax.random.PRNGKey(seed), jf))
    rng = np.random.default_rng(seed)
    cc = params["residue"]
    cc["latents"] = [rng.normal(0, 2.5, x.shape).astype(np.float32) / jcfg.encoder_gain
                     for x in cc["latents"]]
    for lay in cc["arm"]["layers"] + cc["synthesis"]["layers"]:
        lay["weight"] = lay["weight"] + rng.normal(0, 0.05, lay["weight"].shape).astype(np.float32)
        lay["bias"] = lay["bias"] + rng.normal(0, 0.05, lay["bias"].shape).astype(np.float32)
    return jf, pf, params


def _assert_same_params(a, b):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.fixture(scope="module", params=["lop", "hop"])
def quantized(request):
    """Both packages' NN quantization of the same float params."""
    jf, pf, params = _float_params(request.param)
    j_preset = JPresetDebug(lmbda=LMBDA, start_lr=1e-2, itr_main_training=1)
    fdata = j_load(IMG)
    j_q, j_side = j_quantize_frame(jax.tree_util.tree_map(np.asarray, params), jf, j_preset,
                                   jax.numpy.asarray(fdata.data), None, None, fdata,
                                   JMonitor(), rdoq=False, verbose=False)
    p_fdata = p_load(IMG)
    p_q, p_side = _quantize_frame(params, pf, PresetDebug(lmbda=LMBDA, start_lr=1e-2,
                                                             itr_main_training=1),
                                     _target_from_frame(p_fdata, "cpu"), p_fdata,
                                     EncoderMonitor(), False, torch.device("cpu"))
    return jf, pf, jax.tree_util.tree_map(np.asarray, j_q), j_side, p_q, p_side


def test_nn_quantization_choices_and_integers(quantized):
    _, _, j_q, j_side, p_q, p_side = quantized
    assert p_side == j_side
    _assert_same_params(p_q, j_q)


@pytest.mark.parametrize("profile", ["ref", "tpu"])
def test_encode_frame_byte_identical(quantized, profile):
    jf, pf, j_q, j_side, _, _ = quantized
    j_bytes = j_encode_frame(j_q, jf, JCodingStructure(n_frames=1, intra_pos=[0]), j_side,
                             is_first_frame=True, profile=profile)
    p_bytes = p_encode_frame(j_q, pf, CodingStructure(n_frames=1, intra_pos=[0]), j_side,
                             is_first_frame=True, profile=profile)
    assert p_bytes == j_bytes


@pytest.mark.parametrize("profile", ["ref", "tpu"])
def test_checkpoint_from_jax_finalizes_to_same_bytes(quantized, profile, tmp_path):
    jf, _, j_q, j_side, _, _ = quantized
    path = str(tmp_path / "0000-frame_encoder.npz")
    j_save_ckpt(path, j_q, jf, j_side)
    params, fcfg, side = p_load_ckpt(path)
    assert side == j_side
    _assert_same_params(params, j_q)
    cs = CodingStructure(n_frames=1, intra_pos=[0])
    frame = cs.get_frame_from_coding_order(0)
    out = _finalize_frame(frame, cs, params, fcfg, side, p_load(IMG), str(tmp_path), IMG,
                          verbose=False, profile=profile, lmbda=LMBDA,
                          device=torch.device("cpu"))
    j_bytes = j_encode_frame(j_q, jf, JCodingStructure(n_frames=1, intra_pos=[0]), j_side,
                             is_first_frame=True, profile=profile)
    assert out["payload"] == j_bytes
    assert (tmp_path / "0000-decoded.png").exists()
    assert (tmp_path / "0000-results_encoder.tsv").exists()


def test_checkpoint_from_port_loads_into_jax(quantized, tmp_path):
    jf, pf, j_q, j_side, _, _ = quantized
    path = str(tmp_path / "0000-frame_encoder.npz")
    p_save_ckpt(path, j_q, pf, j_side)
    params, fcfg, side = j_load_ckpt(path)
    assert side == j_side and fcfg == jf
    _assert_same_params(params, j_q)
