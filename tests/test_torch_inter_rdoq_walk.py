"""RDOQ of P and B frames, the whole quantization walk (train/video.py:
_quantize_frame with RDOQ on: NN quantization and RDOQ of the residue with
the motion cool-chic's warps held fixed, then of the motion cool-chic
against the refined residue, each lane re-warping the references), the
port against the JAX package, from the same float parameters on
BQSquare's 48x64 crop (residue lop, motion mop, lambda 1e-3): every scalar
of both cool-chics ends on JAX's value, and the q-steps and exp-Golomb
orders are JAX's. The P frame here, the B frame in
tests/test_torch_inter_rdoq_walk_b.py (two files, so that the test
runner's workers spread them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coolchic_tpu.train.presets import PresetDebug as JPresetDebug
from coolchic_tpu.train.train import EncoderMonitor as JMonitor
from coolchic_tpu.train.video import _quantize_frame as j_quantize_frame
from coolchic_tpu_torch.train.presets import PresetDebug
from coolchic_tpu_torch.train.train import EncoderMonitor
from coolchic_tpu_torch.train.video import _quantize_frame
from tests.test_torch_encode_bitstream import _assert_same_params
from tests.test_torch_inter_bitstream import LMBDA, OPS
from tests.test_torch_inter_forward import inter_setup, load_frames

torch.set_num_threads(2)
KW = dict(lmbda=LMBDA, start_lr=1e-2, itr_main_training=1)
CROP = (16, 40, 48, 64)


def walk_matches_jax(frame_type):
    """_quantize_frame with RDOQ, from the same float parameters, in both
    packages."""
    jf, pf, params, target, refs = inter_setup(frame_type, OPS, crop=CROP)
    fdata = load_frames(CROP)[jf.frame_display_index]
    j_q, j_side = j_quantize_frame(params, jf, JPresetDebug(**KW),
                                   {k: jnp.asarray(v) for k, v in target.items()},
                                   [jnp.asarray(r) for r in refs], None, fdata, JMonitor(),
                                   rdoq=True, verbose=False)
    p_q, p_side = _quantize_frame(params, pf, PresetDebug(**KW),
                                  {k: torch.tensor(v) for k, v in target.items()}, fdata,
                                  EncoderMonitor(), False, torch.device("cpu"), rdoq=True,
                                  refs=[torch.tensor(r) for r in refs])
    assert p_side == j_side
    _assert_same_params(p_q, jax.tree_util.tree_map(np.asarray, j_q))
    no_rdoq, _ = _quantize_frame(params, pf, PresetDebug(**KW),
                                 {k: torch.tensor(v) for k, v in target.items()}, fdata,
                                 EncoderMonitor(), False, torch.device("cpu"),
                                 refs=[torch.tensor(r) for r in refs])
    edited = sum(int((np.asarray(a) != np.asarray(b)).sum()) for a, b in zip(
        jax.tree_util.tree_leaves(p_q), jax.tree_util.tree_leaves(no_rdoq)))
    assert edited > 0


@pytest.mark.parametrize("frame_type", ["P"])
def test_inter_rdoq_walk_matches_jax(frame_type):
    walk_matches_jax(frame_type)
