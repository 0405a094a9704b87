"""rdoq_coolchic end to end, the port (coolchic_tpu_torch/nnquant/rdoq.py)
against the JAX package's, from the same NN-quantized parameters of the
64x96 crop of kodim15 that tests/test_rdoq.py:48-73 refines (intra lop,
lambda 1e-3, seed 0): the float parameters are trained briefly by the port
(30 main-phase steps from JAX's init), then NN-quantized by the JAX
package (train/video.py:_quantize_frame without RDOQ); both packages' RDOQ
refine those.

  - the same accepted edits: at least 99 % of the scalars of every module
    end on the same value (any that differ are printed: ties that f32
    summation order flips);
  - the same exp-Golomb orders after the post-RDOQ re-search;
  - the objective measured on the real bitstream (the port's encode_frame
    and decode, mse + lambda * 8 * bytes / pixels) is never worse after the
    port's RDOQ than before it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coolchic_tpu.io.framedata import FrameData as JFrameData
from coolchic_tpu.models.frame import FrameConfig as JFrameConfig
from coolchic_tpu.models.frame import frame_encoder_init as j_frame_init
from coolchic_tpu.nnquant.rdoq import rdoq_coolchic as j_rdoq
from coolchic_tpu.train.presets import PresetDebug as JPresetDebug
from coolchic_tpu.train.train import EncoderMonitor as JMonitor
from coolchic_tpu.train.video import _quantize_frame as j_quantize_frame
from coolchic_tpu.utils.parsecli import INTRA_OPERATING_POINTS
from coolchic_tpu.utils.parsecli import coolchic_config_from_args as j_cfg_from_args
from coolchic_tpu_torch.bitstream.decode import decode_frame
from coolchic_tpu_torch.bitstream.encode import encode_frame
from coolchic_tpu_torch.bitstream.headers import VideoHeader
from coolchic_tpu_torch.io.io import load_frame_data_from_file
from coolchic_tpu_torch.models.frame import FrameConfig
from coolchic_tpu_torch.models.params import tree_from_numpy, tree_to_numpy
from coolchic_tpu_torch.nnquant.rdoq import _flat
from coolchic_tpu_torch.nnquant.rdoq import rdoq_coolchic as p_rdoq
from coolchic_tpu_torch.parallel.encode_batch import _batched_phase
from coolchic_tpu_torch.train.presets import TrainerPhase
from coolchic_tpu_torch.train.train import EncoderMonitor, TorchNoise, index_tree, stack_trees
from coolchic_tpu_torch.utils.codingstructure import CodingStructure
from coolchic_tpu_torch.utils.parsecli import coolchic_config_from_args as p_cfg_from_args
from coolchic_tpu_torch.utils.parsecli import intra_operating_points

torch.set_num_threads(2)
REPO = __import__("pathlib").Path(__file__).resolve().parent.parent
IMG = str(REPO / "tests/data/192x128_kodim15.png")
LMBDA = 1e-3
MODULES = ("arm", "ifce", "synthesis", "upsampling")


def _objective(params, fcfg, side, crop):
    """mse + lambda * 8 * bytes / pixels of the real bitstream, decoded."""
    cs = CodingStructure(n_frames=1, intra_pos=[0])
    payload = encode_frame(params, fcfg, cs, side, is_first_frame=True)
    _, rest = VideoHeader.read(payload)
    decoded, _ = decode_frame(rest, device="cpu")
    mse = float(np.mean(np.square(np.asarray(decoded.data, np.float64) - crop)))
    return mse + LMBDA * 8 * len(payload) / crop[0, 0].size


@pytest.fixture(scope="module")
def refined():
    crop = np.asarray(load_frame_data_from_file(IMG).data, np.float32)[:, :, :64, :96]
    jcfg = j_cfg_from_args(INTRA_OPERATING_POINTS["lop"], (64, 96))
    pcfg = p_cfg_from_args(intra_operating_points()["lop"], (64, 96))
    jf, pf = JFrameConfig(coolchic_cfg={"residue": jcfg}), FrameConfig(coolchic_cfg={"residue": pcfg})
    init = jax.tree_util.tree_map(np.asarray, j_frame_init(jax.random.PRNGKey(0), jf))
    phase = TrainerPhase(lmbda=LMBDA, max_itr=30, freq_valid=30, schedule_lr=True,
                         quantizer_type="softround", quantizer_noise_type="gaussian",
                         softround_temperature=(0.35, 0.2), noise_parameter=(0.22, 0.15))
    trained, _ = _batched_phase(stack_trees([tree_from_numpy(init, "cpu")]),
                                torch.tensor(crop), pf, phase, EncoderMonitor(), False,
                                noise_source=TorchNoise(torch.Generator().manual_seed(0)))
    floats = tree_to_numpy(index_tree(trained, 0))
    q_params, side = j_quantize_frame(floats, jf, JPresetDebug(lmbda=LMBDA, start_lr=1e-2,
                                                               itr_main_training=1),
                                      jnp.asarray(crop), None, None,
                                      JFrameData(8, "rgb", crop), JMonitor(), rdoq=False,
                                      verbose=False)
    q_params = jax.tree_util.tree_map(np.asarray, q_params)
    q_shift, expgol = side["residue"]
    out = {"crop": crop, "pf": pf, "cfg": pcfg, "q_params": q_params, "side": side}
    out["j_expgol"], out["p_expgol"] = dict(expgol), dict(expgol)
    out["jax"] = jax.tree_util.tree_map(np.asarray, j_rdoq(
        q_params["residue"], jcfg, q_shift, out["j_expgol"], LMBDA, target=crop))
    out["log"] = []
    out["port"] = p_rdoq(q_params["residue"], pcfg, q_shift, out["p_expgol"], LMBDA,
                         target=crop, device="cpu", log=out["log"])
    return out


def test_same_edits(refined):
    cfg, q, j, p = refined["cfg"], refined["q_params"]["residue"], refined["jax"], refined["port"]
    total = same = edited = 0
    for m in MODULES:
        for wb in ("weight", "bias"):
            a0, aj, ap = (_flat(t, cfg, m, wb) for t in (q, j, p))
            eq = aj == ap
            for i in np.nonzero(~eq)[0]:
                print(f"{m}.{wb}[{i}]: before {a0[i]:+.6f}, jax {aj[i]:+.6f}, "
                      f"port {ap[i]:+.6f}")
            assert eq.mean() >= 0.99, (m, wb, eq.mean())
            total += eq.size
            same += int(eq.sum())
            edited += int((ap != a0).sum())
    print(f"RDOQ: {same}/{total} scalars equal to JAX's, {edited} edited by the port")
    assert edited > 0.1 * total
    assert {r["module"] for r in refined["log"]} == set(MODULES)


def test_same_expgol(refined):
    assert refined["p_expgol"] == refined["j_expgol"]


def test_bitstream_objective_not_worse(refined):
    pf, crop, side = refined["pf"], refined["crop"], refined["side"]
    before = _objective(refined["q_params"], pf, side, crop)
    after_side = {"residue": (side["residue"][0], refined["p_expgol"])}
    after = _objective({**refined["q_params"], "residue": refined["port"]}, pf, after_side,
                       crop)
    print(f"bitstream objective: before RDOQ {before:.6e}, after {after:.6e}")
    assert after <= before + 1e-6
