"""RDOQ of P/B frames (frame_ctx: the other cool-chic held fixed), the port
against the JAX package, on BQSquare's 64x96 crop (residue lop, motion
mop, lambda 1e-3) from JAX-initialized float parameters NN-quantized by
the JAX package:

  - the frame context (train/video.py:_rdoq_frame_ctx): the warped
    references (residue role), the residue's raw output and the shifted
    references (motion role) within 1e-5;
  - one probe of each reconstruction scorer, the residue's synthesis row
    tiles blending the fixed warps and its upsampling lanes, the motion
    cool-chic's synthesis and upsampling full-resolution lanes (each lane
    re-warping the references by its own flow), at P and B: each lane
    within 1e-5 relative, a lane above it explained by 8-bit flips of
    under 0.1 % of its samples (tests/test_torch_rdoq.py's bar);
tests/test_torch_inter_rdoq_walk.py holds the whole quantization walk.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coolchic_tpu.io.yuv import convert_420_to_444
from coolchic_tpu.nnquant import rdoq as J
from coolchic_tpu.train.presets import PresetDebug as JPresetDebug
from coolchic_tpu.train.train import EncoderMonitor as JMonitor
from coolchic_tpu.train.video import _quantize_frame as j_quantize_frame
from coolchic_tpu.train.video import _rdoq_frame_ctx as j_frame_ctx
from coolchic_tpu_torch.nnquant import rdoq as P
from coolchic_tpu_torch.train.video import _rdoq_frame_ctx as p_frame_ctx
from tests.test_torch_inter_bitstream import CROP, LMBDA, OPS
from tests.test_torch_inter_forward import inter_setup, load_frames
from tests.test_torch_rdoq import _compare

torch.set_num_threads(2)
BUDGET = 64 * 2**20
KW = dict(lmbda=LMBDA, start_lr=1e-2, itr_main_training=1)


@pytest.fixture(scope="module")
def quantized():
    """{frame type: (jf, pf, NN-quantized params, side info, target planes,
    refs)}: JAX's quantization without RDOQ."""
    out = {}
    for ft in ("P", "B"):
        jf, pf, params, target, refs = inter_setup(ft, OPS, crop=CROP)
        fdata = load_frames(CROP)[jf.frame_display_index]
        q, side = j_quantize_frame(params, jf, JPresetDebug(**KW),
                                   {k: jnp.asarray(v) for k, v in target.items()},
                                   [jnp.asarray(r) for r in refs], None, fdata, JMonitor(),
                                   rdoq=False, verbose=False)
        out[ft] = (jf, pf, jax.tree_util.tree_map(np.asarray, q), side, target, refs)
    return out


def _jax_scorer(monkeypatch, q_params, cfg, cc_side, target, frame_type, fctx, module):
    """JAX's scorer and activations of `module`'s weight sweep, as
    rdoq_coolchic builds them (its _sweep intercepted)."""
    seen = {}

    def capture(scorer, flat_w, flat_b, wb, shifts, q, acts, *a, **k):
        if wb == "weight":
            seen.update(scorer=scorer, acts=acts, shifts=shifts, q=q)
        return flat_w, flat_b

    monkeypatch.setattr(J, "_sweep", capture)
    q_shift, expgol = cc_side
    J.rdoq_coolchic(q_params, cfg, q_shift, dict(expgol), LMBDA, target=target,
                    frame_type=frame_type, frame_data_type="yuv420", bitdepth=8,
                    modules=(module,), frame_ctx=fctx)
    return seen


@pytest.mark.parametrize("frame_type", ["P", "B"])
@pytest.mark.parametrize("cc", ["residue", "motion"])
@pytest.mark.parametrize("module", ["synthesis", "upsampling"])
def test_inter_scorers_match_jax(quantized, monkeypatch, frame_type, cc, module):
    jf, pf, q, side, target, refs = quantized[frame_type]
    dense = convert_420_to_444(target)
    j_ctx = j_frame_ctx(q, jf, cc, [jnp.asarray(r) for r in refs], None)
    p_ctx = p_frame_ctx(q, pf, cc, [torch.tensor(r) for r in refs], None, torch.device("cpu"))
    for key in ("warps", "refs"):
        for a, b in zip(p_ctx.get(key, ()), j_ctx.get(key, ())):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)
    if "other_raw" in j_ctx:
        np.testing.assert_allclose(p_ctx["other_raw"].numpy(), j_ctx["other_raw"], rtol=0,
                                   atol=1e-5)
    cfg = pf.cc_cfgs[cc]
    seen = _jax_scorer(monkeypatch, q[cc], jf.cc_cfgs[cc], side[cc], dense, frame_type,
                       j_ctx, module)
    shifts, _, _, scorers = P.module_scorers(
        q[cc], cfg, module, *side[cc], LMBDA, dense, "yuv420", 8, torch.device("cpu"),
        BUDGET, frame_type=frame_type, frame_ctx=p_ctx)
    assert shifts == seen["shifts"]
    fw, fb = P._flat(q[cc], cfg, module, "weight"), P._flat(q[cc], cfg, module, "bias")
    idxs = np.random.default_rng(1).permutation(fw.size)[:3].astype(np.int32)
    vals = (fw[idxs][:, None] + np.asarray(shifts, np.float32)[None, :]
            * np.float32(seen["q"])).astype(np.float32)
    j_l = seen["scorer"](jnp.asarray(fw), jnp.asarray(fb), jnp.asarray(idxs),
                         jnp.asarray(vals), *seen["acts"])
    p_l = scorers["weight"](torch.tensor(fw), torch.tensor(fb),
                            torch.tensor(idxs, dtype=torch.int64), torch.tensor(vals))
    _compare(p_l, j_l, 1.5 * dense[0, 0].size)
