"""The port's P/B frame forward (models/frame.py: motion cool-chic, global
shift, warp, alpha / beta blend) and the inter columns of the detailed logs
against the JAX package's, on the same parameters made from a seed, at the
residue / motion operating points lop / lop and at the CLI's inter
defaults (residue hop, motion mop, filter 8), on BQSquare 128x224 yuv420:
P codes frame 2 from frame 0, B frame 1 from frames 0 and 2.

Tolerances (f32, summation order differs), as measured:
  - raw cool-chic outputs, flows, alpha, beta, the prediction, the masked
    prediction, the residue and the training-time decoded planes: 1e-5
    absolute;
  - per-latent rate: tests/test_torch_encode_forward.py's bar (1e-3 bits
    where the symbol costs at most 10 bits, 1e-2 above, the total 1e-5
    relative);
  - the decoder's-view planes are rounded to 8 bits: within one code value
    on under 0.1 % of the samples (ROADMAP.md Queue 3);
  - gradients of the loss, every trainable leaf (the global flows take
    none): max |port - jax| <= 1e-4 of the leaf's largest |jax| gradient
    for the residue synthesis, and tests/test_torch_encode_forward.py's
    1e-3 for the rest: the rate's gradient through the f32 CDF difference,
    and the motion leaves' through the warp's sinc coefficients (measured
    up to 1.3e-4 on the motion synthesis).

The eval-mode cases run at lop / lop, the training cases at both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coolchic_tpu.core.quantizer import sample_noise
from coolchic_tpu.io.io import load_frame_data_from_file
from coolchic_tpu.io.yuv import convert_420_to_444
from coolchic_tpu.models.frame import FrameConfig as JFrameConfig
from coolchic_tpu.models.frame import frame_encoder_forward as j_frame_forward
from coolchic_tpu.models.frame import frame_encoder_init as j_frame_init
from coolchic_tpu.train.logs import detailed_test as j_detailed
from coolchic_tpu.train.logs import write_reference_encoder_tsv as j_write_ref
from coolchic_tpu.train.loss import loss_function as j_loss
from coolchic_tpu.utils.parsecli import MOTION_OPERATING_POINTS, RESIDUE_OPERATING_POINTS
from coolchic_tpu.utils.parsecli import coolchic_config_from_args as j_cfg_from_args
from coolchic_tpu_torch.models.frame import FrameConfig
from coolchic_tpu_torch.models.frame import frame_encoder_forward as p_frame_forward
from coolchic_tpu_torch.models.params import tree_from_numpy
from coolchic_tpu_torch.train.logs import detailed_test as p_detailed
from coolchic_tpu_torch.train.logs import write_reference_encoder_tsv as p_write_ref
from coolchic_tpu_torch.train.loss import loss_function as p_loss
from coolchic_tpu_torch.train.params import (
    FROZEN,
    group_tree,
    tree_flatten_with_path,
    tree_leaves,
    tree_unflatten,
)
from coolchic_tpu_torch.utils.parsecli import coolchic_config_from_args as p_cfg_from_args
from coolchic_tpu_torch.utils.parsecli import (
    motion_operating_points,
    residue_operating_points,
)

torch.set_num_threads(2)
REPO = __import__("pathlib").Path(__file__).resolve().parent.parent
VIDEO = str(REPO / "tests/data/D-BQSquare-3frames_224x128_60p_yuv420_8b.yuv")
TEMP, NOISE, LMBDA = 0.3, 0.22, 1e-3
# display index of the coded frame and of its references
CODING = {"P": (2, (0,)), "B": (1, (0, 2))}
GLOBAL_FLOWS = {"global_flow_1": [3.0, -2.0], "global_flow_2": [-1.0, 4.0]}


def load_frames(crop=None):
    """BQSquare's three frames as yuv420 FrameData (cropped to crop =
    (y0, x0, h, w), chroma at half)."""
    frames = [load_frame_data_from_file(VIDEO, t) for t in range(3)]
    if crop is not None:
        y0, x0, h, w = crop
        for f in frames:
            f.data = {"y": f.data["y"][..., y0:y0 + h, x0:x0 + w],
                      **{k: f.data[k][..., y0 // 2:(y0 + h) // 2, x0 // 2:(x0 + w) // 2]
                         for k in ("u", "v")}}
    return frames


def inter_setup(frame_type: str, ops=("lop", "lop"), crop=None, seed: int = 0):
    """(JAX frame config, port frame config, numpy params, target planes,
    dense [1, 3, H, W] references) of a P or B frame; the params are JAX's
    init moved off it (latents of a few steps, perturbed layers, a motion
    output bias of a few pixels, nonzero global flows)."""
    frames = load_frames(crop)
    cur, ref_idx = CODING[frame_type]
    size = frames[0].img_size
    op_r, op_m = ops
    cfgs = {}
    for name, table, ptable, op in (("residue", RESIDUE_OPERATING_POINTS,
                                     residue_operating_points(), op_r),
                                    ("motion", MOTION_OPERATING_POINTS,
                                     motion_operating_points(), op_m)):
        assert ptable[op] == table[op]
        jc = j_cfg_from_args(table[op], size, coolchic_name=name, frame_type=frame_type)
        pc = p_cfg_from_args(ptable[op], size, coolchic_name=name, frame_type=frame_type)
        assert repr(jc) == repr(pc)
        cfgs[name] = jc
    kw = dict(frame_type=frame_type, frame_data_type="yuv420", bitdepth=8,
              index_references=ref_idx, frame_display_index=cur, warp_filter_size=8)
    jf = JFrameConfig(coolchic_cfg=cfgs, **kw)
    pf = FrameConfig(coolchic_cfg=dict(cfgs), **kw)
    params = jax.tree_util.tree_map(np.asarray, j_frame_init(jax.random.PRNGKey(seed), jf))
    rng = np.random.default_rng(seed)
    for name, cfg in cfgs.items():
        cc = params[name]
        cc["latents"] = [rng.normal(0, 2.5, x.shape).astype(np.float32) / cfg.encoder_gain
                         for x in cc["latents"]]
        for lay in cc["arm"]["layers"] + cc["synthesis"]["layers"]:
            lay["weight"] = lay["weight"] + rng.normal(0, 0.05, lay["weight"].shape
                                                       ).astype(np.float32)
            lay["bias"] = lay["bias"] + rng.normal(0, 0.05, lay["bias"].shape
                                                   ).astype(np.float32)
    out_b = params["motion"]["synthesis"]["layers"][-1]["bias"]
    out_b += np.asarray([1.7, -2.3, -0.6, 2.9][:out_b.shape[0]], np.float32)
    for k, v in GLOBAL_FLOWS.items():
        params[k] = np.asarray(v, np.float32)
    target = {k: np.asarray(v, np.float32) for k, v in frames[cur].data.items()}
    refs = [convert_420_to_444(frames[i].data).astype(np.float32) for i in ref_idx]
    return jf, pf, params, target, refs


def frame_noise(key, fcfg):
    """The noise JAX's frame_encoder_forward draws for key: one split per
    cool-chic in turn, then one per grid; {name: [[1, h, w] tensors]}."""
    out = {}
    for name, cfg in fcfg.cc_cfgs.items():
        key, sub = jax.random.split(key)
        grids = []
        for shape in cfg.size_per_latent:
            sub, s = jax.random.split(sub)
            grids.append(torch.tensor(np.asarray(
                sample_noise(s, shape, "gaussian", NOISE)))[None])
        out[name] = grids
    return out


def batched(params):
    return tree_from_numpy(jax.tree_util.tree_map(lambda x: np.asarray(x)[None], params),
                           "cpu")


def _rate_close(p, j):
    body = j <= 10.0
    np.testing.assert_allclose(p[body], j[body], rtol=0, atol=1e-3)
    np.testing.assert_allclose(p[~body], j[~body], rtol=0, atol=1e-2)
    np.testing.assert_allclose(p.sum(), j.sum(), rtol=1e-5)


@pytest.mark.parametrize("frame_type, ops, training", [
    ("P", ("lop", "lop"), False), ("P", ("lop", "lop"), True),
    ("B", ("lop", "lop"), False), ("B", ("lop", "lop"), True),
    ("P", ("hop", "mop"), True), ("B", ("hop", "mop"), True)])
def test_inter_forward_and_grads(frame_type, ops, training):
    jf, pf, params, target, refs = inter_setup(frame_type, ops)
    key = jax.random.PRNGKey(7)
    qkw = dict(quantizer_type="softround", soft_round_temperature=TEMP)
    j_refs = [jnp.asarray(r) for r in refs]
    j_tgt = {k: jnp.asarray(v) for k, v in target.items()}

    def j_loss_of(p, j_refs, j_tgt):
        out = j_frame_forward(p, jf, reference_frames=j_refs, key=key,
                              quantizer_noise_type="gaussian", noise_parameter=NOISE,
                              training=training, **qkw)
        return j_loss(out.decoded_image, out.rate, j_tgt, {"mse": 1.0}, LMBDA).loss, out

    # one compiled program: JAX's op-by-op dispatch of this graph takes ~1 min
    (jl, jout), jg = jax.jit(jax.value_and_grad(j_loss_of, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params), j_refs, j_tgt)

    pb = batched(params)
    leaves, groups = tree_leaves(pb), group_tree(pb)
    req = [x.requires_grad_(g != FROZEN) for x, g in zip(leaves, groups)]
    out = p_frame_forward(tree_unflatten(pb, req), pf,
                          reference_frames=[torch.tensor(r) for r in refs], training=training,
                          noise=frame_noise(key, pf) if training else None, **qkw)
    lo = p_loss(out.decoded_image, out.rate, {k: torch.tensor(v) for k, v in target.items()},
                {"mse": 1.0}, LMBDA)

    for name in ("residue", "motion"):
        _rate_close(out.rate[name][0].detach().numpy(), np.asarray(jout.rate[name]))
    for k, v in jout.additional_data.items():
        if v is None:
            assert out.additional_data[k] is None
            continue
        np.testing.assert_allclose(out.additional_data[k][0].detach().numpy(),
                                   np.asarray(v)[0], rtol=0, atol=1e-5, err_msg=k)
    for k in ("y", "u", "v"):
        dec_p = out.decoded_image[k][0].detach().numpy()
        dec_j = np.asarray(jout.decoded_image[k])[0]
        if training:
            np.testing.assert_allclose(dec_p, dec_j, rtol=0, atol=1e-5)
        else:
            diff = np.abs(dec_p - dec_j)
            assert diff.max() <= 1 / 255 + 1e-6 and (diff > 1e-6).mean() < 1e-3
    np.testing.assert_allclose(float(lo.loss[0].detach()), float(jl), rtol=1e-5)

    trainable = [x for x in req if x.requires_grad]
    pg = iter(torch.autograd.grad(lo.loss.sum(), trainable, allow_unused=True))
    j_leaves = jax.tree_util.tree_leaves(jg)
    paths = [p for p, _ in tree_flatten_with_path(pb)]
    assert len(j_leaves) == len(req) == len(paths)
    n_checked = 0
    for x, g_j, path in zip(req, j_leaves, paths):
        if not x.requires_grad:
            continue
        g_p = next(pg)
        g_p = np.zeros(x.shape[1:], np.float32) if g_p is None else g_p[0].numpy()
        g_j = np.asarray(g_j)
        scale = float(np.abs(g_j).max())
        tol = 1e-4 if "['residue']['synthesis']" in str(path) else 1e-3
        assert float(np.abs(g_p - g_j).max()) <= tol * max(scale, 1e-12), \
            (path, float(np.abs(g_p - g_j).max()), scale)
        n_checked += 1
    assert n_checked == sum(g != FROZEN for g in groups)


@pytest.mark.parametrize("frame_type", ["P", "B"])
def test_inter_detailed_logs(frame_type, tmp_path):
    """detailed_test's inter columns (alpha_mean, beta_mean, pred_psnr_db,
    dummy_pred_psnr_db, the mean of the unshifted references) within 1e-5,
    and the reference-schema TSV byte-identical."""
    jf, pf, params, target, refs = inter_setup(frame_type)
    j = j_detailed(jax.tree_util.tree_map(jnp.asarray, params), jf,
                   {k: jnp.asarray(v) for k, v in target.items()},
                   refs=[jnp.asarray(r) for r in refs], lmbda=LMBDA, seq_name="bq")
    p = p_detailed(params, pf, {k: torch.tensor(v) for k, v in target.items()},
                   refs=[torch.tensor(r) for r in refs], lmbda=LMBDA, seq_name="bq",
                   device="cpu")
    assert list(p) == list(j)
    for k in ("alpha_mean", "beta_mean", "pred_psnr_db", "dummy_pred_psnr_db"):
        assert abs(p[k] - j[k]) <= 1e-5 * max(1.0, abs(j[k])), (k, p[k], j[k])
    assert p["alpha_mean"] > 0 and p["pred_psnr_db"] > 0 and p["dummy_pred_psnr_db"] > 0
    assert (p["beta_mean"] > 0) == (frame_type == "B")
    # the TSV rounds alpha / beta / dB to 3 decimals: same text
    p_write_ref(str(tmp_path / "p.tsv"), p)
    j_write_ref(str(tmp_path / "j.tsv"), {**j, **{k: p[k] for k in j if k not in
                                                  ("alpha_mean", "beta_mean",
                                                   "pred_psnr_db", "dummy_pred_psnr_db")}})
    assert (tmp_path / "p.tsv").read_bytes() == (tmp_path / "j.tsv").read_bytes()
