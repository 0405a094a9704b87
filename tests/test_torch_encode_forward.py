"""The port's training forward (coolchic_forward, frame_encoder_forward and
the loss) against the JAX package's, on the same parameters made from a
seed, at the intra hop and lop operating points on a 192x128 image, in the
decoder's view (hardround) and in training (softround + gaussian noise,
JAX's own draws injected into the port).

Tolerances (f32, summation order differs):
  - raw output and training-time decoded image: 2e-5 absolute (values in
    [0, 1]); the decoder's-view image is rounded to 8 bits, so a value at
    a rounding boundary may land one code value off (ROADMAP.md Queue 3):
    within 1/255, on under 0.1 % of the samples;
  - per-latent rate: 1e-3 bits absolute where the symbol costs at most 10
    bits (a few symbols differ by ~1e-4), 1e-2 above (the f32 CDF
    difference near 1 loses digits there, see test_torch_encode_ops.py),
    and the total within 1e-5 relative;
  - gradients of the loss, every trainable leaf: max |port - jax| <= 1e-3
    of the leaf's largest |jax| gradient (the rate's gradient through the
    f32 CDF difference amplifies summation-order noise).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coolchic_tpu.core.quantizer import sample_noise
from coolchic_tpu.io.io import load_frame_data_from_file
from coolchic_tpu.models.coolchic import coolchic_forward as j_cc_forward
from coolchic_tpu.models.frame import FrameConfig as JFrameConfig
from coolchic_tpu.models.frame import frame_encoder_forward as j_frame_forward
from coolchic_tpu.models.frame import frame_encoder_init as j_frame_init
from coolchic_tpu.train.loss import loss_function as j_loss
from coolchic_tpu.utils.parsecli import INTRA_OPERATING_POINTS
from coolchic_tpu.utils.parsecli import coolchic_config_from_args as j_cfg_from_args
from coolchic_tpu_torch.models.coolchic import coolchic_forward as p_cc_forward
from coolchic_tpu_torch.models.frame import FrameConfig
from coolchic_tpu_torch.models.frame import frame_encoder_forward as p_frame_forward
from coolchic_tpu_torch.models.params import tree_from_numpy
from coolchic_tpu_torch.train.loss import loss_function as p_loss
from coolchic_tpu_torch.train.params import FROZEN, group_tree, tree_leaves, tree_unflatten
from coolchic_tpu_torch.utils.parsecli import coolchic_config_from_args as p_cfg_from_args
from coolchic_tpu_torch.utils.parsecli import intra_operating_points

torch.set_num_threads(2)
REPO = __import__("pathlib").Path(__file__).resolve().parent.parent
IMG = str(REPO / "tests/data/192x128_kodim15.png")
TEMP, NOISE, LMBDA = 0.3, 0.22, 1e-3


def setup(op: str, seed: int = 0):
    """(JAX frame config, port frame config, numpy params, target)."""
    frame = load_frame_data_from_file(IMG)
    jcfg = j_cfg_from_args(INTRA_OPERATING_POINTS[op], frame.img_size)
    pcfg = p_cfg_from_args(intra_operating_points()[op], frame.img_size)
    assert jcfg == pcfg or repr(jcfg) == repr(pcfg)
    jf = JFrameConfig(coolchic_cfg={"residue": jcfg})
    pf = FrameConfig(coolchic_cfg={"residue": pcfg})
    params = jax.tree_util.tree_map(np.asarray, j_frame_init(jax.random.PRNGKey(seed), jf))
    rng = np.random.default_rng(seed)
    cc = params["residue"]
    # away from init: latents of a few quantization steps, residual layers on
    cc["latents"] = [rng.normal(0, 2.5, x.shape).astype(np.float32) / jcfg.encoder_gain
                     for x in cc["latents"]]
    for lay in cc["arm"]["layers"] + cc["synthesis"]["layers"]:
        lay["weight"] = lay["weight"] + rng.normal(0, 0.05, lay["weight"].shape).astype(np.float32)
        lay["bias"] = lay["bias"] + rng.normal(0, 0.05, lay["bias"].shape).astype(np.float32)
    return jf, pf, params, np.asarray(frame.data, np.float32)


def jax_noise(key, cfg):
    """The noise JAX's frame_encoder_forward draws for key (one split per
    cool-chic, then one per grid), as numpy [h, w] arrays."""
    _, sub = jax.random.split(key)
    out = []
    for shape in cfg.size_per_latent:
        sub, s = jax.random.split(sub)
        out.append(np.asarray(sample_noise(s, shape, "gaussian", NOISE)))
    return out


def _batched(params):
    return tree_from_numpy(jax.tree_util.tree_map(lambda x: np.asarray(x)[None], params),
                           "cpu")


def _rate_close(p, j):
    body = j <= 10.0
    np.testing.assert_allclose(p[body], j[body], rtol=0, atol=1e-3)
    np.testing.assert_allclose(p[~body], j[~body], rtol=0, atol=1e-2)
    np.testing.assert_allclose(p.sum(), j.sum(), rtol=1e-5)


@pytest.mark.parametrize("op", ["hop", "lop"])
@pytest.mark.parametrize("training", [False, True])
def test_forward_and_grads(op, training):
    jf, pf, params, target = setup(op)
    cfg = jf.cc_cfgs["residue"]
    key = jax.random.PRNGKey(7)
    noise = jax_noise(key, cfg) if training else None
    qkw = dict(quantizer_type="softround", soft_round_temperature=TEMP)

    # coolchic_forward
    jo = j_cc_forward(jax.tree_util.tree_map(jnp.asarray, params["residue"]), cfg,
                      key=jax.random.split(key)[1], quantizer_noise_type="gaussian",
                      noise_parameter=NOISE, training=training, **qkw)
    pb = _batched(params)
    po = p_cc_forward(pb["residue"], pf.cc_cfgs["residue"], training=training,
                      noise=None if noise is None else [torch.tensor(n)[None] for n in noise],
                      **qkw)
    for a, b in zip(po.latents, jo.latents):
        np.testing.assert_allclose(a[0].numpy(), np.asarray(b), rtol=0, atol=1e-5)
    np.testing.assert_allclose(po.raw_out[0].numpy(), np.asarray(jo.raw_out)[0],
                               rtol=0, atol=2e-5)
    _rate_close(po.rate[0].numpy(), np.asarray(jo.rate))

    # frame_encoder_forward + loss, gradients of every trainable leaf
    def j_loss_of(p):
        out = j_frame_forward(p, jf, key=key, quantizer_noise_type="gaussian",
                              noise_parameter=NOISE, training=training, **qkw)
        return j_loss(out.decoded_image, out.rate, jnp.asarray(target), {"mse": 1.0},
                      LMBDA).loss, out.decoded_image

    (jl, jdec), jg = jax.value_and_grad(j_loss_of, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params))
    leaves = tree_leaves(pb)
    groups = group_tree(pb)
    req = [x.requires_grad_(g != FROZEN) for x, g in zip(leaves, groups)]
    out = p_frame_forward(tree_unflatten(pb, req), pf, training=training,
                          noise=None if noise is None else
                          {"residue": [torch.tensor(n)[None] for n in noise]}, **qkw)
    lo = p_loss(out.decoded_image, out.rate, torch.tensor(target), {"mse": 1.0}, LMBDA)
    dec_p, dec_j = out.decoded_image[0].detach().numpy(), np.asarray(jdec)[0]
    if training:
        np.testing.assert_allclose(dec_p, dec_j, rtol=0, atol=2e-5)
    else:
        diff = np.abs(dec_p - dec_j)
        assert diff.max() <= 1 / 255 + 1e-6 and (diff > 1e-6).mean() < 1e-3
    np.testing.assert_allclose(float(lo.loss[0].detach()), float(jl), rtol=1e-5)
    train = [x for x in req if x.requires_grad]
    pg = iter(torch.autograd.grad(lo.loss.sum(), train, allow_unused=True))
    j_leaves = jax.tree_util.tree_leaves(jg)
    assert len(j_leaves) == len(req)
    n_checked = 0
    for x, g_j in zip(req, j_leaves):
        if not x.requires_grad:
            continue
        g_p = next(pg)
        g_p = np.zeros(x.shape[1:], np.float32) if g_p is None else g_p[0].numpy()
        g_j = np.asarray(g_j)
        scale = float(np.abs(g_j).max())
        assert float(np.abs(g_p - g_j).max()) <= 1e-3 * max(scale, 1e-12), \
            (x.shape, float(np.abs(g_p - g_j).max()), scale)
        n_checked += 1
    assert n_checked == sum(g != FROZEN for g in groups)


@pytest.mark.parametrize("op", ["lop", "mop", "hop", "vhop"])
def test_operating_points_match_jax(op):
    """The port reads the intra operating points from cfg/dec/intra/*.cfg;
    they equal the JAX package's table and build the same config."""
    assert intra_operating_points()[op] == INTRA_OPERATING_POINTS[op]
    size = (512, 768)
    assert repr(p_cfg_from_args(intra_operating_points()[op], size)) == \
        repr(j_cfg_from_args(INTRA_OPERATING_POINTS[op], size))
