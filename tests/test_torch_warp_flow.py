"""The port's motion tools against the JAX package's: warp_fn (filters 2, 4
and 8, eval and training, flows that leave the frame, G = 2 slots with
different flows), nearest_warp / apply_global_translation /
shift_references, the global translation search, the LK flow estimate, and
the BT.709 colour conversions.

Tolerances, as measured:
  - warp values within 1e-5 absolute; flow gradients within 1e-4 relative
    L2 against jax.grad (training: the flow is not quantized; measured up
    to 3.4e-5 at filter 8);
  - nearest warps, global shifts and the global translations found:
    identical;
  - estimate_flow: the LK solve divides by a 2x2 determinant that is close
    to 0 in flat areas, so f32 summation-order noise in the box sums (1e-7
    relative) grows through the 8 iterations of each level. One iteration
    at one level agrees within 1e-3 px everywhere. The full estimate
    (measured: 95.1 to 99.9 % of the pixels within 1e-3 px, 99.4 % or more
    within 1e-2 px, mean |diff| at most 4e-4 px, the prediction it gives
    within 3.1e-4 dB of JAX's): 94 % within 1e-3 px, 99 % within 1e-2 px,
    mean |diff| 1e-3 px, and the prediction (the reference warped by it)
    within 0.01 dB.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coolchic_tpu.io.yuv import rgb2yuv as j_rgb2yuv
from coolchic_tpu.io.yuv import yuv2rgb as j_yuv2rgb
from coolchic_tpu.models.flow import estimate_flow as j_flow
from coolchic_tpu.models.globalmotion import get_global_translation as j_gmt
from coolchic_tpu.models.warp import apply_global_translation as j_agt
from coolchic_tpu.models.warp import nearest_warp as j_nearest
from coolchic_tpu.models.warp import warp_fn as j_warp
from coolchic_tpu_torch.io.yuv import rgb2yuv as p_rgb2yuv
from coolchic_tpu_torch.io.yuv import yuv2rgb as p_yuv2rgb
from coolchic_tpu_torch.models.flow import estimate_flow as p_flow
from coolchic_tpu_torch.models.globalmotion import get_global_translation as p_gmt
from coolchic_tpu_torch.models.warp import apply_global_translation as p_agt
from coolchic_tpu_torch.models.warp import nearest_warp as p_nearest
from coolchic_tpu_torch.models.warp import shift_references
from coolchic_tpu_torch.models.warp import warp_fn as p_warp
from tests.test_torch_inter_forward import load_frames

torch.set_num_threads(2)
H, W = 40, 56


def _dense(f):
    from coolchic_tpu.io.yuv import convert_420_to_444

    return convert_420_to_444(f.data).astype(np.float32)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((2, 3, H, W)).astype(np.float32)
    flow = rng.normal(0, 3, (2, 2, H, W)).astype(np.float32)
    flow[1] += np.asarray([35.0, -20.0], np.float32)[:, None, None]  # mostly off-frame
    return x, flow


@pytest.mark.parametrize("filter_size", [2, 4, 8])
@pytest.mark.parametrize("training", [False, True])
def test_warp_values_and_flow_grads(filter_size, training):
    x, flow = _inputs()
    want = np.concatenate([np.asarray(j_warp(x[g:g + 1], flow[g:g + 1], filter_size,
                                             training)) for g in range(2)])
    got = p_warp(torch.tensor(x), torch.tensor(flow), filter_size, training)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)

    w_out = np.random.default_rng(1).random(x.shape).astype(np.float32)
    f = torch.tensor(flow).requires_grad_()
    (p_warp(torch.tensor(x), f, filter_size, training) * torch.tensor(w_out)).sum().backward()
    for g in range(2):
        jg = np.asarray(jax.grad(lambda fl: jnp.sum(
            j_warp(jnp.asarray(x[g:g + 1]), fl, filter_size, training)
            * w_out[g:g + 1]))(jnp.asarray(flow[g:g + 1])))[0]
        pg = f.grad[g].numpy()
        if not training:   # the 1/64 quantization: no gradient in either
            assert np.abs(jg).max() == 0 and np.abs(pg).max() == 0
            continue
        assert np.linalg.norm(pg - jg) <= 1e-4 * np.linalg.norm(jg), \
            (g, np.linalg.norm(pg - jg) / np.linalg.norm(jg))


def test_nearest_warp_and_global_shift():
    x, flow = _inputs()
    np.testing.assert_array_equal(p_nearest(x[:1], flow[:1]), np.asarray(j_nearest(
        x[:1], flow[:1])))
    gflows = [np.asarray([3.0, -7.0], np.float32), np.asarray([-40.0, 2.0], np.float32)]
    refs = [x[:1], x[1:]]
    want = j_agt(refs, gflows)
    for a, b in zip(p_agt(refs, gflows), want):
        np.testing.assert_array_equal(a, b)
    # the forward's batched shift (an integer index shift per slot) is the
    # nearest warp of the constant flow
    got = shift_references([torch.tensor(x)], [torch.tensor(np.stack(gflows))])[0]
    for g in range(2):
        np.testing.assert_array_equal(got[g:g + 1].numpy(), want[g])


def test_global_translation_identical():
    frames = load_frames()
    d = [_dense(f) for f in frames]
    for target, refs in ((d[2], [d[0]]), (d[1], [d[0], d[2]])):
        (ps, pf), (js, jf) = p_gmt(target, refs), j_gmt(target, refs)
        for a, b in zip(pf, jf):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(ps, js):
            np.testing.assert_array_equal(a, b)
    # a known shift: the target is frame 0 translated by (dx, dy) = (-6, 4)
    # (edge-replicated): the search finds exactly that
    shifted = j_nearest(d[0], np.broadcast_to(np.asarray([-6.0, 4.0], np.float32)
                                              .reshape(1, 2, 1, 1), (1, 2, *d[0].shape[-2:])))
    _, flows = p_gmt(shifted, [d[0]])
    np.testing.assert_array_equal(flows[0], [-6.0, 4.0])
    np.testing.assert_array_equal(flows[0], j_gmt(shifted, [d[0]])[1][0])


@pytest.mark.parametrize("crop", [None, (3, 5, 101, 147)])
@pytest.mark.parametrize("pair", [(1, 0), (2, 0)])
def test_estimate_flow(crop, pair):
    """BQSquare 0->1 and 0->2 (the flows of a B and of a P frame), at full
    size and on an odd-sized crop (the pyramid's _down2 truncates odd sizes,
    so the upsampled flow is not always 2x the coarse one)."""
    frames = load_frames()
    t, r = (_dense(frames[i]) for i in pair)
    if crop is not None:
        y0, x0, h, w = crop
        t, r = t[..., y0:y0 + h, x0:x0 + w], r[..., y0:y0 + h, x0:x0 + w]
    tt, rt = torch.tensor(t), torch.tensor(r)
    one = p_flow(tt, rt, n_levels=1, n_iters=1).numpy()
    np.testing.assert_allclose(one, np.asarray(j_flow(t, r, n_levels=1, n_iters=1)),
                               rtol=0, atol=1e-3)
    got = p_flow(tt, rt).numpy()
    want = np.asarray(j_flow(t, r))
    assert got.shape == want.shape == (1, 2, *t.shape[-2:])
    diff = np.abs(got - want)
    assert (diff <= 1e-3).mean() >= 0.94 and (diff <= 1e-2).mean() >= 0.99
    assert diff.mean() <= 1e-3

    def pred_db(fl):
        pred = np.asarray(j_warp(r, fl, 8))
        return -10 * np.log10(np.mean((pred - t) ** 2))
    assert abs(pred_db(got) - pred_db(want)) <= 0.01


@pytest.mark.parametrize("coarse, fine", [((6, 9), (12, 18)), ((12, 18), (25, 36)),
                                          ((25, 36), (50, 73)), ((7, 5), (15, 11))])
def test_flow_upsampling_matches_jax_resize(coarse, fine):
    """The pyramid's flow upsampling (models/flow.py): the port's bilinear
    against jax.image.resize, to exactly 2x and to the sizes _down2 leaves
    when it truncates an odd row or column."""
    from coolchic_tpu_torch.ops.resize import interpolate

    flow = np.random.default_rng(3).normal(0, 2, (1, 2, *coarse)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(flow), (1, 2, *fine), "bilinear"))
    got = interpolate(torch.tensor(flow), fine, "bilinear").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_bt709_conversions():
    rgb = np.random.default_rng(2).random((2, 3, 8, 12)).astype(np.float32)
    np.testing.assert_array_equal(p_rgb2yuv(rgb), j_rgb2yuv(rgb))
    yuv = j_rgb2yuv(rgb)
    np.testing.assert_array_equal(p_yuv2rgb(yuv), j_yuv2rgb(yuv))
