"""The port's RDOQ pieces (coolchic_tpu_torch/nnquant/rdoq.py) against the
JAX package's (coolchic_tpu/nnquant/rdoq.py), on the same numpy inputs.

  - _expgol_rate_bits: equal on every integer in +-65535, counts 0..8.
  - Each scorer on the same (flat_w, flat_b, idxs, vals, activations): ARM
    and IFCE (rate) at lop on a 64x96 crop of kodim15, synthesis row tiles
    in RGB and yuv420, the upsampling full scorer, and the rescale case
    (size_per_latent[0] != img_size: synthesis and upsampling through the
    full scorer). Bar: 1e-5 relative per lane. The distortion of the
    reconstruction scorers is taken after 8-bit rounding, where a one-ulp
    difference between torch's and XLA's convs flips a sample by one code
    value; a lane above 1e-5 must be explained by flips of under 0.1 % of
    its samples (each flip moves the squared error by at most
    (2 + 1/255) / 255 per sample).
  - The sweep: one synthetic scorer, written in jnp and in torch with exact
    dyadic arithmetic (every loss exact in f32, so both frameworks compute
    the same numbers), through JAX's _sweep_device / _sweep_host and the
    port's _sweep (epsilon 0 / 1e-9): identical final vectors and adjusted
    counts, with planted ties and with a forced rollback.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coolchic_tpu.io.io import load_frame_data_from_file
from coolchic_tpu.models.coolchic import coolchic_init as j_cc_init
from coolchic_tpu.models.coolchic import ifce_context as j_ifce_context
from coolchic_tpu.models.coolchic import synthesis_input as j_synthesis_input
from coolchic_tpu.models.upsampling import upsampling_apply as j_upsampling_apply
from coolchic_tpu.nnquant import rdoq as J
from coolchic_tpu.ops.context import spatial_context as j_spatial_context
from coolchic_tpu.utils.parsecli import INTRA_OPERATING_POINTS
from coolchic_tpu.utils.parsecli import coolchic_config_from_args as j_cfg_from_args
from coolchic_tpu_torch.nnquant import rdoq as P
from coolchic_tpu_torch.utils.parsecli import coolchic_config_from_args as p_cfg_from_args
from coolchic_tpu_torch.utils.parsecli import intra_operating_points

torch.set_num_threads(2)
REPO = __import__("pathlib").Path(__file__).resolve().parent.parent
IMG = str(REPO / "tests/data/192x128_kodim15.png")
LMBDA = 1e-3
BUDGET = 64 * 2**20
Q_SHIFT = {"weight": -7, "bias": -10}


@pytest.mark.parametrize("count", range(9))
def test_expgol_rate_bits_matches_jax(count):
    v = np.arange(-65535, 65536, dtype=np.float32)
    j_each = np.asarray(jax.vmap(lambda x: J._expgol_rate_bits(x, count))(jnp.asarray(v)))
    p_each = P._expgol_bits(torch.tensor(v), count).numpy()
    np.testing.assert_array_equal(p_each, j_each)
    assert float(P._expgol_rate_bits(torch.tensor(v), count)) == \
        float(J._expgol_rate_bits(jnp.asarray(v), count))


# ---------------------------------------------------------------------------
# Scorers
# ---------------------------------------------------------------------------
def _quantized(cfg, seed, perturb=0.05):
    """JAX-initialized cool-chic params of `cfg`, away from init (latents of
    a few quantization steps, weights perturbed), snapped to the q grid."""
    params = jax.tree_util.tree_map(np.asarray, j_cc_init(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)
    params["latents"] = [np.round(rng.normal(0, 2.0, x.shape)).astype(np.float32)
                         / cfg.encoder_gain for x in params["latents"]]
    params = jax.tree_util.tree_map(
        lambda x: (x + rng.normal(0, perturb, x.shape)).astype(np.float32)
        if x.ndim and x.size < 5000 else x, params)
    for m in ("arm", "ifce", "upsampling", "synthesis"):
        for wb in ("weight", "bias"):
            flat = J._flat(params, cfg, m, wb)
            if flat.size:
                q = 2.0 ** Q_SHIFT[wb]
                params = J._set_flat(params, cfg, m, wb, np.round(flat / q) * q)
    return jax.tree_util.tree_map(np.asarray, params)


def _probe(flat, q, shifts, n_scalars, seed):
    """(idxs [S], vals [S, C]) of a probe: S scalars, every shift."""
    rng = np.random.default_rng(seed)
    idxs = rng.choice(flat.size, size=min(n_scalars, flat.size), replace=False)
    vals = flat[idxs][:, None] + np.asarray(shifts, np.float32)[None, :] * np.float32(q)
    return idxs.astype(np.int32), vals.astype(np.float32)


def _lop(size=(64, 96)):
    jcfg = j_cfg_from_args(INTRA_OPERATING_POINTS["lop"], size)
    pcfg = p_cfg_from_args(intra_operating_points()["lop"], size)
    assert repr(jcfg) == repr(pcfg)
    return jcfg, pcfg


def _target(h, w):
    frame = load_frame_data_from_file(IMG)
    return np.asarray(frame.data, np.float32)[:, :, :h, :w]


def _compare(p_losses, j_losses, n_samples=None):
    """Per lane within 1e-5 relative; for a reconstruction scorer a lane
    above it must be explained by 8-bit flips of under 0.1 % of samples."""
    p = p_losses.numpy().astype(np.float64).reshape(-1)
    j = np.asarray(j_losses, np.float64).reshape(-1)
    assert np.isfinite(j).all() and np.isfinite(p).all()
    err = np.abs(p - j)
    off = err > 1e-5 * np.abs(j)
    if n_samples is None:
        assert not off.any(), (err / np.abs(j)).max()
        return 0
    # the loss is dist = sse / n_samples (+ the same NN term): one flip
    # moves sse by at most (2 + 1/255) / 255
    flips = np.ceil(err * n_samples / ((2 + 1 / 255) / 255))
    assert (flips[off] < 1e-3 * n_samples).all(), flips[off].max()
    return int(off.sum())


@pytest.mark.parametrize("module,wb", [("arm", "weight"), ("arm", "bias"),
                                       ("ifce", "weight"), ("ifce", "bias")])
def test_rate_scorer_matches_jax(module, wb):
    jcfg, pcfg = _lop()
    params = _quantized(jcfg, 0)
    latents = [np.round(g * jcfg.encoder_gain) for g in params["latents"]]
    lat = np.concatenate([g.reshape(-1) for g in latents]).astype(np.float32)
    ctx_sp = np.concatenate([np.asarray(j_spatial_context(jnp.asarray(g),
                                                          jcfg.spatial_context_arm))
                             for g in latents])
    ctx_if = np.asarray(j_ifce_context(params, jcfg, [jnp.asarray(g) for g in latents]))
    q, cnt = 2.0 ** Q_SHIFT[wb], 2
    sw = tuple(J._module_shapes(params, jcfg, module, "weight"))
    sb = tuple(J._module_shapes(params, jcfg, module, "bias"))
    arm_sw = tuple(J._module_shapes(params, jcfg, "arm", "weight"))
    arm_sb = tuple(J._module_shapes(params, jcfg, "arm", "bias"))
    fw, fb = J._flat(params, jcfg, module, "weight"), J._flat(params, jcfg, module, "bias")
    idxs, vals = _probe(fw if wb == "weight" else fb, q, J.ARM_SHIFTS, 3, 1)
    n_chunks = 3
    lat_c = jnp.asarray(J._pad_chunks(lat, n_chunks))
    mask_c = jnp.asarray(J._pad_chunks(np.ones_like(lat), n_chunks))
    arm_fw, arm_fb = J._flat(params, jcfg, "arm", "weight"), J._flat(params, jcfg, "arm", "bias")
    if module == "arm":
        ctx = np.concatenate([ctx_sp, ctx_if], axis=1)
        acts = (lat_c, jnp.asarray(J._pad_chunks(ctx, n_chunks)), mask_c)
        p_score = P._make_rate_scorer(pcfg, module, wb, q, cnt, list(sw), list(sb),
                                      torch.tensor(lat), torch.tensor(ctx), BUDGET)
    else:
        acts = (lat_c, jnp.asarray(J._pad_chunks(ctx_sp, n_chunks)), mask_c,
                jnp.asarray(arm_fw), jnp.asarray(arm_fb), *map(jnp.asarray, latents))
        p_score = P._make_rate_scorer(
            pcfg, module, wb, q, cnt, list(sw), list(sb), torch.tensor(lat),
            torch.tensor(ctx_sp), BUDGET, torch.tensor(arm_fw), torch.tensor(arm_fb),
            list(arm_sw), list(arm_sb), [torch.tensor(g) for g in latents])
    j_score = J._make_rate_scorer(jcfg, module, wb, q, cnt, sw, sb, arm_sw, arm_sb, n_chunks)
    j_l = j_score(jnp.asarray(fw), jnp.asarray(fb), jnp.asarray(idxs), jnp.asarray(vals), *acts)
    p_l = p_score(torch.tensor(fw), torch.tensor(fb), torch.tensor(idxs, dtype=torch.int64),
                  torch.tensor(vals))
    _compare(p_l, j_l)


def _syn_setup(cfg, params, frame_data_type):
    """The synthesis input and target of an I frame, numpy."""
    latents = [np.round(g * cfg.encoder_gain) for g in params["latents"]]
    syn_grids = [jnp.asarray(g) for g, hyper in zip(latents, cfg.flag_is_hyperlatent)
                 if not hyper]
    dense = j_upsampling_apply(params["upsampling"], syn_grids, cfg.ups_k_size,
                               cfg.ups_preconcat_k_size, training=False)
    rescale = cfg.size_per_latent[0] != cfg.img_size
    syn_in = np.asarray(dense[None] if rescale else j_synthesis_input(cfg, dense, None))
    h, w = cfg.img_size
    target = _target(h, w)
    if frame_data_type == "yuv420":
        # a 444 target whose chroma is constant on 2x2 blocks, like a
        # converted 420 frame
        uv = target[:, 1:].reshape(1, 2, h // 2, 2, w // 2, 2).mean(axis=(3, 5))
        target = np.concatenate([target[:, :1], uv.repeat(2, axis=2).repeat(2, axis=3)],
                                axis=1)
    return latents, syn_in, target


@pytest.mark.parametrize("frame_data_type", ["rgb", "yuv420"])
@pytest.mark.parametrize("wb", ["weight", "bias"])
def test_syn_tile_scorer_matches_jax(frame_data_type, wb):
    jcfg, pcfg = _lop()
    params = _quantized(jcfg, 1)
    _, syn_in, target = _syn_setup(jcfg, params, frame_data_type)
    q, cnt = 2.0 ** Q_SHIFT[wb], 1
    sw = tuple(J._module_shapes(params, jcfg, "synthesis", "weight"))
    sb = tuple(J._module_shapes(params, jcfg, "synthesis", "bias"))
    fw = J._flat(params, jcfg, "synthesis", "weight")
    fb = J._flat(params, jcfg, "synthesis", "bias")
    idxs, vals = _probe(fw if wb == "weight" else fb, q, J.SYN_SHIFTS, 4, 2)
    n_tiles = 3   # tiles overlapping at the bottom edge: 64 rows in 3 x 22 (or 22 / 24)
    j_score = J._make_syn_scorer(jcfg, wb, LMBDA, q, cnt, sw, sb, frame_data_type, 8,
                                 n_tiles)
    j_l = j_score(jnp.asarray(fw), jnp.asarray(fb), jnp.asarray(idxs), jnp.asarray(vals),
                  jnp.asarray(syn_in), jnp.asarray(target))
    p_score = P._make_syn_scorer(pcfg, wb, LMBDA, q, cnt, list(sw), list(sb),
                                 frame_data_type, 8, n_tiles, torch.tensor(syn_in),
                                 torch.tensor(target))
    p_l = p_score(torch.tensor(fw), torch.tensor(fb), torch.tensor(idxs, dtype=torch.int64),
                  torch.tensor(vals))
    n_samples = 64 * 96 * (3 if frame_data_type == "rgb" else 1.5)
    _compare(p_l, j_l, n_samples)
    # a tile count sized from memory changes only the summation order
    p_one = P._make_syn_scorer(pcfg, wb, LMBDA, q, cnt, list(sw), list(sb),
                               frame_data_type, 8, 1, torch.tensor(syn_in),
                               torch.tensor(target))(
        torch.tensor(fw), torch.tensor(fb), torch.tensor(idxs, dtype=torch.int64),
        torch.tensor(vals))
    np.testing.assert_allclose(p_one.numpy(), p_l.numpy(), rtol=1e-6)


def _tiny_cfg(img_size, latent_resolution):
    """tests/test_rdoq.py's tiny config, in both packages."""
    from coolchic_tpu.core.arch import CoolChicConfig as JC
    from coolchic_tpu_torch.core.arch import CoolChicConfig as PC

    kw = dict(layers_synthesis=("8-1-linear-relu", "3-3-linear-none"),
              linear_stabiliser_synth=False, ups_k_size=8, ups_preconcat_k_size=7,
              ifce_resolution=None, output_feature_ifce=0, spatial_context_arm=8,
              linear_stabiliser_arm=False, n_hidden_layers_arm=1,
              latent_resolution=latent_resolution, hyperlatent_resolution=None,
              flag_common_randomness=False, img_size=img_size)
    return JC(**kw), PC(**kw)


@pytest.mark.parametrize("case,module", [("lop", "upsampling"), ("rescale", "synthesis"),
                                         ("rescale", "upsampling")])
def test_full_scorer_matches_jax(case, module):
    if case == "lop":
        jcfg, pcfg = _lop()
    else:   # tests/test_rdoq.py:177-219: the top grid at half resolution
        jcfg, pcfg = _tiny_cfg((32, 48), (1, 3))
        assert jcfg.size_per_latent[0] != jcfg.img_size
    params = _quantized(jcfg, 2)
    latents, syn_in, target = _syn_setup(jcfg, params, "rgb")
    wb = "weight"
    q, cnt = 2.0 ** Q_SHIFT[wb], 1
    sw = tuple(J._module_shapes(params, jcfg, module, "weight"))
    sb = tuple(J._module_shapes(params, jcfg, module, "bias"))
    ssw = tuple(J._module_shapes(params, jcfg, "synthesis", "weight"))
    ssb = tuple(J._module_shapes(params, jcfg, "synthesis", "bias"))
    fw, fb = J._flat(params, jcfg, module, "weight"), J._flat(params, jcfg, module, "bias")
    idxs, vals = _probe(fw, q, J.SYN_SHIFTS, 3, 3)
    syn_grids = [g for g, hyper in zip(latents, jcfg.flag_is_hyperlatent) if not hyper]
    syn_fw = J._flat(params, jcfg, "synthesis", "weight")
    syn_fb = J._flat(params, jcfg, "synthesis", "bias")
    j_score = J._make_full_scorer(jcfg, module, wb, LMBDA, q, cnt, sw, sb, ssw, ssb, "rgb",
                                  8, "I", "residue", len(syn_grids), False, 0, 4)
    if module == "synthesis":
        j_acts = (jnp.asarray(syn_in), jnp.asarray(target))
        p_score = P._make_full_scorer(pcfg, module, wb, LMBDA, q, cnt, list(sw), list(sb),
                                      "rgb", 8, torch.tensor(target), BUDGET,
                                      syn_in=torch.tensor(syn_in))
    else:
        j_acts = (jnp.asarray(syn_fw), jnp.asarray(syn_fb), jnp.asarray(target),
                  *map(jnp.asarray, syn_grids))
        p_score = P._make_full_scorer(
            pcfg, module, wb, LMBDA, q, cnt, list(sw), list(sb), "rgb", 8,
            torch.tensor(target), BUDGET, syn_flat_w=torch.tensor(syn_fw),
            syn_flat_b=torch.tensor(syn_fb), syn_shapes_w=list(ssw), syn_shapes_b=list(ssb),
            grids=[torch.tensor(g) for g in syn_grids])
    j_l = j_score(jnp.asarray(fw), jnp.asarray(fb), jnp.asarray(idxs), jnp.asarray(vals),
                  *j_acts)
    p_l = p_score(torch.tensor(fw), torch.tensor(fb), torch.tensor(idxs, dtype=torch.int64),
                  torch.tensor(vals))
    _compare(p_l, j_l, float(np.prod(target.shape)))


# ---------------------------------------------------------------------------
# The sweep, on a synthetic scorer exact in f32
# ---------------------------------------------------------------------------
N_SYN = 24
Q_SYN = 1 / 16


def _synthetic(case):
    """(flat, per-scalar weights A, targets T, coupling B, sum target S0):
    loss(x) = sum A (x - T)^2 + B (sum x - S0)^2, every value dyadic with
    few bits, so each loss and partial sum is exact in f32.
    "ties": B = 0; a third of the scalars sit exactly between two shifts of
    the ladder (T = x + 1/32: shifts 0 and +1 tie, no edit; T = x + 3/32:
    +1 and +2 tie, the first wins).
    "rollback": a strong coupling pulls every scalar up, so a chunk applied
    jointly overshoots and the next chunk's base regresses."""
    rng = np.random.default_rng(5)
    x = (rng.integers(-12, 13, N_SYN) * Q_SYN).astype(np.float32)
    if case == "ties":
        off = rng.integers(-20, 21, N_SYN) / 32
        off[::3] = 1 / 32
        off[1::3] = 3 / 32
        return x, rng.integers(1, 4, N_SYN).astype(np.float32), (x + off).astype(np.float32), \
            0.0, 0.0
    return (x, np.ones(N_SYN, np.float32) / 4, x.astype(np.float32), 2.0,
            float(x.sum() + 2.0))


def _j_scorer(case):
    _, A, T, B, S0 = _synthetic(case)
    A, T = jnp.asarray(A), jnp.asarray(T)

    def one(fw, idx, val):
        v = fw.at[idx].set(val)
        return jnp.sum(A * jnp.square(v - T)) + B * jnp.square(jnp.sum(v) - S0)

    def scorer(fw, fb, idxs, vals):
        return jax.vmap(jax.vmap(one, (None, None, 0)), (None, 0, 0))(fw, idxs, vals)

    return scorer


def _p_scorer(case):
    _, A, T, B, S0 = _synthetic(case)
    A, T = torch.tensor(A), torch.tensor(T)

    def scorer(fw, fb, idxs, vals):
        S, C = vals.shape
        v, _, _ = P._lanes(fw, fb, "weight", idxs, vals)
        return (torch.sum(A * torch.square(v - T), dim=1)
                + B * torch.square(v.sum(dim=1) - S0)).reshape(S, C)

    return scorer


_J_SCORERS = {}


@pytest.mark.parametrize("case", ["ties", "rollback"])
@pytest.mark.parametrize("kind", ["device", "host"])
def test_sweep_matches_jax(case, kind, capsys):
    flat = _synthetic(case)[0]
    fb = np.zeros(2, np.float32)
    scorer = _J_SCORERS.setdefault(case, _j_scorer(case))
    j_sweep = J._sweep_device if kind == "device" else J._sweep_host
    j_w, _ = j_sweep(scorer, flat.copy(), fb, "weight", J.ARM_SHIFTS, Q_SYN, (), 4,
                     np.random.default_rng(3), True, "syn.weight")
    j_adjusted = int(re.search(r"(\d+)/%d scalars adjusted" % N_SYN,
                               capsys.readouterr().out).group(1))
    stats = {}
    p_w, _ = P._sweep(_p_scorer(case), flat.copy(), fb, "weight", J.ARM_SHIFTS, Q_SYN, 4,
                      np.random.default_rng(3), 0.0 if kind == "device" else 1e-9,
                      torch.device("cpu"), stats)
    np.testing.assert_array_equal(p_w, np.asarray(j_w))
    assert stats["adjusted"] == j_adjusted > 0
    assert not np.array_equal(p_w, flat)
    if case == "rollback":
        assert stats["rollbacks"] > 0
    else:
        assert stats["ties"] > 0
