"""The port's float decode tail (learned upsampling, synthesis, resize)
against the JAX package's, with the decoded hop parameters of the repo's
128x192 bitstreams carried through params_from_jax and latent grids made
from a seed with numpy. Tolerance 2e-5: both sides are f32, and only the
summation order differs (conv algorithm, einsum grouping)."""

import glob
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coolchic_tpu.bitstream import headers as jh
from coolchic_tpu.bitstream.codec import _decoded_nn_to_jax
from coolchic_tpu.bitstream.nncodec import decode_network
from coolchic_tpu.models.synthesis import synthesis_apply, synthesis_apply_batched
from coolchic_tpu.models.upsampling import upsampling_apply
from coolchic_tpu.ops.resize import interpolate as j_interpolate
from coolchic_tpu_torch.core.arch import CoolChicConfig
from coolchic_tpu_torch.models.params import params_from_jax
from coolchic_tpu_torch.models.synthesis import synthesis_batched
from coolchic_tpu_torch.models.upsampling import upsampling_batched
from coolchic_tpu_torch.ops.resize import interpolate as p_interpolate

torch.set_num_threads(2)

ATOL = 2e-5
REPO = Path(__file__).resolve().parent.parent
FILES = sorted(glob.glob(str(REPO / "results/round4/h2h_kodim15_v3/*.cool")))


def _load(path):
    _, rest = jh.VideoHeader.read(Path(path).read_bytes())
    _, rest = jh.FrameHeader.read(rest)
    ch, rest = jh.CoolChicHeader.read(rest)
    jcfg = ch.to_config()
    nn = decode_network(rest[:ch.nn_n_bytes], jcfg, ch.nn_q_step_shift,
                        ch.nn_expgol_cnt, ch.nn_n_bit_pad)
    pcfg = CoolChicConfig(**{f: getattr(jcfg, f) for f in
                             CoolChicConfig.__dataclass_fields__
                             if CoolChicConfig.__dataclass_fields__[f].init})
    return jcfg, pcfg, nn


@pytest.fixture(scope="module")
def hop():
    assert len(FILES) >= 3
    loaded = [_load(p) for p in FILES[:3]]
    cfg = loaded[0][0]
    assert cfg.img_size == (128, 192) and cfg.output_feature_ifce == 6
    rng = np.random.default_rng(0)
    grids = [[rng.integers(-8, 8, size=s).astype(np.float32)
              for s, hyper in zip(cfg.size_per_latent, cfg.flag_is_hyperlatent)
              if not hyper] for _ in loaded]
    return loaded, grids


def test_upsampling_matches(hop):
    loaded, grids = hop
    mods = []
    for (jcfg, pcfg, nn), gr in zip(loaded, grids):
        want = np.asarray(upsampling_apply(_decoded_nn_to_jax(nn)["upsampling"],
                                           [jnp.asarray(g) for g in gr],
                                           jcfg.ups_k_size, jcfg.ups_preconcat_k_size,
                                           training=True))
        ups, _ = params_from_jax(nn, pcfg, "cpu")
        mods.append(ups)
        got = ups([torch.as_tensor(g) for g in gr]).numpy()
        assert got.shape == want.shape == (len(gr), *jcfg.img_size)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
        if len(mods) == 1:
            first_want = want
    # the batched form (per-image kernels) equals the per-image one
    batched = upsampling_batched(mods, [torch.as_tensor(np.stack(gs))
                                        for gs in zip(*grids)]).numpy()
    np.testing.assert_allclose(batched[0], first_want, atol=ATOL, rtol=0)


def test_synthesis_matches(hop):
    loaded, _ = hop
    rng = np.random.default_rng(1)
    jcfg, pcfg, _ = loaded[0]
    x = rng.normal(size=(len(loaded), jcfg.input_feature_synthesis, *jcfg.img_size)
                   ).astype(np.float32)
    mods = [params_from_jax(nn, pc, "cpu")[1] for _, pc, nn in loaded]
    for g, (jc, _, nn) in enumerate(loaded):
        want = np.asarray(synthesis_apply(_decoded_nn_to_jax(nn)["synthesis"], jc,
                                          jnp.asarray(x[g:g + 1])))
        got = mods[g](torch.as_tensor(x[g:g + 1])).numpy()
        assert got.shape == want.shape == (1, 3, *jc.img_size)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)

    stacked = jax.tree.map(lambda *xs: jnp.stack([jnp.asarray(v) for v in xs]),
                           *[_decoded_nn_to_jax(nn)["synthesis"] for _, _, nn in loaded])
    want_b = np.asarray(synthesis_apply_batched(stacked, jcfg, jnp.asarray(x)))
    got_b = synthesis_batched(mods, torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got_b, want_b, atol=ATOL, rtol=0)


@pytest.mark.parametrize("mode", ["bicubic", "bilinear", "nearest"])
@pytest.mark.parametrize("size", [(128, 192), (64, 96), (33, 47), (256, 384)])
def test_interpolate_matches(mode, size):
    x = np.random.default_rng(2).normal(size=(1, 3, 64, 96)).astype(np.float32)
    want = np.asarray(j_interpolate(jnp.asarray(x), size, mode))
    got = p_interpolate(torch.as_tensor(x), size, mode).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_common_randomness_tail_matches():
    """The common-randomness inputs of the host-route float tail: the
    normative noise stream and its bicubic fixed upsampling."""
    from coolchic_tpu.core.noise import common_randomness_grids as j_noise
    from coolchic_tpu.models.upsampling import fixed_upsampling as j_fixed
    from coolchic_tpu_torch.core.noise import common_randomness_grids as p_noise
    from coolchic_tpu_torch.models.upsampling import fixed_upsampling as p_fixed

    sizes = [(32, 48), (16, 24), (8, 12), (4, 6)]
    jn, pn = j_noise(sizes), p_noise(sizes)
    for a, b in zip(jn, pn):
        np.testing.assert_array_equal(a, b)
    want, _ = j_fixed([jnp.asarray(g) for g in jn], mode="bicubic")
    got = p_fixed([torch.as_tensor(g) for g in pn], mode="bicubic")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
