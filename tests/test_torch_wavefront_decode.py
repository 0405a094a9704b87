"""Port wavefront decode (coolchic_tpu_torch/ops/wavefront_decode.py) against
the host C++ tpu-profile codec and the JAX package's Pallas kernel in
interpret mode, on the same numpy inputs. Integer results are bit-exact.

The JAX package is imported inside the tests that use it, so the CUDA case
also runs where JAX is not installed:
    python -m pytest --noconftest tests/test_torch_wavefront_decode.py -m cuda
"""

import numpy as np
import pytest
import torch

from coolchic_tpu_torch.bitstream import rangecoder as rc
from coolchic_tpu_torch.bitstream.tpu_cdf import arm8_bounds_ok, arm8_from_int_layers
from coolchic_tpu_torch.core.constants import (
    MU_MIN_FIXED_POINT,
    N_POSSIBLE_SCALE,
    non_zero_pixel_ctx_index,
)
from coolchic_tpu_torch.ops import wavefront_decode as wfd

torch.set_num_threads(2)

LANES = 128


def _random_arm8(rng, n_spatial, n_ifce, stab=False, n_hidden=1):
    dim = n_spatial + n_ifce
    w_lim = 40 if n_hidden <= 1 else 10   # deeper ARMs stay inside the certificate
    layers = [{"weight": rng.integers(-w_lim, w_lim, size=(dim, dim)),
               "bias": rng.integers(-100, 100, size=(dim,))}
              for _ in range(n_hidden)]
    layers.append({"weight": rng.integers(-60, 60, size=(2, dim)),
                   "bias": rng.integers(-100, 100, size=(2,))})
    stabiliser = None
    if stab:
        stabiliser = {"weight": rng.integers(-20, 20, size=(2, dim)),
                      "bias": rng.integers(-50, 50, size=(2,))}
    arm8 = arm8_from_int_layers(layers, -6, -12, stabiliser=stabiliser,
                                subtract_last_layer=True, n_inter_ft_ctx=n_ifce)
    assert arm8_bounds_ok(arm8, np.full(dim, 64.0 * 256.0))
    return arm8


def _encoded_job(h, w, n_spatial, n_ifce, seed, stab=False, ifce_max=2000,
                 n_hidden=1):
    """A random grid coded on 128 streams by the host C++ encoder: returns
    (job for decode_grids, the grid)."""
    rng = np.random.default_rng(seed)
    arm8 = _random_arm8(rng, n_spatial, n_ifce, stab=stab, n_hidden=n_hidden)
    data = rng.integers(-8, 8, size=(h, w)).astype(np.int64)
    ifce = (rng.integers(-ifce_max, ifce_max, size=(h * w, n_ifce)).astype(np.int64)
            if n_ifce else None)
    encoders = [rc.RangeEncoder() for _ in range(LANES)]
    rc.code_grid_streams(encoders, True, h, w, n_spatial, ifce, arm8,
                         non_zero_pixel_ctx_index(n_spatial), data=data, model=1)
    words = [np.frombuffer(e.get_bytes(), dtype=np.uint32) for e in encoders]
    return {"words": words, "arm8": arm8, "ifce": ifce}, data


def _cpp_decode(job, h, w, n_spatial):
    decoders = [rc.RangeDecoder(ws.tobytes()) for ws in job["words"]]
    return rc.code_grid_streams(decoders, False, h, w, n_spatial, job["ifce"],
                                job["arm8"], non_zero_pixel_ctx_index(n_spatial),
                                model=1)


def _pallas_decode(jobs, h, w, n_spatial, n_ifce):
    from coolchic_tpu.ops.pallas_decode import decode_grids_pallas

    return decode_grids_pallas(jobs, h, w, non_zero_pixel_ctx_index(n_spatial),
                               n_ifce, interpret=True)


# (h, w, n_spatial, n_ifce, seed, stab, ifce_packed, against_pallas, n_hidden)
CASES = {
    "no_ifce": (24, 32, 8, 0, 0, False, False, True, 1),
    "ifce_stab": (20, 48, 12, 2, 1, True, False, True, 1),
    "ifce_packed": (20, 48, 12, 3, 3, True, True, False, 1),
    "tall": (150, 16, 8, 0, 2, False, False, False, 1),
    "wide_step6": (6, 700, 8, 2, 4, False, False, True, 1),
    "wide_step11": (4, 1408, 8, 0, 6, False, False, True, 1),
    # the main path's ARM shapes: 0 and 2 hidden layers, hop's 14 + 6
    # int16-packed IFCE inputs, a width of 13 (11 + 2: no multiple of a
    # team), 13 + 3 (an odd spatial count), and a wide 32 + 8
    "hidden0": (24, 32, 8, 0, 20, True, False, False, 0),
    "hidden2": (20, 48, 12, 2, 21, True, False, True, 2),
    "hop_packed": (20, 40, 14, 6, 22, True, True, False, 2),
    "odd_width": (20, 40, 11, 2, 23, True, False, False, 2),
    "width16": (20, 40, 13, 3, 24, True, False, False, 2),
    "wide_arm": (12, 40, 32, 8, 25, True, False, False, 2),
}


def _case_job(case):
    h, w, n_spatial, n_ifce, seed, stab, packed, _, n_hidden = CASES[case]
    return _encoded_job(h, w, n_spatial, n_ifce, seed, stab=stab,
                        ifce_max=16000 if packed else 2000, n_hidden=n_hidden)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_cpp_and_pallas(case):
    h, w, n_spatial, n_ifce, _, _, packed, against_pallas, _ = CASES[case]
    job, data = _case_job(case)
    np.testing.assert_array_equal(_cpp_decode(job, h, w, n_spatial), data)
    got = wfd.decode_grids([job], h, w, non_zero_pixel_ctx_index(n_spatial), n_ifce,
                           device="cpu", ifce_packed=packed)[0]
    np.testing.assert_array_equal(got, data)
    if against_pallas:
        np.testing.assert_array_equal(_pallas_decode([job], h, w, n_spatial, n_ifce)[0],
                                      got)


def test_plain_grid_batch_heterogeneous():
    """G = 3 grids with different ARM weights, payloads and IFCE contexts in
    one call, each bit-exact against its own C++ decode and the Pallas
    kernel's batched decode."""
    h, w, n_spatial, n_ifce = 20, 40, 8, 2
    pairs = [_encoded_job(h, w, n_spatial, n_ifce, seed, stab=seed % 2 == 0)
             for seed in (10, 11, 12)]
    jobs = [j for j, _ in pairs]
    got = wfd.decode_grids(jobs, h, w, non_zero_pixel_ctx_index(n_spatial), n_ifce,
                           device="cpu")
    ref = _pallas_decode(jobs, h, w, n_spatial, n_ifce)
    assert len(got) == 3
    for (job, data), g, r in zip(pairs, got, ref):
        np.testing.assert_array_equal(_cpp_decode(job, h, w, n_spatial), data)
        np.testing.assert_array_equal(g, data)
        np.testing.assert_array_equal(r, g)


def _hop_batch_pairs():
    """G = 3 grids at hop's ARM shape (14 + 6 inputs, int16-packed IFCE, 2
    hidden layers), with different weights, payloads and IFCE contexts."""
    return [_encoded_job(20, 40, 14, 6, seed, stab=seed % 2 == 0, ifce_max=16000,
                         n_hidden=2) for seed in (30, 31, 32)]


def test_plain_grid_batch_two_hidden():
    pairs = _hop_batch_pairs()
    got = wfd.decode_grids([j for j, _ in pairs], 20, 40, non_zero_pixel_ctx_index(14),
                           6, device="cpu", ifce_packed=True)
    assert len(got) == 3
    for (job, data), g in zip(pairs, got):
        np.testing.assert_array_equal(_cpp_decode(job, 20, 40, 14), data)
        np.testing.assert_array_equal(g, data)


def test_step_rule_matches_jax():
    from coolchic_tpu.ops import pallas_decode as pdk

    for w in (10, 127, 128, 640, 641, 768, 1408, 16383):
        assert wfd.tpu_wavefront_step(w) == pdk.tpu_wavefront_step(w)
        step = wfd.tpu_wavefront_step(w)
        assert wfd._off_max(step) == pdk._off_max(step)
    for n in (1, 64, 65, 1000, 5000):
        assert wfd.words_bucket(n) == pdk.words_bucket(n)
    ctx_idx = non_zero_pixel_ctx_index(24)
    assert wfd._tap_list(ctx_idx) == pdk._tap_list(ctx_idx)


def test_slope_of_exhaustive():
    from coolchic_tpu.bitstream import tpu_cdf

    idx = torch.arange(N_POSSIBLE_SCALE, dtype=torch.int64)
    np.testing.assert_array_equal(wfd._slope_of(idx).numpy(),
                                  tpu_cdf.slope_table().astype(np.int64))


def test_left_cum_dense_sample():
    from coolchic_tpu.bitstream import tpu_cdf

    rng = np.random.default_rng(5)
    n = 200_000
    s = rng.integers(tpu_cdf.SYM_MIN, tpu_cdf.SYM_MAX + 1, size=n)
    mu_fp = rng.integers(0, 32768, size=n) + MU_MIN_FIXED_POINT
    sc = rng.integers(0, N_POSSIBLE_SCALE, size=n)
    # the extremes of every axis, all combined
    ext = np.array(np.meshgrid([tpu_cdf.SYM_MIN, -1, 0, 1, tpu_cdf.SYM_MAX],
                               [MU_MIN_FIXED_POINT, -1, 0, 32767 + MU_MIN_FIXED_POINT],
                               [0, 1, 1280, N_POSSIBLE_SCALE - 1])).reshape(3, -1)
    s, mu_fp, sc = (np.concatenate([a, e]) for a, e in zip((s, mu_fp, sc), ext))
    slope = wfd._slope_of(torch.as_tensor(sc))
    got = wfd._left_cum(torch.as_tensor(s), torch.as_tensor(mu_fp), slope).numpy()
    np.testing.assert_array_equal(got, tpu_cdf.left_cum(s, mu_fp, sc).astype(np.int64))


def test_wrapper_refuses_bad_inputs():
    job, _ = _encoded_job(20, 32, 8, 0, 7)
    arrays = wfd.pack_jobs([job], 20, 32, 0)
    t = {k: torch.as_tensor(v) for k, v in arrays.items()}
    kw = dict(h=20, w=32, taps=wfd._tap_list(non_zero_pixel_ctx_index(8)),
              dims=((8, 8), (8, 2)), n_ifce=0, ifce_packed=False)
    with pytest.raises(ValueError, match="int32"):
        wfd.wavefront_decode(t["words"].to(torch.int64), t["wtr"], t["btr"],
                             t["stw"], t["stb"], t["ifce"], **kw)
    with pytest.raises(ValueError, match="ifce must be"):
        wfd.wavefront_decode(t["words"], t["wtr"], t["btr"], t["stw"], t["stb"],
                             t["ifce"][:-1], **kw)


def _binary_search(quant, mu_fp, sc):
    """The reference's 7-step binary search on tpu_cdf.left_cum: (symbol,
    left, prob)."""
    from coolchic_tpu.bitstream import tpu_cdf

    s = np.full(quant.shape, tpu_cdf.SYM_MIN, np.int64)
    for st in (64, 32, 16, 8, 4, 2, 1):
        cand = s + st
        ok = (cand <= tpu_cdf.SYM_MAX) & (
            tpu_cdf.left_cum(np.minimum(cand, tpu_cdf.SYM_MAX), mu_fp, sc) <= quant)
        s = np.where(ok, cand, s)
    left = tpu_cdf.left_cum(s, mu_fp, sc).astype(np.int64)
    nxt = tpu_cdf.left_cum(np.minimum(s + 1, tpu_cdf.SYM_MAX), mu_fp, sc).astype(np.int64)
    return s, left, np.where(s >= tpu_cdf.SYM_MAX, (1 << 24) - left, nxt - left)


def test_exp2_neg24_32_exhaustive():
    """The kernel's 32-bit Horner equals tpu_cdf.exp2_neg24 on every one of
    the 2^24 fractions and on every shift the clamp to 31 touches, with each
    intermediate inside the bounds its source comment states."""
    from coolchic_tpu.bitstream import tpu_cdf

    chunk = 1 << 22
    for lo in range(0, 1 << 24, chunk):
        t = np.arange(lo, lo + chunk, dtype=np.int64)
        got, ok = wfd.exp2_neg24_32_model(t)
        assert ok
        np.testing.assert_array_equal(got, tpu_cdf.exp2_neg24(t.astype(np.uint64)))
    rng = np.random.default_rng(8)
    q = np.repeat(np.r_[np.arange(42), rng.integers(42, 1 << 16, 64), (1 << 16) - 1], 512)
    f = rng.integers(0, 1 << 24, q.size)
    f[::512] = 0
    f[1::512] = (1 << 24) - 1
    t = (q << 24) | f
    got, ok = wfd.exp2_neg24_32_model(t)
    assert ok
    np.testing.assert_array_equal(got, tpu_cdf.exp2_neg24(t.astype(np.uint64)))


def test_team_search_matches_binary_search():
    """The kernel's 8-ary team search (and its 32-bit left_cum) gives the
    symbol, left and prob of the 7-step binary search, on a dense (quantile,
    mu, scale) sample with the extremes of every axis and quantiles on and
    just below every CDF step of a sample of models."""
    from coolchic_tpu.bitstream import tpu_cdf

    rng = np.random.default_rng(9)
    n = 100_000
    quant = rng.integers(0, 1 << 24, n)
    mu_fp = rng.integers(0, 32768, n) + MU_MIN_FIXED_POINT
    sc = rng.integers(0, N_POSSIBLE_SCALE, n)
    ext = np.array(np.meshgrid([0, 1, 1 << 23, (1 << 24) - 1],
                               [MU_MIN_FIXED_POINT, -129, -128, 0, 32767 + MU_MIN_FIXED_POINT],
                               [0, 1, 1280, N_POSSIBLE_SCALE - 1])).reshape(3, -1)
    m = 2000
    mu_b = np.repeat(rng.integers(0, 32768, m) + MU_MIN_FIXED_POINT, 128)
    sc_b = np.repeat(rng.integers(0, N_POSSIBLE_SCALE, m), 128)
    steps = tpu_cdf.left_cum(np.tile(np.arange(-64, 64), m), mu_b, sc_b).astype(np.int64)
    quant, mu_fp, sc = (np.concatenate(parts) for parts in zip(
        (quant, mu_fp, sc), ext,
        (steps, mu_b, sc_b), (np.maximum(steps - 1, 0), mu_b, sc_b)))
    slope = tpu_cdf.slope_table()[sc].astype(np.int64)

    k = rng.integers(0, 128, quant.size)
    lc, ok = wfd.left_cum_32_model(k, mu_fp, slope)
    assert ok
    np.testing.assert_array_equal(lc, tpu_cdf.left_cum(k - 64, mu_fp, sc))
    got = wfd.team_search_model(quant, mu_fp, slope)
    for g, r in zip(got, _binary_search(quant, mu_fp, sc)):
        np.testing.assert_array_equal(g, r)


def test_quantile_fp64_estimate():
    """The kernel's FP64-estimate division with its one exact correction
    equals min(t // scale, 2^24 - 1) for t < 2^64 and scale in [2^8, 2^40),
    and the estimate is never more than one off."""
    rng = np.random.default_rng(10)
    qmax = (1 << 24) - 1
    n = 200_000
    scale = np.exp2(rng.uniform(8, 40, n)).astype(np.uint64)
    scale = np.clip(scale, 1 << 8, (1 << 40) - 1).astype(np.uint64)
    # decoder-like t = q * scale + r, q <= 2^24 + 2^16, r < scale
    q = rng.integers(0, (1 << 24) + (1 << 16) + 1, n).astype(np.uint64)
    t_dec = q * scale + (rng.random(n) * scale.astype(np.float64)).astype(np.uint64) % scale
    t_any = rng.integers(0, np.iinfo(np.uint64).max, n, dtype=np.uint64, endpoint=True)
    edges_t, edges_s = [0, (1 << 64) - 1], [256, 256]
    for s_ in (256, 257, 1000003, (1 << 32) - 1, 1 << 32, (1 << 40) - 1,
               *rng.integers(256, 1 << 40, 8).tolist()):
        for k in (0, 1, qmax - 1, qmax, qmax + 1, 1 << 24, (1 << 24) + (1 << 16),
                  *rng.integers(0, 1 << 24, 8).tolist()):
            for dt in (-1, 0, 1):
                t_ = k * s_ + dt
                if 0 <= t_ < (1 << 64):
                    edges_t.append(t_)
                    edges_s.append(s_)
    t = np.concatenate([t_dec, t_any, np.array(edges_t, np.uint64)])
    scale = np.concatenate([scale, scale, np.array(edges_s, np.uint64)])
    got, off = wfd.quantile_model(t, scale)
    np.testing.assert_array_equal(got, np.minimum(t // scale, np.uint64(qmax)).astype(np.int64))
    assert np.abs(off).max() <= 1
    assert (off == 1).any() and (off == -1).any()   # both corrections are exercised


CUDA_CASES = list(CASES) + ["grid_batch", "grid_batch_two_hidden"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_CASES)
def test_kernel_matches_plain_cuda(case):
    """The CUDA kernel against its plain version on the card, and both
    against the encoded grid."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    if case == "grid_batch":
        h, w, n_spatial, n_ifce, packed = 20, 40, 8, 2, False
        pairs = [_encoded_job(h, w, n_spatial, n_ifce, s, stab=s % 2 == 0)
                 for s in (10, 11, 12)]
    elif case == "grid_batch_two_hidden":
        h, w, n_spatial, n_ifce, packed = 20, 40, 14, 6, True
        pairs = _hop_batch_pairs()
    else:
        h, w, n_spatial, n_ifce, _, _, packed, _, _ = CASES[case]
        pairs = [_case_job(case)]
    jobs = [j for j, _ in pairs]
    ctx_idx = non_zero_pixel_ctx_index(n_spatial)
    before = wfd.KERNEL.launches
    got = wfd.decode_grids(jobs, h, w, ctx_idx, n_ifce, device="cuda",
                           ifce_packed=packed)
    torch.cuda.synchronize()
    assert wfd.KERNEL.launches == before + 1
    plain = wfd.decode_grids(jobs, h, w, ctx_idx, n_ifce, device="cuda",
                             ifce_packed=packed, plain=True)
    for (_, data), g, p in zip(pairs, got, plain):
        np.testing.assert_array_equal(p, data)
        np.testing.assert_array_equal(g, data)
