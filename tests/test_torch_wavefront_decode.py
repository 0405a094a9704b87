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


def _random_arm8(rng, n_spatial, n_ifce, stab=False):
    dim = n_spatial + n_ifce
    layers = [{"weight": rng.integers(-40, 40, size=(dim, dim)),
               "bias": rng.integers(-100, 100, size=(dim,))},
              {"weight": rng.integers(-60, 60, size=(2, dim)),
               "bias": rng.integers(-100, 100, size=(2,))}]
    stabiliser = None
    if stab:
        stabiliser = {"weight": rng.integers(-20, 20, size=(2, dim)),
                      "bias": rng.integers(-50, 50, size=(2,))}
    arm8 = arm8_from_int_layers(layers, -6, -12, stabiliser=stabiliser,
                                subtract_last_layer=True, n_inter_ft_ctx=n_ifce)
    assert arm8_bounds_ok(arm8, np.full(dim, 64.0 * 256.0))
    return arm8


def _encoded_job(h, w, n_spatial, n_ifce, seed, stab=False, ifce_max=2000):
    """A random grid coded on 128 streams by the host C++ encoder: returns
    (job for decode_grids, the grid)."""
    rng = np.random.default_rng(seed)
    arm8 = _random_arm8(rng, n_spatial, n_ifce, stab=stab)
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


# (h, w, n_spatial, n_ifce, seed, stab, ifce_packed, against_pallas)
CASES = {
    "no_ifce": (24, 32, 8, 0, 0, False, False, True),
    "ifce_stab": (20, 48, 12, 2, 1, True, False, True),
    "ifce_packed": (20, 48, 12, 3, 3, True, True, False),
    "tall": (150, 16, 8, 0, 2, False, False, False),
    "wide_step6": (6, 700, 8, 2, 4, False, False, True),
    "wide_step11": (4, 1408, 8, 0, 6, False, False, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_cpp_and_pallas(case):
    h, w, n_spatial, n_ifce, seed, stab, packed, against_pallas = CASES[case]
    job, data = _encoded_job(h, w, n_spatial, n_ifce, seed, stab=stab,
                             ifce_max=16000 if packed else 2000)
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


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["no_ifce", "ifce_stab", "ifce_packed", "tall",
                                  "wide_step6", "wide_step11", "grid_batch"])
def test_kernel_matches_plain_cuda(case):
    """The CUDA kernel against its plain version on the card, and both
    against the encoded grid."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    if case == "grid_batch":
        h, w, n_spatial, n_ifce, packed = 20, 40, 8, 2, False
        pairs = [_encoded_job(h, w, n_spatial, n_ifce, s, stab=s % 2 == 0)
                 for s in (10, 11, 12)]
    else:
        h, w, n_spatial, n_ifce, seed, stab, packed, _ = CASES[case]
        pairs = [_encoded_job(h, w, n_spatial, n_ifce, seed, stab=stab,
                              ifce_max=16000 if packed else 2000)]
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
