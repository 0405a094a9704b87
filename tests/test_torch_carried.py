"""The numpy modules carried into the port (headers, NN codec, integer CDF,
X.8 fixed-point ARM) against the JAX package's originals, on the repo's
decoder-verified bitstreams."""

import dataclasses
import glob
from pathlib import Path

import numpy as np
import pytest
import torch

from coolchic_tpu.bitstream import headers as jh
from coolchic_tpu.bitstream import nncodec as jn
from coolchic_tpu.bitstream import tpu_cdf as jcdf
from coolchic_tpu.bitstream.codec import _ifce_fixed_params as j_ifce_fp
from coolchic_tpu.bitstream.codec import _main_arm_params as j_main_fp
from coolchic_tpu.core.constants import non_zero_pixel_ctx_index as j_ctx_idx
from coolchic_tpu_torch.bitstream import headers as ph
from coolchic_tpu_torch.bitstream import nncodec as pn
from coolchic_tpu_torch.bitstream import tpu_cdf as pcdf
from coolchic_tpu_torch.bitstream.codec import _ifce_fixed_params as p_ifce_fp
from coolchic_tpu_torch.bitstream.codec import _main_arm_params as p_main_fp
from coolchic_tpu_torch.core.constants import non_zero_pixel_ctx_index as p_ctx_idx
from coolchic_tpu_torch.models.arm import ifce_arm_index

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
ROUNDS = ("round3", "round4", "round5")
FILES = {r: sorted(glob.glob(str(REPO / "results" / r / "**" / "*.cool"), recursive=True))
         for r in ROUNDS}


def _assert_tree_equal(a, b, path="nn"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f"{path}[{i}]")
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape, path
        np.testing.assert_array_equal(x, y, err_msg=path)


def _walk(raw: bytes, mod):
    """(video header, [(frame header, [(cc header, nn bytes)]), ...])."""
    if raw.startswith(ph.TPU_PROFILE_MAGIC):
        raw = raw[len(ph.TPU_PROFILE_MAGIC):]
    vh, rest = mod.VideoHeader.read(raw)
    frames = []
    while rest:
        fh, rest = mod.FrameHeader.read(rest)
        ccs = []
        for _ in range(1 + (fh.frame_type in ("P", "B"))):
            ch, rest = mod.CoolChicHeader.read(rest)
            ccs.append((ch, rest[:ch.nn_n_bytes]))
            rest = rest[ch.nn_n_bytes + ch.n_bytes_latent:]
        frames.append((fh, ccs))
    return vh, frames


@pytest.mark.parametrize("rnd", ROUNDS)
def test_headers_and_networks_match(rnd):
    assert FILES[rnd], f"no .cool files under results/{rnd}"
    for path in FILES[rnd]:
        raw = Path(path).read_bytes()
        jv, jframes = _walk(raw, jh)
        pv, pframes = _walk(raw, ph)
        assert dataclasses.asdict(jv) == dataclasses.asdict(pv), path
        assert pv.to_bytes() == jv.to_bytes(), path
        assert len(jframes) == len(pframes), path
        for (jf, jccs), (pf, pccs) in zip(jframes, pframes):
            assert dataclasses.asdict(jf) == dataclasses.asdict(pf), path
            assert pf.to_bytes() == jf.to_bytes(), path
            for (jc, jnn), (pc, pnn) in zip(jccs, pccs):
                assert dataclasses.asdict(jc) == dataclasses.asdict(pc), path
                assert pc.to_bytes() == jc.to_bytes(), path
                jcfg, pcfg = jc.to_config(), pc.to_config()
                assert dataclasses.asdict(jcfg) == dataclasses.asdict(pcfg), path
                j_nn = jn.decode_network(jnn, jcfg, jc.nn_q_step_shift,
                                         jc.nn_expgol_cnt, jc.nn_n_bit_pad)
                p_nn = pn.decode_network(pnn, pcfg, pc.nn_q_step_shift,
                                         pc.nn_expgol_cnt, pc.nn_n_bit_pad)
                _assert_tree_equal(j_nn, p_nn, f"{path}:nn")


def test_slope_table_and_ctx_index_match():
    np.testing.assert_array_equal(pcdf.slope_table(), jcdf.slope_table())
    assert pcdf.slope_table().shape == (2561,)
    for n in range(0, 41):
        np.testing.assert_array_equal(p_ctx_idx(n), j_ctx_idx(n))


def test_arm8_params_and_certificates_match():
    for path in FILES["round5"]:
        raw = Path(path).read_bytes()
        _, jframes = _walk(raw, jh)
        _, pframes = _walk(raw, ph)
        (jc, jnn), (pc, pnn) = jframes[0][1][0], pframes[0][1][0]
        jcfg, pcfg = jc.to_config(), pc.to_config()
        j_nn = jn.decode_network(jnn, jcfg, jc.nn_q_step_shift, jc.nn_expgol_cnt,
                                 jc.nn_n_bit_pad)
        p_nn = pn.decode_network(pnn, pcfg, pc.nn_q_step_shift, pc.nn_expgol_cnt,
                                 pc.nn_n_bit_pad)
        for model in (0, 1):
            j_arm = j_main_fp(j_nn, jc, jcfg, model)
            p_arm = p_main_fp(p_nn, pc, pcfg, model)
            _assert_tree_equal(j_arm, p_arm, f"{path}:arm{model}")
        bound = np.full(pcfg.total_context_arm, 64.0 * 256.0)
        for scale in (1.0, 1e3, 1e5):
            assert (pcdf.arm8_bounds_ok(p_main_fp(p_nn, pc, pcfg, 1), bound * scale)
                    == jcdf.arm8_bounds_ok(j_main_fp(j_nn, jc, jcfg, 1), bound * scale))
        for level in ifce_arm_index(pcfg.input_features_ifce):
            for model in (0, 1):
                jf = j_ifce_fp(j_nn, jcfg, jc, level, model=model)
                pf = p_ifce_fp(p_nn, pcfg, pc, level, model=model)
                _assert_tree_equal(jf, pf, f"{path}:ifce{level}")
            pf = p_ifce_fp(p_nn, pcfg, pc, level, model=1)
            dim_in = pf["trunk_weights"][0].shape[0]
            assert pcdf.arm8_bounds_ok(pf, np.full(dim_in, 64.0 * 256.0)) == \
                jcdf.arm8_bounds_ok(j_ifce_fp(j_nn, jcfg, jc, level, model=1),
                                    np.full(dim_in, 64.0 * 256.0))
