"""The port's detailed logs and complexity accounting against the JAX
package's: utils/complexity.py, train/logs.py (detailed_test, the
reference-schema TSV writers, pretty_string / pretty_logs) and the CLI's
archi.txt.

  - macs_per_module, total_mac_per_pixel and pretty_complexity equal for
    every cfg/dec/intra/*.cfg operating point at 512x768;
  - detailed_test on the same NN-quantized params (192x128 kodim15, lop,
    with and without common randomness): the same keys in the same order,
    floats within 1e-5 relative, everything else equal;
  - the writers, fed the same log dict, write byte-identical files, and
    pretty_string / pretty_logs return identical strings; archi.txt is
    byte-identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cc_encode as j_cli
from coolchic_tpu.io.io import load_frame_data_from_file
from coolchic_tpu.models.frame import FrameConfig as JFrameConfig
from coolchic_tpu.models.frame import frame_cr_grids as j_cr_grids
from coolchic_tpu.models.frame import frame_encoder_init as j_frame_init
from coolchic_tpu.nnquant.rdoq import _flat, _set_flat
from coolchic_tpu.train import logs as J
from coolchic_tpu.utils import complexity as JC
from coolchic_tpu.utils.parsecli import INTRA_OPERATING_POINTS
from coolchic_tpu.utils.parsecli import coolchic_config_from_args as j_cfg_from_args
from coolchic_tpu_torch import cc_encode as p_cli
from coolchic_tpu_torch.models.frame import FrameConfig
from coolchic_tpu_torch.models.frame import frame_cr_grids as p_cr_grids
from coolchic_tpu_torch.train import logs as P
from coolchic_tpu_torch.utils import complexity as PC
from coolchic_tpu_torch.utils.parsecli import coolchic_config_from_args as p_cfg_from_args
from coolchic_tpu_torch.utils.parsecli import intra_operating_points

torch.set_num_threads(2)
REPO = __import__("pathlib").Path(__file__).resolve().parent.parent
IMG = str(REPO / "tests/data/192x128_kodim15.png")
OPS = sorted(p.stem for p in (REPO / "cfg/dec/intra").glob("*.cfg"))
LMBDA = 1e-3


def _cfgs(op, size, tune="mse"):
    jcfg = j_cfg_from_args(INTRA_OPERATING_POINTS[op], size, tune=tune)
    pcfg = p_cfg_from_args(intra_operating_points()[op], size, tune=tune)
    assert repr(jcfg) == repr(pcfg)
    return jcfg, pcfg


@pytest.mark.parametrize("op", OPS)
def test_complexity_matches_jax(op, tmp_path):
    jcfg, pcfg = _cfgs(op, (512, 768))
    assert PC.macs_per_module(pcfg) == JC.macs_per_module(jcfg)
    assert PC.total_mac_per_pixel(pcfg) == JC.total_mac_per_pixel(jcfg)
    assert PC.pretty_complexity(pcfg) == JC.pretty_complexity(jcfg)
    j_path, p_path = tmp_path / "j_archi.txt", tmp_path / "p_archi.txt"
    j_cli._write_archi(str(j_path), {"fcfg": JFrameConfig(coolchic_cfg={"residue": jcfg})})
    p_cli._write_archi(str(p_path), {"fcfg": FrameConfig(coolchic_cfg={"residue": pcfg})})
    assert p_path.read_bytes() == j_path.read_bytes()


@pytest.fixture(scope="module", params=["mse", "wasserstein"])
def logs(request):
    """Both packages' detailed_test of the same quantized params."""
    frame = load_frame_data_from_file(IMG)
    jcfg, pcfg = _cfgs("lop", frame.img_size, tune=request.param)
    jf, pf = JFrameConfig(coolchic_cfg={"residue": jcfg}), FrameConfig(coolchic_cfg={"residue": pcfg})
    params = jax.tree_util.tree_map(np.asarray, j_frame_init(jax.random.PRNGKey(4), jf))
    rng = np.random.default_rng(4)
    cc = params["residue"]
    cc["latents"] = [rng.normal(0, 2.5, x.shape).astype(np.float32) / jcfg.encoder_gain
                     for x in cc["latents"]]
    for lay in cc["arm"]["layers"] + cc["synthesis"]["layers"]:
        lay["weight"] = lay["weight"] + rng.normal(0, 0.05, lay["weight"].shape).astype(np.float32)
    q_shift, expgol = {}, {}
    for m in ("arm", "ifce", "upsampling", "synthesis"):
        for wb in ("weight", "bias"):
            q_shift[(m, wb)], expgol[(m, wb)] = (-7 if wb == "weight" else -10), 2
            flat = _flat(cc, jcfg, m, wb)
            if flat.size:
                q = 2.0 ** q_shift[(m, wb)]
                cc = _set_flat(cc, jcfg, m, wb, np.round(flat / q) * q)
    params["residue"] = jax.tree_util.tree_map(np.asarray, cc)
    side = {"residue": (q_shift, expgol)}
    target = np.asarray(frame.data, np.float32)
    kw = dict(lmbda=LMBDA, nn_side_info=side, encoding_time_second=12.25,
              encoding_iterations_cnt=110, display_order=0, coding_order=0, frame_offset=0,
              seq_name="kodim15")
    jl = J.detailed_test(params, jf, jnp.asarray(target), cr=j_cr_grids(jf), **kw)
    pl = P.detailed_test(params, pf, torch.tensor(target), cr=p_cr_grids(pf, "cpu"),
                         device="cpu", **kw)
    return jl, pl


def test_detailed_test_matches_jax(logs):
    jl, pl = logs
    assert list(pl) == list(jl)
    for k, jv in jl.items():
        pv = pl[k]
        assert type(pv) is type(jv), k
        if isinstance(jv, float):
            np.testing.assert_allclose(pv, jv, rtol=1e-5, atol=1e-12, err_msg=k)
        elif isinstance(jv, list):
            np.testing.assert_allclose(pv, jv, rtol=1e-5, atol=1e-12, err_msg=k)
        else:
            assert pv == jv, k


def test_writers_byte_identical(logs, tmp_path):
    jl, _ = logs
    jl = {**jl, "frame_type": "I", "n_bytes": 1234}
    J.write_reference_encoder_tsv(str(tmp_path / "j_enc.tsv"), jl)
    P.write_reference_encoder_tsv(str(tmp_path / "p_enc.tsv"), jl)
    assert (tmp_path / "p_enc.tsv").read_bytes() == (tmp_path / "j_enc.tsv").read_bytes()
    dec = dict(loss=jl["loss"], psnr_db=jl["psnr_db"], rate_bpp=jl["rate_bpp"], lmbda=LMBDA,
               seq_name="kodim15", n_pixels=jl["n_pixels"], display_order=0, coding_order=0)
    J.write_reference_decoder_tsv(str(tmp_path / "j_dec.tsv"), **dec)
    P.write_reference_decoder_tsv(str(tmp_path / "p_dec.tsv"), **dec)
    assert (tmp_path / "p_dec.tsv").read_bytes() == (tmp_path / "j_dec.tsv").read_bytes()
    # the JAX package writes NNNN-logs_detailed.tsv inline in
    # train/video.py:_finalize_frame
    with open(tmp_path / "j_det.tsv", "w") as f:
        keys = list(jl)
        f.write("\t".join(keys) + "\n")
        f.write("\t".join(f"{jl[k]:.6f}" if isinstance(jl[k], float)
                          else str(jl[k]) for k in keys) + "\n")
    P.write_detailed_tsv(str(tmp_path / "p_det.tsv"), jl)
    assert (tmp_path / "p_det.tsv").read_bytes() == (tmp_path / "j_det.tsv").read_bytes()
    for mode in ("all", "short"):
        for show in (True, False):
            assert P.pretty_string(jl, show, mode) == J.pretty_string(jl, show, mode)
    assert P.pretty_logs(jl) == J.pretty_logs(jl)
