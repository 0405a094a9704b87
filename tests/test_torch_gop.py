"""The port's GOP driver pieces against the JAX package's: the dependency
waves (parallel/gop.py), the per-depth operating points and presets of
encode_video (train/video.py:frame_cfg_args, _frame_preset) with the
relaxed iteration floor, the configs every cfg/dec/{residue,motion} file
builds at P and B, and the result writers and BD-rate
(utils/results.py)."""

import numpy as np
import pytest
import torch

from coolchic_tpu.parallel.gop import gop_waves as j_gop_waves
from coolchic_tpu.parallel.gop import slurm_afterok_equivalent as j_plan
from coolchic_tpu.train.video import _frame_preset as j_frame_preset
from coolchic_tpu.train.video import frame_cfg_args as j_frame_cfg_args
from coolchic_tpu.utils import results as j_results
from coolchic_tpu.utils.codingstructure import CodingStructure as JCodingStructure
from coolchic_tpu.utils.parsecli import MOTION_OPERATING_POINTS, RESIDUE_OPERATING_POINTS
from coolchic_tpu.utils.parsecli import coolchic_config_from_args as j_cfg_from_args
from coolchic_tpu.utils.parsecli import parse_frame_positions
from coolchic_tpu_torch.parallel.gop import gop_waves, slurm_afterok_equivalent
from coolchic_tpu_torch.train.video import _frame_preset, frame_cfg_args
from coolchic_tpu_torch.utils import results
from coolchic_tpu_torch.utils.codingstructure import CodingStructure, Frame
from coolchic_tpu_torch.utils.parsecli import coolchic_config_from_args as p_cfg_from_args
from coolchic_tpu_torch.utils.parsecli import (
    motion_operating_points,
    residue_operating_points,
)

torch.set_num_threads(2)

GOPS = [(5, "0", "-1"), (9, "0", "-1"), (9, "0", "4,8"), (9, "0,8", ""), (17, "0", "-1"),
        (17, "0,8", "4,12,16"), (17, "0,16", "")]


@pytest.mark.parametrize("n_frames,intra_pos,p_pos", GOPS)
def test_gop_waves_match_jax(n_frames, intra_pos, p_pos):
    kw = dict(n_frames=n_frames, intra_pos=parse_frame_positions(intra_pos, n_frames),
              p_pos=parse_frame_positions(p_pos, n_frames))
    j_cs, p_cs = JCodingStructure(**kw), CodingStructure(**kw)
    j_waves, p_waves = j_gop_waves(j_cs), gop_waves(p_cs)
    assert [[(f.display_order, f.coding_order, f.frame_type, f.depth, f.index_references)
             for f in w] for w in p_waves] == \
        [[(f.display_order, f.coding_order, f.frame_type, f.depth, f.index_references)
          for f in w] for w in j_waves]
    assert slurm_afterok_equivalent(p_cs) == j_plan(j_cs)
    assert p_cs.pretty_string() == j_cs.pretty_string()
    assert p_cs.pretty_structure_diagram() == j_cs.pretty_structure_diagram()


def _frame(frame_type: str, depth: int) -> Frame:
    refs = {"I": [], "P": [0], "B": [0, 2]}[frame_type]
    return Frame(coding_order=1, display_order=1, depth=depth, index_references=list(refs))


FRAMES = [("I", 0), ("P", 1)] + [("B", d) for d in (1, 2, 3, 4)]


@pytest.mark.parametrize("itr_floor", [2000, 50])
@pytest.mark.parametrize("itr_scale", [1.0, 0.01])
@pytest.mark.parametrize("frame_type,depth", FRAMES)
def test_frame_presets_match_jax(frame_type, depth, itr_scale, itr_floor, monkeypatch):
    """frame_cfg_args and _frame_preset equal JAX's; the relaxed floor is a
    keyword in the port and COOLCHIC_ITR_FLOOR in the JAX package."""
    from coolchic_tpu.utils.codingstructure import Frame as JFrame

    monkeypatch.setenv("COOLCHIC_ITR_FLOOR", str(itr_floor))
    assert frame_cfg_args(frame_type, depth) == j_frame_cfg_args(frame_type, depth)
    jf = JFrame(coding_order=1, display_order=1, depth=depth,
                index_references=list(_frame(frame_type, depth).index_references))
    j_args, j_preset = j_frame_preset(jf, 1e-3, itr_scale)
    p_args, p_preset = _frame_preset(_frame(frame_type, depth), 1e-3, itr_scale,
                                     itr_floor=itr_floor)
    assert p_args == j_args
    assert type(p_preset).__name__ == type(j_preset).__name__
    for key in ("lmbda", "start_lr", "itr_main_training", "itr_motion_pretrain",
                "preset_name"):
        assert getattr(p_preset, key) == getattr(j_preset, key), key
    for key in ("training_phases", "warmup", "motion_pretrain_phase"):
        assert repr(getattr(p_preset, key)) == repr(getattr(j_preset, key)), key
    for lam in (1e-4, 1e-3, 2e-2):
        assert p_preset.warmup_noise_parameter(lam) == j_preset.warmup_noise_parameter(lam)


@pytest.mark.parametrize("frame_type", ["P", "B"])
@pytest.mark.parametrize("kind,name", [("residue", n) for n in ("vlop", "lop", "mop", "hop")]
                         + [("motion", n) for n in ("lop", "mop")])
def test_inter_operating_points_match_jax(kind, name, frame_type):
    """Every cfg/dec/{residue,motion}/*.cfg equals the JAX package's table
    and builds the same config at P and B."""
    table = {"residue": (residue_operating_points, RESIDUE_OPERATING_POINTS),
             "motion": (motion_operating_points, MOTION_OPERATING_POINTS)}[kind]
    p_op, j_op = table[0]()[name], table[1][name]
    assert p_op == j_op
    size = (128, 224)
    assert repr(p_cfg_from_args(p_op, size, coolchic_name=kind, frame_type=frame_type)) == \
        repr(j_cfg_from_args(j_op, size, coolchic_name=kind, frame_type=frame_type))


def _rows(mod):
    return [mod.SequenceResult(lmbda=1e-3, seq_name="kodim01", n_pixels=393216,
                               loss=1.234567891e-3, psnr_db=31.123456, rate_bpp=0.4567891),
            mod.SequenceResult(lmbda=0.0004, seq_name="kodim02", n_pixels=6144,
                               loss=0.5, psnr_db=40.0, rate_bpp=2.0)]


def test_results_tsv_byte_identical(tmp_path):
    """write_results_tsv (fresh, then appended) and write_frame_results
    write JAX's bytes."""
    assert results.RESULT_HEADER == j_results.RESULT_HEADER
    for mod, name in ((results, "p.tsv"), (j_results, "j.tsv")):
        rows = _rows(mod)
        mod.write_results_tsv(str(tmp_path / name), rows[:1])
        mod.write_results_tsv(str(tmp_path / name), rows[1:], append=True)
        mod.write_results_tsv(str(tmp_path / ("w" + name)), rows)
        logs = type("Logs", (), dict(loss=1.5e-3, psnr_db=33.25, total_rate_latent_bpp=0.75))
        mod.write_frame_results(str(tmp_path / ("f" + name)), seq_name="s", lmbda=1e-3,
                                n_pixels=10, logs=logs, rate_bpp=0.8,
                                extra={"frame_type": "B", "n_bytes": 7})
    for stem in ("", "w", "f"):
        assert (tmp_path / f"{stem}p.tsv").read_bytes() == \
            (tmp_path / f"{stem}j.tsv").read_bytes()
    assert (tmp_path / "p.tsv").read_bytes() == (tmp_path / "wp.tsv").read_bytes()


CURVES = [
    ([0.1, 0.2, 0.4, 0.8], [28.0, 30.5, 33.1, 35.9], [0.11, 0.21, 0.43, 0.9],
     [28.2, 30.4, 33.0, 36.1]),
    ([0.25, 0.5, 1.0], [30.0, 32.0, 34.5], [0.3, 0.55, 1.1], [30.2, 32.1, 34.4]),
    ([0.05, 0.09, 0.2, 0.35, 0.7], [26.1, 27.9, 30.2, 32.0, 34.4],
     [0.05, 0.1, 0.19, 0.36, 0.72], [26.0, 28.1, 30.1, 32.2, 34.3]),
]


@pytest.mark.parametrize("curve", range(len(CURVES)))
def test_bd_rate_matches_jax(curve):
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", np.exceptions.RankWarning)
        got = results.bd_rate(*CURVES[curve])
        want = j_results.bd_rate(*CURVES[curve])
    assert abs(got - want) <= 1e-9, (got, want)
    assert np.isfinite(got)
