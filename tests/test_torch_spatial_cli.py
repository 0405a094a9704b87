"""The spatially sharded encode from the user-facing path
(train/video.py:encode_one_frame's spatial_shard, the CLI's
--spatial_shard), on the CPU:

  - encode_one_frame(spatial_shard=4) against spatial_shard=0 on kodim15
    tiled 2 x 1 (256x192, real pixels; lop, a main phase of 10 steps, no
    warm-up, no RDOQ, as tests/test_spatial_cli.py's TinyPreset): PSNR
    within 0.1 dB and bytes within 5 %; the sharded file decodes in the
    JAX package's decoder to the encoder's PSNR;
  - the --spatial_shard rules through resolve_spatial_shard (auto, the
    card count, the refusal) and the CLI's refusal of an explicit count
    without the cards;
  - the serial warm-up tournament (train/warmup.py:warmup) against the
    JAX package's from the same candidates: the same winner.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coolchic_tpu.bitstream.decode import decode_video as j_decode_video
from coolchic_tpu.train.presets import PresetDebug as JPresetDebug
from coolchic_tpu.train.train import EncoderMonitor as JMonitor
from coolchic_tpu.train.warmup import warmup as j_warmup
from coolchic_tpu_torch import cc_encode
from coolchic_tpu_torch.io.framedata import FrameData
from coolchic_tpu_torch.io.io import load_frame_data_from_file, save_frame_data_to_file
from coolchic_tpu_torch.models.params import tree_from_numpy
from coolchic_tpu_torch.train.presets import Preset, TrainerPhase, Warmup
from coolchic_tpu_torch.train.presets import PresetDebug
from coolchic_tpu_torch.parallel.batch import make_mesh
from coolchic_tpu_torch.parallel.spatial import resolve_spatial_shard, spatial_mesh_for
from coolchic_tpu_torch.train.video import encode_one_frame
from coolchic_tpu_torch.train.warmup import warmup as p_warmup
from coolchic_tpu_torch.utils.codingstructure import CodingStructure
from coolchic_tpu_torch.utils.parsecli import intra_operating_points
from tests.test_torch_train_step import _max_abs_diff, _setup, _stack_np

torch.set_num_threads(2)
REPO = __import__("pathlib").Path(__file__).resolve().parent.parent
KODIM15 = str(REPO / "tests/data/192x128_kodim15.png")


class TinyPreset(Preset):
    def __post_init__(self):
        self.preset_name = "ci-spatial"
        self.training_phases = [
            TrainerPhase(lr=self.start_lr, max_itr=10, freq_valid=5,
                         quantizer_type="softround", quantizer_noise_type="gaussian",
                         softround_temperature=(0.3, 0.3), noise_parameter=(0.25, 0.25),
                         lmbda=self.lmbda)]
        self.warmup = Warmup([])


def _tiled(tmp_path) -> str:
    f = load_frame_data_from_file(KODIM15)
    big = FrameData(f.bitdepth, f.frame_data_type,
                    np.ascontiguousarray(np.tile(np.asarray(f.data), (1, 1, 2, 1))))
    path = str(tmp_path / "big.ppm")
    save_frame_data_to_file(big, path)
    return path


def test_spatial_shard_encode_matches_whole(tmp_path):
    video_path = _tiled(tmp_path)
    out = {}
    for shard in (0, 4):
        cs = CodingStructure(n_frames=1, intra_pos=[0])
        wd = str(tmp_path / f"wd{shard}")
        os.makedirs(wd)
        out[shard] = encode_one_frame(
            cs.get_frame_from_coding_order(0), cs, video_path, wd,
            TinyPreset(lmbda=1e-3, start_lr=1e-2, itr_main_training=10),
            {"residue": intra_operating_points()["lop"]}, verbose=False, rdoq=False,
            profile="ref", device="cpu", spatial_shard=shard)
    p0, p4 = out[0]["logs"].psnr_db, out[4]["logs"].psnr_db
    b0, b4 = out[0]["n_bytes"], out[4]["n_bytes"]
    assert abs(p0 - p4) < 0.1, (p0, p4)
    assert abs(b0 - b4) / b0 < 0.05, (b0, b4)

    path = str(tmp_path / "sharded.cool")
    with open(path, "wb") as f:
        f.write(out[4]["payload"])
    dec = j_decode_video(path)["0"]
    ref = np.asarray(load_frame_data_from_file(video_path).data, np.float64)
    psnr = -10 * np.log10(np.mean(np.square(np.asarray(dec.data, np.float64) - ref)))
    assert abs(psnr - p4) < 0.3, (psnr, p4)


def test_spatial_shard_rules(tmp_path):
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    big, small = 2 * 1024 * 1024, 2 * 1024 * 1024 - 1
    assert resolve_spatial_shard("auto", cuda, 4, big) == 4
    assert resolve_spatial_shard("auto", cuda, 4, small) == 0
    assert resolve_spatial_shard("auto", cuda, 1, big) == 0
    assert resolve_spatial_shard("auto", cpu, 0, big) == 0
    assert resolve_spatial_shard("0", cuda, 1, big) == 0
    assert resolve_spatial_shard("2", cuda, 2, small) == 2
    assert resolve_spatial_shard("4", cpu, 0, small) == 4
    with pytest.raises(ValueError, match="--spatial_shard 2 needs that many devices, have 1"):
        resolve_spatial_shard("2", cuda, 1, big)
    # the encode refuses too, before any work, on a device without the cards
    if torch.cuda.device_count() < 8:
        with pytest.raises((ValueError, RuntimeError)):
            spatial_mesh_for(8, cuda)
    assert spatial_mesh_for(3, cpu).devices == (cpu,) * 3
    assert spatial_mesh_for(1, cpu) is None
    # the CLI on the CPU: an explicit count runs there (--nobitstream keeps
    # it short); without a card, --device cuda is refused before any work
    argv = ["-i", KODIM15, "-o", str(tmp_path / "o.cool"), "--workdir", str(tmp_path / "w"),
            "--recipe", "debug", "--n_itr", "1", "--dec_cfg_residue", "lop",
            "--spatial_shard", "2", "--no_rdoq", "--nobitstream"]
    assert cc_encode.main([*argv, "--device", "cpu"]) == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cc_encode.main([*argv, "--device", "cuda"])


def test_serial_warmup_matches_jax(monkeypatch):
    """The tournament itself (the serial loop, the eval ranking, the
    pruning, the winner) against the JAX package's from the same three
    candidates: each package's train() replaced by the same deterministic
    stand-in (every leaf times 0.9 a phase), so that the ranking is decided
    by each package's own eval. The real train() with JAX's noise is held
    to JAX's in tests/test_torch_serial_train.py: from a fresh optimizer
    state, steps that differ by rounding diverge too far for a tournament
    of a few steps to be compared through them."""
    import coolchic_tpu.train.warmup as jw
    import coolchic_tpu_torch.train.warmup as pw
    from coolchic_tpu_torch.train.params import tree_map as p_tree_map

    jf, pf, stacked, target = _setup(3, perturb=True, crop=(32, 48))
    cands = [jax.tree_util.tree_map(lambda x, i=i: np.asarray(x[i]), stacked)
             for i in range(3)]
    calls = {"jax": [], "port": []}

    def j_fake(params, fcfg, target, phase, **kw):
        calls["jax"].append(phase.max_itr)
        return jax.tree_util.tree_map(lambda x: x * 0.9, params)

    def p_fake(params, fcfg, target, phase, **kw):
        calls["port"].append(phase.max_itr)
        assert kw["spatial_mesh"] is not None
        return p_tree_map(lambda x: x * 0.9, params)

    monkeypatch.setattr(jw, "train", j_fake)
    monkeypatch.setattr(pw, "train", p_fake)
    kw = dict(lmbda=1e-3, start_lr=1e-2, itr_main_training=1)
    j_preset, p_preset = JPresetDebug(**kw), PresetDebug(**kw)   # 3 then 2 candidates
    j_win = j_warmup([jax.tree_util.tree_map(jnp.asarray, c) for c in cands], j_preset, jf,
                     jnp.asarray(target), key=jax.random.PRNGKey(0), monitor=JMonitor())
    p_win = p_warmup([tree_from_numpy(c, "cpu") for c in cands], p_preset, pf,
                     torch.tensor(target), noise_source=None,
                     spatial_mesh=make_mesh(4, space=4, device="cpu"))
    assert calls["port"] == calls["jax"] == [10] * 5
    j_np = jax.tree_util.tree_map(np.asarray, j_win)
    p_np = jax.tree_util.tree_map(lambda x: x.numpy(), p_win)
    assert _max_abs_diff(tree_from_numpy(_stack_np([p_np]), "cpu"), _stack_np([j_np])) <= 1e-6
    # the winner is not the first candidate, so that the ranking decided it
    assert _max_abs_diff(tree_from_numpy(_stack_np([cands[0]]), "cpu"),
                         _stack_np([j_np])) > 1e-3
