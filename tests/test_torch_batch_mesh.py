"""The "data" axis of the port's mesh (parallel/batch.py, the mesh of
parallel/encode_batch.py) and the reference exchange between GOP waves
(parallel/gop.py), on the CPU:

  - phase_key equals the JAX package's; batched_init gives JAX's leaf
    paths and shapes, and every slot the fresh SOAP state that JAX
    broadcasts (its state carried by models/params.py: equal);
  - the mesh refuses what it cannot hold: a batch that does not divide
    over the data slices, and one noise stream shared by several slices;
  - make_batched_window over a 2- and a 4-slice data mesh against no mesh,
    from a carried state (a window of 3 steps, the slots' own SlotNoise
    streams): every slot's params and SOAP moments within 1e-6;
    _batched_phase (seeding, windows, per-slot λ, best and patience
    reload) over the mesh, each data slice's chunk against its own slots
    run without a mesh, within 1e-6;
  - encode_images_batched over a 2-slice mesh writes files that decode,
    the first slice's byte for byte those of its images alone;
  - exchange_references puts every needed frame on every distinct device.
The mesh names the CPU several times, as the JAX tests' virtual devices.
"""

import jax
import numpy as np
import pytest
import torch

from coolchic_tpu.models.frame import FrameConfig as JFrameConfig
from coolchic_tpu.parallel.batch import batched_init as j_batched_init
from coolchic_tpu.parallel.batch import phase_key as j_phase_key
from coolchic_tpu.train.presets import TrainerPhase as JPhase
from coolchic_tpu.utils.parsecli import INTRA_OPERATING_POINTS
from coolchic_tpu.utils.parsecli import coolchic_config_from_args as j_cfg_from_args
from coolchic_tpu_torch.bitstream.decode import decode_video as p_decode_video
from coolchic_tpu_torch.io.io import load_frame_data_from_file
from coolchic_tpu_torch.models.frame import FrameConfig
from coolchic_tpu_torch.models.params import soap_state_from_jax
from coolchic_tpu_torch.parallel.batch import (
    batched_init,
    make_batched_window,
    make_mesh,
    phase_key,
)
from coolchic_tpu_torch.parallel.encode_batch import _batched_phase, encode_images_batched
from coolchic_tpu_torch.parallel.gop import exchange_references
from coolchic_tpu_torch.train.params import tree_flatten_with_path, tree_leaves, tree_map
from coolchic_tpu_torch.train.presets import PresetDebug, TrainerPhase
from coolchic_tpu_torch.train.train import EncoderMonitor, SlotNoise, TorchNoise
from coolchic_tpu_torch.utils.parsecli import coolchic_config_from_args, intra_operating_points
from tests.test_torch_encode_batch import _cfgs, _crop, _psnr

torch.set_num_threads(2)
REPO = __import__("pathlib").Path(__file__).resolve().parent.parent
IMG = str(REPO / "tests/data/192x128_kodim15.png")
SIZE = (16, 24)
G = 4
PHASE = dict(lmbda=1e-3, max_itr=6, freq_valid=3, lr=1e-2, patience=3, schedule_lr=True,
             quantizer_noise_type="gaussian", quantizer_type="softround",
             softround_temperature=(0.3, 0.1), noise_parameter=(0.25, 0.1),
             precondition_frequency_model=2)


def _fcfg():
    return FrameConfig(coolchic_cfg={"residue": coolchic_config_from_args(
        intra_operating_points()["lop"], SIZE)})


def _targets():
    rng = np.random.default_rng(0)
    return torch.tensor(rng.random((G, 3, *SIZE), dtype=np.float32))


def _gens(seed):
    return [torch.Generator().manual_seed(seed + i) for i in range(G)]


def _cpu_mesh(data):
    return make_mesh(data, device="cpu")


def _close(a, b, tol=1e-6):
    xs, ys = tree_leaves(a), tree_leaves(b)
    assert len(xs) == len(ys)
    for x, y in zip(xs, ys):
        assert (x is None) == (y is None)
        if x is not None:
            assert float((x.double() - y.double()).abs().max()) <= tol


def test_phase_key_and_batched_init_match_jax():
    kw = dict(lmbda=2e-3, max_itr=8, freq_valid=4)
    assert phase_key(TrainerPhase(**kw)) == j_phase_key(JPhase(**kw))
    fcfg = _fcfg()
    jf = JFrameConfig(coolchic_cfg={"residue": j_cfg_from_args(
        INTRA_OPERATING_POINTS["lop"], SIZE)})
    jp, jo = j_batched_init(jf, JPhase(**kw), G, seed=0)
    params, opt = batched_init(fcfg, TrainerPhase(**kw), G, seed=0, device="cpu")
    j_paths = [(jax.tree_util.keystr(p), np.shape(x))
               for p, x in jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert [(p, tuple(x.shape)) for p, x in tree_flatten_with_path(params)] == j_paths
    # JAX's state tree, leaf by leaf, carried into the port's layout
    treedef = jax.tree_util.tree_structure(jp)
    for mine, theirs in zip(opt, treedef.flatten_up_to(jo)):
        assert (mine is None) == (theirs is None)
        if mine is None:
            continue
        carried = soap_state_from_jax(jax.tree_util.tree_map(np.asarray, theirs), "cpu")
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(mine[k].to(carried[k].dtype), carried[k])
        for k in ("GG", "Q"):
            for a, b in zip(mine[k], carried[k]):
                assert (a is None) == (b is None)
                if a is not None:
                    assert torch.equal(a, b)
    # each slot its own draws
    lat = params["residue"]["synthesis"]["layers"][0]["weight"]
    assert not torch.equal(lat[0], lat[1])


def test_mesh_refusals():
    with pytest.raises(ValueError, match="do not split"):
        make_mesh(devices=["cpu"] * 3, space=2)
    fcfg = _fcfg()
    phase = TrainerPhase(**PHASE)
    params, _ = batched_init(fcfg, phase, G, device="cpu")
    with pytest.raises(ValueError, match="noise stream per slot"):
        _batched_phase(params, _targets(), fcfg, phase, EncoderMonitor(), False,
                       noise_source=TorchNoise(torch.Generator()), mesh=_cpu_mesh(2))
    three, _ = batched_init(fcfg, phase, 3, device="cpu")
    with pytest.raises(ValueError, match="does not split over 2"):
        _batched_phase(three, _targets()[:3], fcfg, phase, EncoderMonitor(), False,
                       noise_source=SlotNoise(_gens(0)[:3]), mesh=_cpu_mesh(2))


def _warmed(fcfg, phase):
    """Params and SOAP states after a 12-step window without a mesh: from a
    fresh state Adam's first steps are lr * sign(g), so a gradient at
    rounding level flips by 2 lr whatever computes it
    (tests/test_torch_train_step.py); a carried state is well conditioned."""
    params, opt = batched_init(fcfg, phase, G, seed=1, device="cpu")
    return make_batched_window(fcfg, phase_key(phase), 12, _cpu_mesh(1))(
        params, opt, _gens(3), 1e-2, 0.3, 0.2, _targets())[:2]


@pytest.mark.parametrize("data", [2, 4])
def test_batched_window_and_phase_data_mesh(data):
    fcfg = _fcfg()
    phase = TrainerPhase(**PHASE)
    params, opt = _warmed(fcfg, phase)
    targets = _targets()
    out = {}
    for name, mesh in (("none", _cpu_mesh(1)), ("mesh", _cpu_mesh(data))):
        window = make_batched_window(fcfg, phase_key(phase), 3, mesh)
        out[name] = window(params, opt, _gens(7), 1e-2, 0.3, 0.2, targets)
    _close(out["mesh"][0], out["none"][0])
    for a, b in zip(out["mesh"][1], out["none"][1]):
        if a is not None:
            assert torch.equal(a["step"], b["step"])
            _close([a["exp_avg"], a["exp_avg_sq"]], [b["exp_avg"], b["exp_avg_sq"]])

    # _batched_phase starts its optimizer afresh (SOAP seeded from one
    # gradient, whose rank-one covariance leaves the eigenbasis of its null
    # space arbitrary), so against the whole batch the split's rounding
    # grows to the fresh-phase scale. Each data slice's chunk is held
    # instead against its own slots run without a mesh, which compute at
    # the chunk's batch size: every coordinate and best loss within 1e-6.
    lmbda_b = [1e-3, 4e-3, 2e-3, 8e-3]
    got = _batched_phase(params, targets, fcfg, phase, EncoderMonitor(), False,
                         noise_source=SlotNoise(_gens(11)), lmbda_b=lmbda_b,
                         mesh=_cpu_mesh(data))
    k = G // data
    for a in range(0, G, k):
        part = lambda tree, a=a: tree_map(lambda x: x[a:a + k], tree)   # noqa: E731
        alone = _batched_phase(part(params), targets[a:a + k], fcfg, phase, EncoderMonitor(),
                               False, noise_source=SlotNoise(_gens(11)[a:a + k]),
                               lmbda_b=lmbda_b[a:a + k])
        _close(part(got[0]), alone[0])
        _close([got[1][a:a + k]], [alone[1]])


def test_encode_images_batched_data_mesh(tmp_path):
    """Four images over a 2-slice mesh (two slots a slice, as the card's
    run splits its four): every file decodes in the port's decoder within
    0.3 dB of the encoder's PSNR, and the first slice's two files are byte
    for byte those of the same two images encoded without a mesh (slot i
    seeds from (seed, i) and the slice computes at their batch size). The
    RD of a 4-image call without a mesh is not compared: a fresh
    trajectory of tens of steps turns the batch size's rounding into the
    RD noise of separate runs (up to a dB on a 16x32 crop at this budget),
    as any one-ulp change would."""
    base = load_frame_data_from_file(IMG)
    frames = [_crop(base, y, x, 16, 32) for y, x in ((0, 0), (40, 72), (80, 16), (96, 128))]
    preset = PresetDebug(lmbda=1e-3, start_lr=1e-2, itr_main_training=1)
    paths = [str(tmp_path / f"{i}.cool") for i in range(4)]
    res = encode_images_batched(frames, _cfgs(frames[0]), preset, paths, verbose=False,
                                rdoq=False, device="cpu", mesh=_cpu_mesh(2))
    for path, frame, r in zip(paths, frames, res):
        dec = p_decode_video(path, device="cpu")["0"]
        assert abs(_psnr(dec, frame) - r["psnr_db"]) < 0.3, (path, r)
    alone = [str(tmp_path / f"alone{i}.cool") for i in range(2)]
    res2 = encode_images_batched(frames[:2], _cfgs(frames[0]), preset, alone, verbose=False,
                                 rdoq=False, device="cpu")
    for i in range(2):
        assert open(alone[i], "rb").read() == open(paths[i], "rb").read(), i
        assert res2[i]["psnr_db"] == res[i]["psnr_db"]


def test_exchange_references_one_process():
    mesh = make_mesh(devices=["cpu"] * 3)
    decoded = {i: torch.full((3, 4, 6), i / 8.0) for i in range(5)}
    got = exchange_references(decoded, [0, 4], mesh)
    assert set(got) == {0, 4}
    for i, placed in got.items():
        assert list(placed) == list(mesh.distinct)
        for x in placed.values():
            assert torch.equal(x, decoded[i])
