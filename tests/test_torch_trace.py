"""The port's spans and counters (coolchic_tpu_torch/utils/trace.py) on the
CPU: off they record nothing and change nothing; on, the decode and the
training step record the spans the benchmark reads, nested as the code
nests, one call id per decode call or step; under torch.profiler each span
is a `coolchic.*` range of the profiler's own trace, around the operators
it issued.

The decode runs on two 128x192 files of the repo transcoded to the `tpu`
profile with 128 streams forced down to 384-pixel grids (as
tests/test_torch_device_decode.py makes them), so every stage of the
device batch runs (host levels, small grids, kernel levels, IFCE, the
float tail)."""

import glob
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from coolchic_tpu_torch.bitstream import codec as pcodec
from coolchic_tpu_torch.bitstream import headers as ph
from coolchic_tpu_torch.bitstream.decode import decode_images
from coolchic_tpu_torch.bitstream.device_decode import decode_images_device
from coolchic_tpu_torch.bitstream.nncodec import decode_network
from coolchic_tpu_torch.models.frame import FrameConfig
from coolchic_tpu_torch.parallel.batch import batched_init, window_chunks
from coolchic_tpu_torch.train.params import tree_leaves
from coolchic_tpu_torch.train import train as train_mod
from coolchic_tpu_torch.train.presets import TrainerPhase
from coolchic_tpu_torch.train.train import EncoderMonitor, PhaseFns, TorchNoise
from coolchic_tpu_torch.utils import trace
from coolchic_tpu_torch.utils.parsecli import coolchic_config_from_args, intra_operating_points

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
FILES = sorted(glob.glob(str(REPO / "results/round4/h2h_kodim15_v3/*.cool")))[:2]

# span -> the span it opens under, in a decode_images call
DECODE_PARENT = {
    "decode.call": None,
    "decode.read": "decode.call",
    "decode.prepare": "decode.call",
    "decode.prepare.nn": "decode.prepare",
    "decode.prepare.blocks": "decode.prepare",
    "decode.prepare.certificate": "decode.prepare",
    "decode.prepare.host_levels": "decode.prepare",
    "decode.prepare.upload": "decode.prepare",
    "decode.prepare.modules": "decode.prepare",
    "decode.device": "decode.call",
    "decode.small_grids": "decode.device",
    "decode.ifce": "decode.device",
    "decode.kernel": "decode.device",
    "decode.float_tail": "decode.device",
    "decode.copy_out": "decode.call",
    "decode.finish": "decode.call",
}
STEP_PARENT = {
    "train.step": None,
    "train.grads": "train.step",
    "train.forward": "train.grads",
    "train.backward": "train.grads",
    "train.clip": "train.soap",
    "train.soap": "train.step",
    "train.soap.refresh": "train.soap",
}


def _transcode(path: str, out: Path) -> tuple:
    """A `tpu`-profile copy of a `ref`-profile file; returns its payload."""
    vh, rest = ph.VideoHeader.read(Path(path).read_bytes())
    fh, rest = ph.FrameHeader.read(rest)
    ch, rest = ph.CoolChicHeader.read(rest)
    bnn = rest[:ch.nn_n_bytes]
    blat = rest[ch.nn_n_bytes:ch.nn_n_bytes + ch.n_bytes_latent]
    _, grids = pcodec.decode_coolchic(ch, bnn, blat, profile="ref", device="cpu")
    nn = decode_network(bnn, ch.to_config(), ch.nn_q_step_shift, ch.nn_expgol_cnt,
                        ch.nn_n_bit_pad)
    pay = pcodec.encode_coolchic_latents(ch, nn, [np.asarray(g, np.int64) for g in grids],
                                         profile="tpu")
    out.write_bytes(ph.TPU_PROFILE_MAGIC + ph.VideoHeader().to_bytes() + fh.to_bytes()
                    + ch.to_bytes() + bnn + pay)
    return ch, bnn, pay


@pytest.fixture(scope="module")
def tpu_files(tmp_path_factory):
    orig = pcodec.grid_n_streams
    pcodec.grid_n_streams = lambda h, w: 128 if h * w >= 384 else orig(h, w)
    tmp = tmp_path_factory.mktemp("torch_trace")
    try:
        return [{"file": str(tmp / f"im{i}.cool"), "item": _transcode(p, tmp / f"im{i}.cool")}
                for i, p in enumerate(FILES)]
    finally:
        pcodec.grid_n_streams = orig


def _check_tree(rec, parents: dict):
    """Every span's parent is the one `parents` names, the span lies inside
    it and shares its call id; a root's call id is its own."""
    spans = rec.spans
    roots = [s[4] for s in spans if parents[s[0]] is None]
    assert len(roots) == len(set(roots)) and all(c > 0 for c in roots)
    for name, t0, t1, parent, call in spans:
        assert t0 <= t1
        if parents[name] is None:
            assert parent == -1
            continue
        pname, p0, p1, _, pcall = spans[parent]
        assert pname == parents[name]
        assert p0 <= t0 and t1 <= p1 and call == pcall
    for s in rec.summary().values():
        assert 0 <= s["self_ns"] <= s["total_ns"]


def test_off_records_nothing_and_changes_nothing(tpu_files):
    files = [t["file"] for t in tpu_files]
    assert trace.span("decode.call", root=True) is trace.OFF
    assert trace.span("train.soap") is trace.OFF and not trace.on()
    trace.count("decode.d2h_bytes", 5)
    # off, a span opens no profiler range either
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("decode.call"):
            torch.ones(2).sum()
    assert [e.name for e in prof.events() if e.name.startswith(trace.PROFILER_PREFIX)] == []
    off = decode_images(files, device="cpu")
    with trace.collect() as rec:
        assert trace.on()
        on = decode_images(files, device="cpu")
    assert rec.spans and trace.span("decode.call") is trace.OFF and not trace.on()
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a.data, b.data)


def test_decode_spans_nest_one_call_id_per_call(tpu_files):
    files = [t["file"] for t in tpu_files]
    with trace.collect() as rec:
        decode_images(files, device="cpu")
        decode_images(files[:1], device="cpu")
    assert {s[0] for s in rec.spans} == set(DECODE_PARENT)
    _check_tree(rec, DECODE_PARENT)
    summary = rec.summary()
    assert summary["decode.call"]["count"] == 2
    assert sorted({s[4] for s in rec.spans}) == [1, 2]
    # per image: the NN decode, the stream split, the finish
    assert summary["decode.prepare.nn"]["count"] == 3
    assert summary["decode.prepare.blocks"]["count"] == 3
    assert summary["decode.finish"]["count"] == 3
    assert summary["decode.prepare"]["count"] == summary["decode.device"]["count"] == 2
    # levels 4 and 5 (8x12, one stream) of each image in one small-grid
    # launch a call; levels 6-9 (widths 6 and 3) on the host route
    assert summary["decode.small_grids"]["count"] == 2
    assert rec.counters["decode.small_grids.device"] == 2 * 3
    assert rec.counters["decode.small_grids.host"] == 4 * 3


def test_d2h_bytes_are_the_bytes_brought_back(tpu_files):
    with trace.collect() as rec:
        out = decode_images_device([t["item"] for t in tpu_files], device="cpu")
    # the frames as they came off the device (f32), the grids as int32
    want = sum(raw.nbytes + sum(g.size * 4 for g in grids) for raw, grids in out)
    assert rec.counters == {"decode.d2h_bytes": want}
    assert rec.summary()["decode.copy_out"]["count"] == 1


def test_training_steps_record_one_refresh_per_period():
    cfg = coolchic_config_from_args(intra_operating_points()["lop"], (32, 48))
    fcfg = FrameConfig(coolchic_cfg={"residue": cfg}, frame_type="I", frame_data_type="rgb",
                       bitdepth=8)
    phase = TrainerPhase(lmbda=1e-3, precondition_frequency_model=2)
    params, opt = batched_init(fcfg, phase, 1, device="cpu")
    fns = PhaseFns(fcfg, params, "gaussian", "softround", {"mse": 1.0}, (0.95, 0.95),
                   (0.9, 0.999), 2)
    gen = torch.Generator()
    gen.manual_seed(3)
    noise, level = TorchNoise(gen), torch.full((1,), 0.2)
    target = torch.rand((1, 3, 32, 48), generator=gen)
    lmbda = torch.full((1,), 1e-3)
    with trace.collect() as rec:
        window_chunks([fns], [(tree_leaves(params), opt)],
                      [lambda: noise("step", fcfg, 1, "gaussian", level, True)], 2, 0.3,
                      [torch.tensor(1e-2)], [target], [lmbda], [None])
    summary = rec.summary()
    assert summary["train.step"]["count"] == 2
    assert summary["train.soap.refresh"]["count"] == 1
    assert {k: v["count"] for k, v in summary.items()} == {
        "train.step": 2, "train.grads": 2, "train.forward": 2, "train.backward": 2,
        "train.clip": 2, "train.soap": 2, "train.soap.refresh": 1}
    _check_tree(rec, STEP_PARENT)
    # the refresh is the second step's
    refresh = next(s for s in rec.spans if s[0] == "train.soap.refresh")
    assert refresh[4] == 2


def test_spans_lie_on_the_profilers_clock(tmp_path):
    # the file's own stream counts: every grid decodes on the host (the
    # plain wavefront decode would fill the trace with its small operators)
    _transcode(FILES[0], tmp_path / "im.cool")
    with profile(activities=[ProfilerActivity.CPU]) as prof, trace.collect() as rec:
        decode_images([str(tmp_path / "im.cool")], device="cpu")
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = [e for e in json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
              if e.get("ph") == "X"]
    ranges = [e for e in events if e.get("cat") == "user_annotation"
              and e["name"].startswith(trace.PROFILER_PREFIX)]
    assert sorted(e["name"] for e in ranges) == sorted(
        trace.PROFILER_PREFIX + s[0] for s in rec.spans)
    tails = [(e["ts"], e["ts"] + e["dur"]) for e in ranges
             if e["name"] == "coolchic.decode.float_tail"]
    convs = [e for e in events if e.get("cat") == "cpu_op" and e["name"] == "aten::conv2d"]
    assert len(tails) == 1 and convs
    assert all(tails[0][0] <= e["ts"] and e["ts"] + e["dur"] <= tails[0][1] for e in convs)


def test_encoder_stages_time_on_the_monotonic_clock(monkeypatch):
    # perf_counter ticks 0.5 s and 0.25 s across the two stages; the wall
    # clock stands still, so only a stage timed by perf_counter reads 0.75
    ticks = iter([10.0, 10.5, 20.0, 20.25])
    monkeypatch.setattr(train_mod, "time",
                        SimpleNamespace(perf_counter=lambda: next(ticks), time=lambda: 0.0))
    monitor = EncoderMonitor()
    with trace.collect() as rec:
        with monitor.timed("rdoq"):
            pass
        with monitor.timed("rdoq"):
            pass
    assert monitor.phase_time_sec == {"rdoq": 0.75}
    assert rec.spans == [] and rec.counters == {}
