"""The reduction of a trace by the program's spans (portbench/spans.py) on
synthetic chrome traces, and its two passes rehearsed on the CPU at a
small size: kernels and copies go to the innermost program span open at
their launch, from whatever thread; a trace with the benchmark's spans
alone names its idle gaps exactly as yardstick.reduce_trace does."""

import glob
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import harness, spans, yardstick

TRAIN_SMALL = {"crop": [64, 96], "check_steps": 3, "trace_steps": 2, "batch": 1}
REPO = Path(__file__).resolve().parents[2]
FILES = sorted(glob.glob(str(REPO / "results/round4/h2h_kodim15_v3/*.cool")))[:2]


def transcode(path: str, out: Path) -> None:
    """A `tpu`-profile copy of one of the repo's `ref`-profile files."""
    from coolchic_tpu_torch.bitstream import codec as pcodec
    from coolchic_tpu_torch.bitstream import headers as ph
    from coolchic_tpu_torch.bitstream.nncodec import decode_network

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


def ev(name, cat, ts, dur, tid=1, **args):
    e = {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid, "ts": ts, "dur": dur}
    if args:
        e["args"] = args
    return e


def kernel(ts, dur, corr, name="k"):
    return ev(name, "kernel", ts, dur, tid=7, correlation=corr)


def launch(ts, corr, tid=1, name="cudaLaunchKernel"):
    return ev(name, "cuda_runtime", ts, 2, tid=tid, correlation=corr)


def test_device_work_goes_to_the_innermost_program_span_at_launch():
    events = [
        ev("coolchic.decode.call", "user_annotation", 0, 100),
        ev("coolchic.decode.device", "user_annotation", 10, 50),
        ev("coolchic.decode.float_tail", "user_annotation", 40, 15),
        ev("coolchic.decode.copy_out", "user_annotation", 60, 30),
        ev("portbench.decode.device_run", "user_annotation", 41, 5),   # not the program's
        launch(12, 1),                       # in decode.device; runs long after
        kernel(500, 40, 1),
        launch(45, 2, tid=9),                # another thread, inside float_tail
        kernel(520, 10, 2),
        launch(65, 3, name="cudaMemcpyAsync"),
        ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 540, 20, tid=7, correlation=3),
        launch(95, 4),                       # in the call alone
        kernel(600, 5, 4),
        kernel(700, 8, 99),                  # no runtime record
        ev("aten::conv2d", "cpu_op", 46, 3),
    ]
    got = spans.by_program_span(events)
    assert got["launches"] == {"decode.device": 1, "decode.float_tail": 1, "decode.call": 1,
                               "no program span": 1}
    assert got["kernel_s"] == pytest.approx({"decode.device": 40e-6, "decode.float_tail": 10e-6,
                                             "decode.call": 5e-6, "no program span": 8e-6})
    assert got["memcpy_s"] == {"decode.copy_out": {"Memcpy DtoH (Device -> Pageable)":
                                                   pytest.approx(20e-6)}}


def _bench_trace():
    """A window with the benchmark's spans (nested), device ops that cross
    the window's edges, and a gap outside every span."""
    return [
        ev("portbench.window", "user_annotation", 100, 1000),
        ev("portbench.decode.call", "user_annotation", 120, 600),
        ev("portbench.decode.prepare_batch", "user_annotation", 130, 300),
        ev("portbench.decode.device_run", "user_annotation", 450, 200),
        ev("portbench.decode.finish_frame", "user_annotation", 660, 50),
        kernel(90, 30, 1),
        kernel(440, 100, 2),
        kernel(545, 5, 3),
        ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 600, 50, tid=7, correlation=4),
        kernel(655, 3, 5),
        kernel(670, 5, 6),
        kernel(900, 100, 7),
        kernel(1080, 50, 8),
    ]


def test_benchmark_spans_alone_reduce_as_before(tmp_path):
    events = _bench_trace()
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    want = yardstick.reduce_trace(path)["breakdown"]["idle_gaps"]
    assert spans.idle_gaps(events) == want
    assert {name for name, _ in want} == {"portbench.decode.prepare_batch",
                                         "portbench.decode.device_run",
                                         "portbench.decode.finish_frame", "portbench.decode.call",
                                         "no benchmark span"}


def test_program_spans_name_the_gaps_inside_the_benchmarks():
    events = _bench_trace() + [
        ev("coolchic.decode.call", "user_annotation", 125, 590),
        ev("coolchic.decode.prepare", "user_annotation", 132, 296),
        ev("coolchic.decode.prepare.nn", "user_annotation", 140, 100),
    ]
    gaps = dict(spans.idle_gaps(events))
    # the gap 120..440: its middle lies in the program's decode.prepare,
    # inside the benchmark's prepare_batch, and after decode.prepare.nn
    assert gaps["coolchic.decode.prepare"] == pytest.approx(320e-6)
    assert "portbench.decode.prepare_batch" not in gaps
    assert gaps["portbench.decode.finish_frame"] == pytest.approx(12e-6)
    assert gaps["no benchmark span"] == pytest.approx(305e-6)


def test_readings_need_a_card_and_a_cell():
    ctx = {"kind": "decode", "busy_s": 1.0, "clock_s": 1.0, "breakdown": {}}
    assert spans.reading(ctx, "train", lambda m: 1.0) is None
    if not torch.cuda.is_available():
        assert spans.reading(ctx, "decode", lambda m: 1.0) is None


def test_d2h_rate_times_the_card_alone_passs_copies(monkeypatch):
    # 2 calls of the card-alone pass copy for 8 ms in all; the program pass
    # counts 12e6 bytes a call: 12e6 B / 4 ms = 3 GB/s. The program pass's
    # own copy time plays no part.
    reader = harness.load_reader("decode.d2h_gb_per_s")
    monkeypatch.setattr(reader, "passes", lambda t: {
        "host": {"counters": {"decode.d2h_bytes": 12e6}},
        "device": {"memcpy_ms": {"decode.copy_out": {"Memcpy DtoH (Device -> Pageable)": 1.0}}}})
    ctx = {"kind": "decode", "calls": 2, "busy_s": 1.0, "clock_s": 1.0,
           "breakdown": {"device_ops": [["wavefront_decode_kernel", 0.02],
                                        ["Memcpy DtoH (Device -> Pageable)", 0.008],
                                        ["Memcpy HtoD (Pageable -> Device)", 0.001]]}}
    assert reader.read(ctx) == pytest.approx(3.0)
    ctx["breakdown"]["device_ops"] = ctx["breakdown"]["device_ops"][:1]
    assert reader.read(ctx) is None             # no copy among the card's largest ops


def test_decode_pass_on_the_cpu(tmp_path, capsys):
    paths = []
    for i, f in enumerate(FILES):
        transcode(f, tmp_path / f"im{i}.cool")
        paths.append(str(tmp_path / f"im{i}.cool"))
    out = spans.decode_pass(paths, {"batch": 2, "span_calls": 1, "trace_calls": 2}, 5, "cpu",
                            clock_s=1.0)
    host, device = out["host"], out["device"]
    assert host["roots"] == 4 and device["roots"] == 1      # two blocks on, of 2 calls
    for name in ("decode.prepare", "decode.prepare.nn", "decode.prepare.host_levels",
                 "decode.finish", "decode.float_tail", "decode.copy_out"):
        assert 0 < host["self_ms"][name] <= host["host_ms"][name]
    assert host["counters"]["decode.d2h_bytes"] == device["counters"]["decode.d2h_bytes"] > 0
    assert device["kernel_ms"] == {} and device["launches"] == {}   # no card
    assert device["idle_gaps"][0][0].startswith("coolchic.decode.")
    assert "portbench: program tracing on:" in capsys.readouterr().err


def test_train_pass_on_the_cpu(capsys):
    bench = harness.benchmark()
    cell = harness.cell_entry(bench, "lop.encode.b1")
    spec = dict(json.loads((harness.PB / "workloads" / "lop.encode.b1.json").read_text()),
                **TRAIN_SMALL)
    run = harness.Run(spec=spec, config=yardstick.load_config(cell["config"]), seed=2**31 + 3,
                      seconds=0.0, trace=True, device="cpu")
    out = spans.train_pass(run, clock_s=1.0)
    host = out["host"]
    assert host["roots"] == 4 and out["device"]["roots"] == 2
    assert set(host["host_ms"]) == {"train.step", "train.grads", "train.forward",
                                    "train.backward", "train.clip", "train.soap"}
    assert host["host_ms"]["train.grads"] > 0 and host["host_ms"]["train.soap"] > 0
    assert "portbench: program tracing on:" in capsys.readouterr().err
