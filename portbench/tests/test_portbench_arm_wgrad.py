"""The readers of the ARM weight gradient's per-layer metrics on synthetic
traces: the device ms a step of the kernels named `arm_wgrad` in the
card-alone pass, and the bytes the program counts a step (portbench/
spans.py's program pass) at the HBM rate over that time. A program without
the kernel or the counter, as before the kernel, gives no reading."""

import pytest

from portbench import harness, yardstick

# 10 steps of the card-alone pass: the kernel's two passes 12 ms in all,
# beside cuBLAS and cuDNN kernels that are not read
CTX = {"kind": "train", "steps": 10, "busy_s": 1.0, "clock_s": 1.0, "breakdown": {},
       "kernel_s": {"(anonymous namespace)::arm_wgrad_partial_kernel(float const*, int)": 0.010,
                    "(anonymous namespace)::arm_wgrad_reduce_kernel(float const*, int)": 0.002,
                    "sm80_xmma_gemm_f32f32_f32f32_f32_nt_n_tilesize32x32x8": 0.5,
                    "void cudnn::cnn::wgrad2d_grouped_direct_kernel": 0.1}}


def test_arm_wgrad_ms_reads_the_kernels_by_name():
    assert harness.load_reader("train.arm_wgrad_ms").read(CTX) == pytest.approx(1.2)


@pytest.mark.parametrize("counters, pct", [
    # 2.01e9 bytes a step at 3.35e12 B/s is 0.6 ms, half of the 1.2 ms a step
    ({"train.arm_wgrad.bytes": 2.01e9, "train.arm_wgrad.launches": 7.0}, 50.0),
    ({"train.arm_wgrad.launches": 7.0}, None),                # no byte counter
    ({}, None),
])
def test_roofline_joins_the_two_passes(monkeypatch, counters, pct):
    reader = harness.load_reader("train.arm_wgrad.roofline_pct")
    monkeypatch.setattr(reader, "passes", lambda t: {"host": {"counters": counters}})
    got = reader.read(CTX)
    assert got == (pytest.approx(pct) if pct is not None else None)
    assert yardstick.HBM_BYTES_PER_S == 3.35e12


def test_no_kernel_no_reading(monkeypatch):
    parent = dict(CTX, kernel_s={k: v for k, v in CTX["kernel_s"].items()
                                 if "arm_wgrad" not in k})
    roof = harness.load_reader("train.arm_wgrad.roofline_pct")
    monkeypatch.setattr(roof, "passes", lambda t: {"host": {"counters": {}}})
    assert harness.load_reader("train.arm_wgrad_ms").read(parent) is None
    assert roof.read(parent) is None
    for reader in (harness.load_reader("train.arm_wgrad_ms"), roof):
        assert reader.read(dict(CTX, kind="decode")) is None
