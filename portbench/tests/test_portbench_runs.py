"""Whole runs of the harness on the CPU at a small size, the look for a
card skipped: a sound run comes out correct, and a run with the timed path
broken underneath comes out not correct. The module check and the refusal
to run without a card."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import faults, harness, inputs

ROOT = Path(__file__).resolve().parents[2]
TRAIN_SMALL = {"crop": [64, 96], "check_steps": 3, "trace_steps": 2}


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def test_forbidden_modules_compare_whole_names():
    assert harness.forbidden_modules(["coolchic_tpu.models", "jax.numpy", "os"]) == [
        "coolchic_tpu", "jax"]
    assert harness.forbidden_modules(["coolchic_tpu_torch.train", "jaxtyping", "flax"]) == [
        "flax"]


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "hop.decode.b8",
                          "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.parametrize("fault", [None, "state_unchanged", "half_batch"])
def test_train_run(fault):
    spec = dict(TRAIN_SMALL, batch=2)
    if fault is None:
        res = harness.run_cell("hop.encode.b8", 2**31 + 7, 0.5, False, "cpu", spec)
        assert res["correct"], res["checks"]
        assert res["metrics"]["train_img_steps_per_s"]["value"] > 0
        assert list(res)[-1] == "checks"
    else:
        with getattr(faults, fault)():
            res = harness.run_cell("hop.encode.b8", 2**31 + 7, 0.5, False, "cpu", spec)
        assert not res["correct"], res["checks"]
    json.dumps(res, allow_nan=False)


def test_split_quantity_reports_the_kinds_reading():
    res = harness.run_cell("lop.encode.b1", 2**31 + 8, 0.5, False, "cpu", TRAIN_SMALL)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"setup_s", "train_img_steps_per_s.n1"}


def test_train_window_is_the_programs_window_call(monkeypatch):
    from coolchic_tpu_torch.parallel import batch

    calls = []
    orig = batch.window_chunks

    def counted(fns, chunks, draws, n_steps, *a):
        calls.append(n_steps)
        return orig(fns, chunks, draws, n_steps, *a)

    monkeypatch.setattr(batch, "window_chunks", counted)
    res = harness.run_cell("hop.encode.b8", 2**31 + 9, 0.5, False, "cpu",
                           dict(TRAIN_SMALL, batch=1))
    # set-up: the check's 3 steps rounded up to a refresh period of 10; the
    # window: the rest of the first window of 100, then whole windows
    assert calls[0] == 10 and calls[1] == 90 and all(n == 100 for n in calls[2:])
    assert res["attempted"] == sum(calls[1:])


def test_train_traced_run():
    res = harness.run_cell("hop.encode.b8", 11, 0.5, True, "cpu", dict(TRAIN_SMALL, batch=1))
    assert res["correct"] and res["device"]["window_s"] > 0 and "breakdown" in res
    assert res["metrics"] == {}          # no card: no device time to read


@pytest.mark.parametrize("fault", [None, "altered_symbol"])
def test_decode_run(monkeypatch, fault):
    pool = inputs.pool
    monkeypatch.setattr(inputs, "pool", lambda name: pool(name)[:1])   # one file, one call
    spec = {"batch": 1, "check_calls": 1}
    if fault is None:
        res = harness.run_cell("hop.decode.b8", 5, 0.1, False, "cpu", spec)
        assert res["correct"], res["checks"]
    else:
        with faults.altered_symbol():
            res = harness.run_cell("hop.decode.b8", 5, 0.1, False, "cpu", spec)
        assert not res["correct"], res["checks"]
