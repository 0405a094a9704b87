"""The controls, on the card (TF32 exists only there): the plain reference
computed with TF32, put in the program's place, comes out not correct
under each cell's limits. tools/control.py reads the same at the cells'
own sizes."""

import json
from pathlib import Path

import pytest
import torch

from portbench import harness, yardstick
from portbench.tools import control

PB = Path(__file__).resolve().parents[1]


def _run(cell: str, **over) -> harness.Run:
    spec = dict(json.loads((PB / "workloads" / f"{cell}.json").read_text()), **over)
    entry = harness.cell_entry(harness.benchmark(), cell)
    return harness.Run(spec=spec, config=yardstick.load_config(entry["config"]), seed=2**31 + 3,
                       seconds=1.0, trace=False, device="cuda:0")


def _fails(readings: dict, spec: dict) -> bool:
    return any(v > spec["limits"][k] for k, v in readings.items())


@pytest.mark.cuda
def test_train_control_fails():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    run = _run("hop.encode.b8", batch=2, crop=[128, 192])
    assert _fails(control.train_control(run), run.spec)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["hop.decode.b8", "lop.decode.b1"])
def test_decode_control_fails(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    run = _run(cell, batch=1)
    assert _fails(control.decode_control(run), run.spec)
