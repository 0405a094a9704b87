"""BENCHMARK.json and the files it names: every configuration, cell and
per-layer metric is found by its name, and the file keeps the contract's
shape."""

import hashlib
import json
import math
import re
from pathlib import Path

import pytest

from portbench import harness, inputs, yardstick

ROOT = Path(__file__).resolve().parents[2]
PB = ROOT / "portbench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_run_seconds_fits_a_full_check():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_file(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and entry["file"].startswith("portbench/")
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert cfg["name"] == entry["name"] == Path(entry["file"]).stem
    assert entry["reduced"] == cfg["reduced"] == []
    assert yardstick.load_config(entry["name"]) == cfg
    yardstick.coolchic_config(cfg["operating_point"], tuple(cfg["image_size"]))


def test_config_files_hold_the_operating_points():
    from coolchic_tpu_torch.utils.parsecli import intra_operating_points

    points = intra_operating_points()
    for entry in BENCH["configs"]:
        assert yardstick.load_config(entry["name"])["operating_point"] == points[entry["name"]]


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda e: e["name"])
def test_cell_files(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and cell["chips"] == 1
    assert 1 <= len(cell["why"]) <= 200 and "\n" not in cell["why"]
    spec = json.loads((PB / "workloads" / f"{cell['traffic']}.json").read_text())
    assert spec["config"] == cell["config"]
    assert (PB / "kinds" / f"{spec['kind']}.py").exists()
    assert all(v > 0 for v in spec["limits"].values())
    e2e = [m["name"] for m in BENCH["end_to_end"] if harness.reports(m, cell["name"], BENCH)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(harness.reports(m, cell["name"], BENCH) for m in BENCH["per_layer"])


def test_metrics():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    cells = {c["name"] for c in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    assert next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")["bound"] <= 0.25
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                     "higher")
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_found_by_name(metric):
    reader = harness.load_reader(metric["name"])
    assert reader.read({"kind": "none"}) is None
    busy = {"kind": metric["name"].split(".")[0], "busy_s": 0.0, "window_s": 1.0,
            "wall_s": 1.0, "clock_s": 1.0, "kernel_s": {}, "launches": 0, "calls": 1, "steps": 1,
            "wavefronts_per_call": 1, "bound_s_per_call": 1.0, "pixels": 1, "img_steps": 1,
            "mac_per_px": 1.0}
    assert reader.read(busy) is None     # nothing ran on the card: nothing to read


def test_shares_are_not_capped():
    ctx = {"kind": "decode", "busy_s": 0.5, "window_s": 1.0, "wall_s": 1.0, "clock_s": 1.0, "calls": 1,
           "kernel_s": {"wavefront_decode_kernel(int*)": 1e-3}, "wavefronts_per_call": 10,
           "bound_s_per_call": 2e-3, "pixels": 1, "mac_per_px": 1.0, "launches": 1}
    assert harness.load_reader("decode.kernel.roofline_pct").read(ctx) == pytest.approx(200.0)


def test_data_manifest():
    manifest = json.loads((inputs.DATA / "manifest.json").read_text())
    on_disk = sorted(str(p.relative_to(inputs.DATA)) for p in inputs.DATA.rglob("*")
                     if p.is_file() and p.name != "manifest.json")
    assert sorted(manifest) == on_disk
    for name, digest in manifest.items():
        assert hashlib.sha256((inputs.DATA / name).read_bytes()).hexdigest() == digest
    inputs.check_manifest(list(manifest))


def test_ppm_reader():
    rgb = inputs.read_ppm(inputs.DATA / "kodim14.ppm")
    assert rgb.shape == (3, 512, 768) and rgb.dtype.name == "float32"
    assert 0.0 <= rgb.min() and rgb.max() <= 1.0 and math.isfinite(float(rgb.mean()))
