"""BENCHMARK.json against the contract's shape, and every cell and metric
resolving to its files under portbench/."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
PB = ROOT / "portbench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["portbench"]
    assert all(not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units():
    named = (BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
             + BENCH["per_layer"])
    for group in ("configs", "workloads"):
        names = [x["name"] for x in BENCH[group]]
        assert len(set(names)) == len(names)
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    for x in named:
        assert NAME.match(x["name"]), x["name"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for x in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    from portbench import run

    spec = run.cell_spec(BENCH, cell)
    assert spec["cell"]["chips"] == 1
    entry = PB / "entries" / f"{spec['traffic']['entry']}.py"
    assert entry.is_file()
    assert (PB / "reference" / f"{spec['config']['reference']}.py").is_file()
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec["per_layer"]
    for m in spec["end_to_end"]:
        assert (PB / "end_to_end" / f"{m['name']}.py").is_file()
    for m in spec["per_layer"]:
        assert (PB / "layer_metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in e2e


@pytest.mark.parametrize("cfg", [c["name"] for c in BENCH["configs"]])
def test_config_file(cfg):
    from multih_tpu_torch.config import MultiHConfig

    entry = next(c for c in BENCH["configs"] if c["name"] == cfg)
    assert entry["file"].startswith("portbench/configs/")
    data = json.loads((ROOT / entry["file"]).read_text())
    assert data["name"] == cfg and data["source"] == entry["source"]
    MultiHConfig(**data["multih"])
    assert data["check"]["limits"], "a configuration compares numbers"
    assert any(c["config"] == cfg for c in BENCH["workloads"])


def test_per_layer_metrics():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["name"].split(".")[0].split("_")[0],
                          set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] == 0.25


def test_paths_hold_only_the_benchmark():
    cmd = BENCH["command"]
    assert cmd[:3] == ["python3", "-m", "portbench.run"]
    for config in BENCH["configs"]:
        assert (ROOT / config["file"]).resolve().is_relative_to(PB)
