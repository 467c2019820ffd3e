"""`correct` against a broken timed path: the harness's run, driven on the
CPU (the look for a card skipped) at a cell's own configuration, with
the entry's outputs broken underneath, must come out not correct; the
same run unbroken must come out correct. And on the card, the control
(the fit's matrix products in TF32, the precision below the float32 the
configurations state) must come out not correct."""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from portbench import run
from portbench.faults import Broken

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SEED = 3000000017


def _run(cell, fault=None):
    torch.set_num_threads(4)
    spec = run.cell_spec(BENCH, cell)
    per_call = spec["traffic"]["pairs_per_call"]
    n = -(-spec["config"]["check"]["sample"] // per_call)
    wrap = None if fault is None else (lambda e: Broken(e, fault))
    return run.run_cell(spec, SEED, 0.0, False, device="cpu",
                        entry_wrap=wrap, calls=n)


CELLS = [w["name"] for w in BENCH["workloads"]]
_SOUND: dict = {}


def _sound(cell):
    if cell not in _SOUND:
        _SOUND[cell] = _run(cell)
    return _SOUND[cell]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    got = _sound(cell)
    assert got["correct"], got["check"]


@pytest.mark.parametrize("fault", ["state_unchanged", "labels_altered",
                                   "models_altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_answer_is_not_correct(cell, fault):
    got = _run(cell, fault)
    assert got["attempted"] == _sound(cell)["attempted"]
    assert not got["correct"], got["check"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("the control runs on the card: no CUDA device here")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(card, cell):
    """The control at the cell's size on three seeds: the harness's own
    run, with the fit's products in TF32, comes out not correct."""
    import subprocess
    import sys

    out = subprocess.run(
        [sys.executable, "-m", "portbench.calibrate", "--workload", cell,
         "--seeds", "3", "--first-seed", "7100", "--control"],
        capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    rows = [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith('{"seed"')]
    assert len(rows) == 3
    for row in rows:
        assert not row["correct"], row["compared"]
