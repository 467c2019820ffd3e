"""What the benchmark loads: no JAX and no JAX package in the run, nothing
of the port in the reference, and no result without a card."""

from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PB = ROOT / "portbench"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_forbidden_names_are_compared_whole(monkeypatch):
    from portbench import run

    for name in ("multih_tpu_torch", "multih_tpu_torch.models.pipeline",
                 "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert not set(run.forbidden_modules()) & {"jaxtyping", "flaxen"}
    for name in ("multih_tpu.models", "jaxlib", "jax", "flax.linen"):
        monkeypatch.setitem(sys.modules, name, sys)
        assert name.split(".")[0] in run.forbidden_modules()
        monkeypatch.delitem(sys.modules, name)


def test_reference_imports_nothing_of_the_port():
    code = ("import sys\n"
            "import portbench.check, portbench.scenes, portbench.roofline\n"
            "import portbench.reference.plane, portbench.reference.motion\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'multih_tpu_torch', 'multih_tpu', 'jax', 'jaxlib', "
            "'flax', 'torch'}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=_env(), cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_reference_sources_import_only_numpy():
    for path in (PB / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] in ("numpy", "portbench",
                                           "__future__"), (path, n)
            if isinstance(node, ast.ImportFrom) and node.module:
                assert node.module.split(".")[:2] != ["portbench", "run"]


def test_harness_sources_never_import_jax():
    for path in PB.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib", "flax",
                                               "multih_tpu"), (path, n)


def test_no_card_no_result():
    # the card, where there is one, is hidden from the run
    env = dict(_env(), CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "h512.pairs_aot", "--seed", "3000000000", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, env=env,
        cwd=ROOT, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "device" in out.stderr


def test_benchmark_alone_no_result(tmp_path):
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(PB, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "h512.pairs_aot", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
