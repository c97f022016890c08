"""The run's guards: no JAX module in the process that prints a result, no
result without a card, and a reference that imports nothing of the
program."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.run import foreign_modules, run
from tiny import tiny_manifest

REFERENCE = Path(__file__).resolve().parents[1] / "reference"


@pytest.mark.parametrize("name,foreign", [
    ("adaptersis_tpu_torch", False), ("adaptersis_tpu_torch.models.vit", False),
    ("torch", False), ("jaxtyping", False), ("flaxen", False),
    ("adaptersis_tpu", True), ("adaptersis_tpu.models", True), ("jax", True),
    ("jax.numpy", True), ("jaxlib.xla_client", True), ("flax", True), ("flax.linen", True),
    ("optax", True), ("orbax.checkpoint", True)])
def test_foreign_modules_compare_whole_top_level_names(name, foreign):
    assert foreign_modules([name]) == ([name] if foreign else [])


def test_no_card_no_result(tmp_path, capsys, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = tiny_manifest(tmp_path)
    with pytest.raises(SystemExit) as e:
        run(["--workload", "train.paper_fp32", "--seed", "1", "--seconds", "1"], manifest=m)
    assert e.value.code != 0
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("path", sorted(REFERENCE.glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tree = ast.parse(path.read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.level == 0]
    assert all(n.split(".")[0] in ("torch", "numpy", "math", "statistics", "typing",
                                   "contextlib", "__future__") for n in names), names


def test_reference_loads_no_program_module():
    code = ("import sys, benchmark.reference.steps, benchmark.weights, benchmark.inputs; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('adaptersis_tpu_torch', 'adaptersis_tpu', 'jax', 'flax')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REFERENCE.parents[1], check=True)
    assert out.stdout.strip() == "[]"
