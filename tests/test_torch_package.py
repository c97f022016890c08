"""The port stands alone: no module of adaptersis_tpu_torch imports jax,
flax, optax or the JAX package (the GPU machine has none of them), and
importing every module compiles and loads nothing."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1] / "adaptersis_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "adaptersis_tpu")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")), ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_chip_smoke_imports_no_jax():
    smoke = PKG.parent / "chip_smoke.py"
    bad = [m for m in _imports(smoke) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"chip_smoke.py imports {bad}"


def test_import_builds_nothing():
    """Import every module with subprocesses and ctypes loading stubbed to
    fail (after torch, which loads its own libraries): importing the port
    must compile and load nothing."""
    code = """
import ctypes, importlib, pkgutil, subprocess, sys
import numpy, torch
def refuse(*a, **k):
    raise AssertionError("import compiled or loaded a kernel")
subprocess.run = refuse
ctypes.CDLL = refuse
import adaptersis_tpu_torch
from adaptersis_tpu_torch.ops import _build
for m in pkgutil.walk_packages(adaptersis_tpu_torch.__path__, "adaptersis_tpu_torch."):
    importlib.import_module(m.name)
assert _build.library.cache_info().currsize == 0
print("ok")
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), res.stderr[-2000:]
