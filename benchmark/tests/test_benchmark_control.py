"""Each cell's control, at a tiny size on the CPU: the reference put in
the program's place, in the precision below the configuration's (the
controls round their operands themselves, so TF32 reads on the CPU as on
the card), reads three times the program's own plain path or more on at
least one compared number; in an fp32 cell, whose plain path is exact, it
fails one of the cell's limits. (The bf16 limits, set at full size, do not
carry to this width: there the separation is what is held.)"""

import pytest
import torch

from benchmark.manifest import driver
from benchmark.reference.precision import PRECISIONS
from tiny import tiny_manifest

CELLS = ["train.paper_fp32", "serve.deployed_bf16", "train.deployed_bf16"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_a_limit(cell, tmp_path):
    m = tiny_manifest(tmp_path)
    w = m.cell(cell)
    cfg, mix, limits = m.config(w["config"]), m.mix(w["traffic"]), m.limits(cell)
    torch.manual_seed(0)
    drv = driver(mix["driver"]).Driver(cfg, mix, 2147483711, "cpu")
    drv.setup()
    if drv.kind == "serve":
        drv.window(0.5)
    drv.free()
    program, ref = drv.numbers()
    control, _ = drv.numbers(PRECISIONS[cfg["control"]], program_side=False, ref=ref)
    assert any(control[k] >= 3 * program[k] for k in limits), (program, control)
    if cfg["precision"] == "fp32":
        assert all(program[k] <= v for k, v in limits.items()), program
        assert any(control[k] > v for k, v in limits.items()), (control, limits)


@pytest.mark.parametrize("x,want", [
    (1 + 2 ** -12, 1.0), (1 + 2 ** -11, 1 + 2 ** -10), (1 + 3 * 2 ** -12, 1 + 2 ** -10),
    (-(1 + 2 ** -11), -(1 + 2 ** -10)), (1 + 2 ** -10, 1 + 2 ** -10), (3.0, 3.0)])
def test_tf32_control_rounds_to_ten_mantissa_bits_to_nearest(x, want):
    """The TF32 control keeps 10 mantissa bits, rounding to nearest with
    ties away from zero, and lets the gradient through unchanged."""
    t = torch.tensor([x], dtype=torch.float32, requires_grad=True)
    q = PRECISIONS["tf32"].operand(t)
    assert q.item() == want
    q.sum().backward()
    assert t.grad.item() == 1.0
