"""Each cell once on the card, a short window: runs, prints a result and
is correct. Skips where there is no card (`card` fixture)."""

import pytest

from benchmark.manifest import Manifest
from benchmark.run import run

CELLS = [w["name"] for w in Manifest().data["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell, card):
    out = run(["--workload", cell, "--seed", "2147483901", "--seconds", "3"])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert out["device"]["memory_peak_bytes"] > 0
