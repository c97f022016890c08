"""pytest settings of the benchmark's own tests (`benchmark/tests/`), which
run on the CPU: `python -m pytest benchmark/tests -q`. Tests that need the
card carry the `card` marker and skip without one; on the card they run as
`python -m pytest benchmark/tests -q -m card`."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    """Skip a test marked `card` where no CUDA card is present: decided
    here, inside a fixture, never while the module is imported."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this machine has none")
    return torch.device("cuda", 0)
