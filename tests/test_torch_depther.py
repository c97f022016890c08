"""The port's DepthEncoderDecoder (`models/depther.py`) with the DPT head
against the JAX package's, float64 on both sides, in train mode (outputs,
BatchNorm statistics, loss, head gradients; `test_torch_heads.py:
depther_case`). Its own file: the JAX depther's DPT head has 256 channels,
whose float64 program takes most of a file's time. The DPT head's eval
mode and the linear depther are held in test_torch_heads.py."""

import pytest

from test_torch_heads import depther_case
from torch_parity import single_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_thread")


def test_depther_dpt():
    depther_case("dpt")
