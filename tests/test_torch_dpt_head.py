"""The port's DPTHead (`models/heads.py`) against the JAX package's, in
eval and train mode, float64 on both sides (`test_torch_heads.py:run_both`,
`check`): reassembly at 4×, 2×, 1× and ½× the patch grid with the exact-GELU
readout and the transposed `up4`/`up2`, the top-down fusion with its
align_corners resizes, the sigmoid depth. Its own file: the JAX head's
float64 program takes most of a file's time."""

import pytest

import jax.numpy as jnp

from adaptersis_tpu.models import heads as jh
from adaptersis_tpu_torch.models import heads as th
from test_torch_heads import B, as_torch, check, run_both, taps, weighted_sum
from torch_parity import single_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_thread")


def test_dpt_head():
    E = 16
    tp = taps(E, seed=3)
    kw = dict(embed_dim=E, channels=8, post_process_channels=(4, 8, 16, 32), max_depth=10.0)
    # a 3 × 4 grid: the ½× stage is 2 × 2, so fusion_3's 2× output (4 × 4)
    # is resized to the 3 × 4 stage
    jl, tl = weighted_sum((B, 24, 32, 1), 4)
    want, got = run_both(
        jh.DPTHead(**kw), th.DPTHead(**kw),
        lambda dt: [[(jnp.asarray(p, dt), jnp.asarray(c, dt)) for p, c in tp]],
        lambda: [as_torch(tp)], jl, tl)
    assert want[0].min() >= 0.001 and want[0].max() <= 10.0
    check(want, got)
