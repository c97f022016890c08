"""Port's forward-only attention (adaptersis_tpu_torch/ops/flash_fwd.py)
against the JAX package's Pallas kernel in interpret mode.

The JAX kernel needs the walk padded to a multiple of 128 with a validity
row; the port takes the true length. Ragged lengths stand in, scaled down,
for the walks' 1765 (clean) and 1764 (adapter) tokens."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import adaptersis_tpu.ops.flash_fwd as jax_flash
import adaptersis_tpu_torch.ops.flash_fwd as ff
from torch_parity import n, pallas_interpret, t  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("pallas_interpret")

# fp32 on both sides; the two differ only in summation order and in the TPU
# kernel's constant row-max clamp, which cancels exactly while |S| < 60
ATOL = 1e-5


def _qkv(B, H, N, Dh, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, N, Dh)).astype(np.float32) for _ in range(3)]


# 117/116 stand in for the walks' ragged lengths; 127, 128, 129 and 257
# sit around the CUDA kernel's 128-row query and key tiles
@pytest.mark.parametrize("N", [117, 116, 127, 128, 129, 200, 257])
def test_plain_matches_jax_kernel(N):
    B, H, Dh = 2, 2, 64
    q, k, v = _qkv(B, H, N, Dh, seed=N)
    Np = -(-N // 128) * 128
    pad = ((0, 0), (0, 0), (0, Np - N), (0, 0))
    valid = np.broadcast_to((np.arange(Np) < N).astype(np.int32)[None], (B, Np))
    ref = jax_flash.flash_fwd(*(jnp.asarray(np.pad(a, pad)) for a in (q, k, v)),
                              jnp.asarray(valid), 0.125)
    out = ff.flash_fwd_plain(t(q), t(k), t(v), 0.125)
    np.testing.assert_allclose(n(out), np.asarray(ref)[:, :, :N], atol=ATOL, rtol=0)


def test_cpu_tensor_takes_plain_path_without_launch():
    q, k, v = (t(a) for a in _qkv(1, 2, 37, 64, seed=1))
    before = ff.launches
    out = ff.flash_fwd(q, k, v, 0.125)
    assert ff.launches == before
    torch.testing.assert_close(out, ff.flash_fwd_plain(q, k, v, 0.125), rtol=0, atol=0)


def test_other_devices_raise_instead_of_falling_back():
    q = torch.empty(1, 2, 37, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ff.flash_fwd(q, q, q, 0.125)


def test_refuses_to_drop_a_gradient():
    """No backward, like the JAX kernel: an input that needs a gradient
    raises on any device (meta stands in for CUDA: the check comes first);
    under no_grad, as the frozen walks run, the call goes through."""
    q, k, v = (t(a) for a in _qkv(1, 2, 37, 64, seed=2))
    k.requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        ff.flash_fwd(q, k, v, 0.125)
    with torch.no_grad():
        assert ff.flash_fwd(q, k, v, 0.125).shape == q.shape
    qm = torch.empty(1, 2, 37, 64, device="meta", requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        ff.flash_fwd(qm, qm, qm, 0.125)
