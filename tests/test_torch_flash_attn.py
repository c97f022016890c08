"""K7's plain version (`flash_attn_plain`, the CPU path of `flash_attn`)
against the library Pallas TPU flash attention that the JAX package calls
through `_sdpa_flash` and `_flash_bhnd`, run in interpret mode: forward and
dq/dk/dv, packed, single-segment and interleaved segment ids, lengths that
are no multiple of 128 (the JAX side pads to 128; the port does not)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adaptersis_tpu.models.layers import _flash_bhnd, _sdpa_flash
from adaptersis_tpu_torch.ops import flash_attn as fa
from torch_parity import library_flash_interpret, n  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("library_flash_interpret")

# fp32 on both sides: the same products summed in other orders, and the
# backward's p from the logsumexp (the port) or from the max and the sum
# (the library). A probe read 4.8e-7 (forward) and 3.8e-6 (gradients).
ATOL = 1e-5


def _ids(kind: str, B: int, N: int, rng) -> np.ndarray:
    if kind == "packed":             # a global crop and 3 local crops per row
        n_loc = (N - 37) // 3
        row = np.r_[np.zeros(N - 3 * n_loc), np.repeat(np.arange(1, 4), n_loc)]
        return np.broadcast_to(row.astype(np.int32), (B, N)).copy()
    if kind == "interleaved":        # any ids, in any order, per row
        return rng.integers(0, 3, (B, N)).astype(np.int32)
    return None


@pytest.mark.parametrize("layout,kind,N", [("bnhd", "packed", 97), ("bhnd", "none", 130),
                                           ("bnhd", "interleaved", 61)])
def test_forward_and_gradients_match_library_kernel(layout, kind, N):
    rng = np.random.default_rng(N)
    B, H, Dh, scale = 2, 2, 16, 0.25
    q, k, v, g = (rng.standard_normal((B, H, N, Dh)).astype(np.float32) * s
                  for s in (1.5, 1.5, 1.0, 1.0))
    ids = _ids(kind, B, N, rng)
    jids = None if ids is None else jnp.asarray(ids)

    def jax_attn(q, k, v):          # (B, H, N, Dh) in and out
        if layout == "bhnd":
            return _flash_bhnd(q, k, v, scale, N, segment_ids=jids)[:, :, :N]
        t = (lambda x: x.transpose(0, 2, 1, 3))
        return t(_sdpa_flash(t(q), t(k), t(v), scale, segment_ids=jids))

    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    want, want_grads = jax.jit(lambda a, b, c, d: (lambda o, f: (o, f(d)))(
        *jax.vjp(jax_attn, a, b, c)))(jq, jk, jv, jnp.asarray(g))

    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tid = None if ids is None else torch.from_numpy(ids)
    out = fa.flash_attn(tq, tk, tv, scale, tid)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(n(out), np.asarray(want), atol=ATOL, rtol=0)
    for got, w in zip((tq.grad, tk.grad, tv.grad), want_grads):
        np.testing.assert_allclose(n(got), np.asarray(w), atol=ATOL, rtol=0)


def test_bf16_rounding_points_match_library_kernel():
    """bf16 in and out: the plain version rounds p and ds where the library
    kernel does, so the two differ by output roundings only: where the fp32
    values straddle a rounding point, one bf16 ulp, ≤ 2⁻⁷·max|out|."""
    rng = np.random.default_rng(3)
    B, H, N, Dh = 1, 2, 97, 16
    q, k, v, g = (rng.standard_normal((B, H, N, Dh)).astype(np.float32) for _ in range(4))
    ids = _ids("packed", B, N, rng)
    jq, jk, jv, jg = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, g))
    def attn(a, b, c):
        return _flash_bhnd(a, b, c, 0.25, N, segment_ids=jnp.asarray(ids))[:, :, :N]

    want, want_grads = jax.jit(lambda a, b, c, d: (lambda o, f: (o, f(d)))(
        *jax.vjp(attn, a, b, c)))(jq, jk, jv, jg)
    tq, tk, tv = (torch.from_numpy(x).bfloat16().requires_grad_() for x in (q, k, v))
    out = fa.flash_attn(tq, tk, tv, 0.25, torch.from_numpy(ids))
    out.backward(torch.from_numpy(g).bfloat16())
    for got, w in zip((out, tq.grad, tk.grad, tv.grad), (want, *want_grads)):
        assert got.dtype == torch.bfloat16
        w = np.asarray(w.astype(jnp.float32))
        np.testing.assert_allclose(n(got.float()), w, atol=2.0 ** -7 * np.abs(w).max(), rtol=0)


def test_plain_backward_is_the_gradient_of_the_forward():
    """The explicit plain backward (the library's formulas) against float64
    autograd of softmax attention with −inf masking, no JAX involved."""
    rng = np.random.default_rng(5)
    B, H, N, Dh = 2, 3, 40, 32
    q, k, v, g = (torch.from_numpy(rng.standard_normal((B, H, N, Dh))) for _ in range(4))
    ids = torch.from_numpy(rng.integers(0, 4, (B, N)).astype(np.int32))
    leaves = [x.float().requires_grad_() for x in (q, k, v)]
    out = fa.flash_attn_plain(*leaves, 0.2, ids)
    out.backward(g.float())
    ref = [x.clone().requires_grad_() for x in (q, k, v)]
    s = ref[0] @ ref[1].transpose(-1, -2) * 0.2
    s = s.masked_fill(ids[:, None, :, None] != ids[:, None, None, :], float("-inf"))
    want = torch.softmax(s, -1) @ ref[2]
    want.backward(g)
    np.testing.assert_allclose(n(out), want.detach().numpy(), atol=2e-6, rtol=0)
    for a, b in zip(leaves, ref):
        np.testing.assert_allclose(n(a.grad), b.grad.numpy(), atol=1e-5, rtol=0)


def test_lse_and_kernel_entry_points():
    """The forward's logsumexp; the kernel functions refuse CPU tensors (a
    CUDA tensor launches the kernel or raises, never the plain version)."""
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 9, 16)).astype(np.float32))
               for _ in range(3))
    o, lse = fa.flash_attn_fwd_plain(q, k, v, 0.5)
    want = torch.logsumexp((q.double() @ k.double().transpose(-1, -2)) * 0.5, -1)
    np.testing.assert_allclose(lse.numpy(), want.numpy(), atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attn_fwd_kernel(q, k, v, 0.5)
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attn_bwd_kernel(q, k, v, o, lse, o, 0.5)
    assert fa.launches == 0 and fa.bwd_launches == 0
