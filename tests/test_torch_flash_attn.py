"""K7's plain version (`flash_attn_plain`, the CPU path of `flash_attn`)
against the library Pallas TPU flash attention that the JAX package calls
through `_sdpa_flash` and `_flash_bhnd`, run in interpret mode: forward and
dq/dk/dv, packed, single-segment, interleaved and tile-straddling segment
ids, lengths that are no multiple of 128 (the JAX side pads to 128; the port
does not); and the tile-skipping rule the kernels walk by (`live_tiles`)."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

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
    if kind == "straddle":           # boundaries one token past a 64-token tile edge
        sizes = [65, 63, 65, N - 193]
        row = np.repeat(np.arange(len(sizes)), sizes)
        return np.broadcast_to(row.astype(np.int32), (B, N)).copy()
    return None


def _straddle_keys(q, k, ids):
    """The key of each token that ends its segment one past a tile edge
    (64, 192) gets 4·Σ q/√n over its segment: it carries most of the
    segment's probability mass."""
    row = ids[0]
    for t in (64, 192):
        own = row == row[t]
        k[:, :, t] = 4 * q[:, :, own].sum(-2) / np.sqrt(own.sum())


@pytest.mark.parametrize("layout,kind,N", [("bnhd", "packed", 97), ("bhnd", "none", 130),
                                           ("bnhd", "interleaved", 61),
                                           ("bhnd", "straddle", 200)])
def test_forward_and_gradients_match_library_kernel(layout, kind, N):
    rng = np.random.default_rng(N)
    B, H, Dh, scale = 2, 2, 16, 0.25
    q, k, v, g = (rng.standard_normal((B, H, N, Dh)).astype(np.float32) * s
                  for s in (1.5, 1.5, 1.0, 1.0))
    ids = _ids(kind, B, N, rng)
    if kind == "straddle":
        _straddle_keys(q, k, ids)
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


STUDENT = np.repeat(np.arange(5), [257, 50, 50, 50, 50]).astype(np.int32)


def _shares_an_id(a: np.ndarray, b: np.ndarray) -> bool:
    return bool(np.intersect1d(a, b).size)


@settings(max_examples=60, deadline=None, database=None)
@given(st.integers(1, 600), st.sampled_from([64, 128]), st.sampled_from([64, 128]),
       st.booleans(), st.integers(0, 2 ** 31 - 1))
def test_live_tiles_skips_only_pairs_without_a_shared_id(N, rows, cols, runs, seed):
    """Every tile pair `live_tiles` skips holds no query-key pair of one
    segment, on sorted runs of ids (the packed crops) and on interleaved
    ids; every pair that shares an id is walked."""
    rng = np.random.default_rng(seed)
    if runs:
        ids = np.sort(rng.integers(0, 1 + N // 7, (2, N)), axis=1)
    else:
        ids = rng.integers(0, 4, (2, N))
    live = fa.live_tiles(torch.from_numpy(ids.astype(np.int32)), rows, cols).numpy()
    assert live.shape == (2, -(-N // rows), -(-N // cols))
    for b in range(2):
        for i in range(live.shape[1]):
            for j in range(live.shape[2]):
                meet = _shares_an_id(ids[b, i * rows:(i + 1) * rows],
                                     ids[b, j * cols:(j + 1) * cols])
                assert meet <= live[b, i, j]


@pytest.mark.parametrize("rows,cols,walked", [(64, 64, 34), (128, 128, 12), (64, 128, 20)])
def test_live_tiles_of_the_student_rows(rows, cols, walked):
    """The SSL student's packed row (257 + 4 × 50 tokens): the counts the
    kernels' walks are sized by, equal to the exact count of tile pairs
    that share an id."""
    ids = torch.from_numpy(np.broadcast_to(STUDENT, (2, STUDENT.size)).copy())
    live = fa.live_tiles(ids, rows, cols)
    n = -(-STUDENT.size // rows), -(-STUDENT.size // cols)
    assert live.shape == (2, *n) and int(live[0].sum()) == walked
    exact = sum(_shares_an_id(STUDENT[i * rows:(i + 1) * rows], STUDENT[j * cols:(j + 1) * cols])
                for i in range(n[0]) for j in range(n[1]))
    assert exact == walked


@pytest.mark.parametrize("n,walked", [
    (1, torch.zeros(2, dtype=torch.int32)), (2, torch.zeros(2, dtype=torch.int64)),
    (2, torch.zeros(4, dtype=torch.int32)[::2]), (1, torch.zeros((1, 1), dtype=torch.int32))])
def test_walk_counter_is_checked(n, walked):
    """The kernels' walk counters (`walked=`: one int32 for the forward, two
    for the backward) are refused in any other form before a launch."""
    with pytest.raises(ValueError, match="walked"):
        fa._walked("flash_attn", walked, n, walked.device)
    fa._walked("flash_attn", torch.zeros(n, dtype=torch.int32), n, torch.device("cpu"))
    fa._walked("flash_attn", None, n, torch.device("cpu"))
