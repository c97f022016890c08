"""K7's fp32 arithmetic on the tensor cores (adaptersis_tpu_torch/ops/tf32.py
`flash_attn_fwd_tf32`, `flash_attn_bwd_tf32`: the 3×TF32 products of
csrc/flash_attn_{fwd,bwd}.cu) against the library Pallas TPU flash attention
that the JAX package calls (`_flash_bhnd`), run in interpret mode, at the
kernels' head width of 64, on packed and tile-straddling segment ids and
lengths that are no multiple of 64: o, dq, dk and dv against the library's,
lse against float64, each element within the fp32 bound that chip_smoke.py
holds the CUDA kernels to (`k7_allowances`: ulp(|ref| + ε) + ε from each
element's own terms). Three passes stay well inside it; one pass (operands
rounded to tf32, what a kernel without the split computes) falls outside.
Also: the kernel a card call of K7 reports, and the tile pairs the fp32
kernels walk."""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adaptersis_tpu.models.layers import _flash_bhnd
from adaptersis_tpu_torch.ops import _build, flash_attn as fa, tf32
from torch_parity import library_flash_interpret, n, single_thread  # noqa: F401  (fixtures)

pytestmark = pytest.mark.usefixtures("library_flash_interpret", "single_thread")

B, H, DH, SCALE = 2, 2, 64, 0.125
NAMES = ("o", "lse", "dq", "dk", "dv")


def _ids(kind: str, N: int) -> np.ndarray:
    if kind == "packed":             # a global crop and 3 local crops per row
        n_loc = (N - 37) // 3
        row = np.r_[np.zeros(N - 3 * n_loc), np.repeat(np.arange(1, 4), n_loc)]
    else:                            # boundaries one token past a tile edge (64, 128, 192)
        row = np.repeat(np.arange(4), [65, 64, 64, N - 193])
    return np.broadcast_to(row.astype(np.int32), (B, N)).copy()


def _inputs(kind: str, N: int):
    """q, k, v (scores of std ≈ 2.25, as chip_smoke.py's `k7_inputs`) and an
    incoming gradient; in the straddle case the key of each token that ends
    its segment one past a tile edge carries most of its segment's mass."""
    rng = np.random.default_rng(N)
    q, k, v, g = (rng.standard_normal((B, H, N, DH)).astype(np.float32) * s
                  for s in (1.5, 1.5, 1.0, 1.0))
    ids = _ids(kind, N)
    if kind == "straddle":
        for t in (64, 128, 192):
            own = ids[0] == ids[0, t]
            k[:, :, t] = 3 * q[:, :, own].sum(-2) / np.sqrt(own.sum())
    return q, k, v, g, ids


def _ulp(v):
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(v), 1e-30))) - 23)


def _allowances(q, k, v, g, ids, ref):
    """chip_smoke.py's `k7_allowances` in fp32 (the backward through the
    kernel's own forward), in float64: o within 2⁻¹⁵·Σ_j p_ij·|v_j|, lse
    within 2e-6·max|lse|, the gradients within 2⁻¹⁵ of their sums of
    |terms| plus what p's and ds's error (2⁻¹⁶ of p, the lse bound, and o's
    bound through di) moves them by."""
    q, k, v, g = (x.astype(np.float64) for x in (q, k, v, g))
    f, r = 2.0 ** -15, 2.0 ** -16
    t = (lambda x: np.swapaxes(x, -1, -2))
    s = q @ t(k) * SCALE
    s = np.where(ids[:, None, :, None] == ids[:, None, None, :], s, -np.inf)
    lse = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
    p = np.exp(s - lse[..., None])

    def bound(x, e):
        return _ulp(np.abs(x) + e) + e

    o_b = bound(ref[0], f * (p @ np.abs(v)))
    lse_b = np.full_like(lse, 2e-6 * np.abs(lse).max())
    di = (ref[0] * g).sum(-1, keepdims=True)
    ds = np.abs((g @ t(v) - di) * p * SCALE)
    a = (np.abs(g) @ t(np.abs(v)) + np.abs(di)) * p * SCALE
    dsd = a * (r + lse_b[..., None]) + p * SCALE * (o_b * np.abs(g)).sum(-1, keepdims=True)
    return lse, [o_b, lse_b, bound(ref[2], f * (ds @ np.abs(k)) + dsd @ np.abs(k)),
                 bound(ref[3], f * (t(ds) @ np.abs(q)) + t(dsd) @ np.abs(q)),
                 bound(ref[4], t(p * (f + r)) @ np.abs(g))]


@pytest.mark.parametrize("kind,N", [("packed", 97), ("straddle", 200)])
def test_emulated_fp32_k7_within_bound_and_one_pass_outside(kind, N):
    q, k, v, g, ids = _inputs(kind, N)
    jids = jnp.asarray(ids)

    def attn(a, b, c):
        return _flash_bhnd(a, b, c, SCALE, N, segment_ids=jids)[:, :, :N]

    o, grads = jax.jit(lambda a, b, c, d: (lambda o, f: (o, f(d)))(*jax.vjp(attn, a, b, c)))(
        *(jnp.asarray(x) for x in (q, k, v, g)))
    want = [np.asarray(o, np.float64), None, *(np.asarray(x, np.float64) for x in grads)]
    want[1], allow = _allowances(q, k, v, g, ids, want)
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    tid = torch.from_numpy(ids)
    shares = {}
    for passes in (3, 1):
        out, lse = tf32.flash_attn_fwd_tf32(tq, tk, tv, SCALE, tid, passes)
        got = [out, lse, *tf32.flash_attn_bwd_tf32(tq, tk, tv, out, lse, tg, SCALE, tid,
                                                   passes)]
        shares[passes] = {name: float((np.abs(n(x).astype(np.float64) - w) / a).max())
                          for name, x, w, a in zip(NAMES, got, want, allow)}
    assert all(s <= 0.25 for s in shares[3].values()), shares
    assert all(s > 1.0 for s in shares[1].values()), shares


@pytest.mark.parametrize("dtype,Dh,kernel", [(torch.float32, 64, "tf32x3"),
                                             (torch.bfloat16, 64, "wgmma"),
                                             (torch.float32, 32, "cuda_cores"),
                                             (torch.bfloat16, 16, "cuda_cores")])
def test_k7_names_the_kernel_a_card_call_runs(dtype, Dh, kernel):
    """The wrappers count a card call under the name of the AttnKernel code
    that `asis_flash_attn_fwd` and `asis_flash_attn_bwd` report (`KERNELS`
    follows the enum; both launchers pick the kernel by Dh and dtype alike).
    A CPU call counts nothing."""
    src = (_build.CSRC / "flash_attn.cuh").read_text()
    enum = re.search(r"enum AttnKernel \{([^}]*)\}", src).group(1)
    codes = {name: int(code) for name, code in re.findall(r"(\w+) = (\d+)", enum)}
    constant = {"wgmma": "kAttnWgmma", "tf32x3": "kAttnTf32x3",
                "cuda_cores": "kAttnCudaCores"}[kernel]
    assert fa.KERNELS[codes[constant]] == kernel
    for name in ("flash_attn_fwd.cu", "flash_attn_bwd.cu"):
        body = (_build.CSRC / name).read_text()
        assert "*kernel = is_bf16 ? asis::kAttnWgmma : asis::kAttnTf32x3;" in body
        assert "*kernel = asis::kAttnCudaCores;" in body
    q = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 2, 9, Dh),
                                                                   np.float32)).to(dtype)
    before = dict(fa.path_launches), dict(fa.bwd_path_launches)
    fa.flash_attn(q.requires_grad_(), q, q, 0.125).sum().backward()
    assert (fa.path_launches, fa.bwd_path_launches) == before


@pytest.mark.parametrize("dtype,fwd,bwd", [(torch.float32, 20, 59), (torch.bfloat16, 20, 34)])
def test_live_tiles_at_each_dtypes_tiles(dtype, fwd, bwd):
    """The SSL student's packed row (257 + 4 × 50 tokens) at the tile pairs
    the Dh-64 kernels of each dtype walk (`FWD_TILES`, `BWD_TILES`): the
    counts chip_smoke.py holds their walk counters to. The backward's pairs
    are the same from the keys' side (dK/dV) and the queries' (dQ)."""
    ids = torch.from_numpy(np.broadcast_to(
        np.repeat(np.arange(5), [257, 50, 50, 50, 50]).astype(np.int32), (2, 457)).copy())
    assert int(fa.live_tiles(ids, *fa.FWD_TILES[dtype])[0].sum()) == fwd
    rows, cols = fa.BWD_TILES[dtype]
    live = fa.live_tiles(ids, rows, cols)
    assert int(live[0].sum()) == bwd
    assert torch.equal(fa.live_tiles(ids, cols, rows), live.transpose(1, 2))
