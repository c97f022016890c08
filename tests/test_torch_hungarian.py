"""The port's batched LAPJV (`ops/hungarian.py`) against scipy's
linear_sum_assignment and the JAX package's `lapjv_impl`, on random and
padded cost matrices: the same total cost (within 1e-5 of its scale), and
every assignment one-to-one."""

import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

import jax
import jax.numpy as jnp

from adaptersis_tpu.ops.hungarian import lapjv_impl
from adaptersis_tpu_torch.ops.hungarian import lapjv

Q = 8
PER_G = 25              # matrices per segment count: 200 over G = 1 .. Q


def _costs(kind: str, G: int, seed: int) -> np.ndarray:
    """PER_G (Q, G) fp32 costs at scales 0.1 to 10; "padded": a random
    subset of the columns set to 1e6 (missing segments, as the loss pads
    them), at least one real."""
    rng = np.random.default_rng(seed)
    c = (rng.standard_normal((PER_G, Q, G)) * rng.choice([0.1, 1.0, 10.0], (PER_G, 1, 1)))
    if kind == "padded":
        pad = rng.uniform(size=(PER_G, 1, G)) < 0.5
        pad[..., 0] = False
        c = np.where(pad, 1e6, c)
    return c.astype(np.float32)


def _total(c: np.ndarray, pairs: np.ndarray) -> float:
    return float(c[pairs[0], pairs[1]].astype(np.float64).sum())


@pytest.mark.parametrize("kind", ["random", "padded"])
def test_lapjv_matches_scipy_and_jax(kind):
    jax_solve = jax.jit(lapjv_impl)
    for G in range(1, Q + 1):
        c = _costs(kind, G, seed=G + (100 if kind == "padded" else 0))
        got = lapjv(torch.from_numpy(c)).numpy()
        theirs = np.asarray(jax_solve(jnp.asarray(c)))
        assert got.shape == (PER_G, 2, G)
        for b in range(PER_G):
            r, k = linear_sum_assignment(c[b].astype(np.float64))
            want = float(c[b][r, k].astype(np.float64).sum())
            real = c[b][c[b] < 1e5]
            tol = 1e-5 * max(1.0, np.abs(real).max() * G)
            assert len(set(got[b, 0])) == G and list(got[b, 1]) == list(range(G))
            assert abs(_total(c[b], got[b]) - want) <= tol, (G, b)
            assert abs(_total(c[b], theirs[b]) - want) <= tol, (G, b)


def test_lapjv_on_ties_and_a_known_assignment():
    cost = torch.tensor([[[1.0, 10.0], [10.0, 1.0]], [[10.0, 1.0], [1.0, 10.0]]])
    out = lapjv(cost).numpy()
    assert dict(zip(out[0, 0], out[0, 1])) == {0: 0, 1: 1}
    assert dict(zip(out[1, 0], out[1, 1])) == {0: 1, 1: 0}
    # all costs equal: any one-to-one assignment is optimal
    ties = lapjv(torch.zeros(3, 5, 4)).numpy()
    assert all(len(set(t[0])) == 4 for t in ties)


def test_lapjv_refuses_more_segments_than_queries():
    with pytest.raises(ValueError, match="G <= Q"):
        lapjv(torch.zeros(1, 2, 3))


def test_lapjv_in_float64_and_batched_over_layers():
    """The batch axis carries images and decoder layers alike; fp64 costs
    are solved in fp64."""
    c = np.random.default_rng(7).standard_normal((40, 16, 2))
    got = lapjv(torch.from_numpy(c)).numpy()
    for b in range(40):
        r, k = linear_sum_assignment(c[b])
        assert abs(_total(c[b], got[b]) - c[b][r, k].sum()) <= 1e-12
