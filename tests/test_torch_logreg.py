"""The port's logistic-regression sweep (`evals/log_regression.py`:
optax's `lbfgs()` written out in torch) against the JAX package's
`_fit_one` on the same numpy-seeded blobs: the weights at a
well-conditioned C, and the objective and validation accuracy at every C
of a short sweep."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adaptersis_tpu.evals.log_regression import _fit_one as jax_fit_one
from adaptersis_tpu_torch.evals import logreg_sweep
from adaptersis_tpu_torch.evals.log_regression import Objective, fit_one
from test_torch_evals import blobs
from torch_parity import n, single_thread, t  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_thread")

LOGREG_DATA = dict(n_rows=192, d=8, c=3, spread=1.0)


@functools.lru_cache(maxsize=None)
def _jax_fit():
    """The JAX fit at 100 iterations, C traced: one compile for every C."""
    return jax.jit(lambda f, yy, C: jax_fit_one(f, yy, 3, C, 100))


def test_logreg_weights_at_a_well_conditioned_c():
    x, y = blobs(**LOGREG_DATA)
    w_j, b_j = _jax_fit()(jnp.asarray(x), jnp.asarray(y), 0.1)
    w, b = fit_one(t(x), torch.from_numpy(y), 3, 0.1)
    np.testing.assert_allclose(n(w), np.asarray(w_j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(n(b), np.asarray(b_j), rtol=0, atol=1e-5)


def test_logreg_sweep_objective_and_accuracy():
    """At every C of the sweep, up to the weakly regularised 1e4 where 100
    iterations do not converge: the objective of the port's weights within
    1e-4 of the JAX weights' (float64 evaluation), and the same validation
    accuracy, as the JAX sweep computes it."""
    x, y = blobs(**LOGREG_DATA)
    xv, yv = blobs(96, 8, 3, seed=2, spread=1.0)
    Cs = (1e-2, 1.0, 1e2, 1e4)
    want = {}
    for C in Cs:
        w_j, b_j = _jax_fit()(jnp.asarray(x), jnp.asarray(y), C)
        want[C] = float((jnp.argmax(jnp.asarray(xv) @ w_j + b_j, -1) == jnp.asarray(yv)).mean())
        w, b = fit_one(t(x), torch.from_numpy(y), 3, C)
        obj = Objective(t(x).double(), torch.from_numpy(y), 3, C)
        f_j = float(obj.value_and_grad(torch.cat([
            torch.from_numpy(np.array(w_j)).double().reshape(-1),
            torch.from_numpy(np.array(b_j)).double()]))[0])
        f_t = float(obj.value_and_grad(torch.cat([w.double().reshape(-1), b.double()]))[0])
        assert f_t == pytest.approx(f_j, rel=1e-4), C
    best, got = logreg_sweep(t(x), torch.from_numpy(y), t(xv), torch.from_numpy(yv),
                             num_classes=3, Cs=Cs)
    assert got == pytest.approx(want, abs=1e-9)
    assert best == max(want, key=want.get)
