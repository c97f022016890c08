"""Logistic-regression sweep on frozen features (counterpart of the JAX
package's `evals/log_regression.py`, DINOv2's `eval/log_regression.py`):
a full-batch multinomial logistic regression per inverse regularisation
strength C, fitted by L-BFGS, the best C picked on the validation set.

The solver is optax's `lbfgs()` as the JAX package runs it, written out in
plain torch so that the iterates follow the same algorithm (at weakly
regularised C, 100 iterations do not converge, and `torch.optim.LBFGS`,
with its own stopping rules and meaning of `max_iter`, lands elsewhere):
  * a memory of 10 (parameter, gradient) differences and the two-loop
    recursion, the initial inverse Hessian ⟨s,y⟩/⟨y,y⟩·I, at the first
    step min(1, 1/‖g‖)·I (`optax.scale_by_lbfgs`);
  * the zoom line search (`optax.scale_by_zoom_linesearch`: at most 20
    steps, first guess 1, doubling while searching the interval, then
    cubic, quadratic or bisection points; sufficient decrease with slope
    tolerance 1e-4 or the approximate Wolfe condition at 1e-6 of the
    value, curvature 0.9; a safe step when it fails), whose last value and
    gradient the next iteration reuses;
  * exactly `max_iter` iterations.
The line search's scalars are fp32 (numpy float32), so its arithmetic is
the JAX solver's; the objective is Σ cross-entropy + ½‖w‖²/C over a flat
parameter vector (w row-major (D, classes), then b) with its gradient in
closed form."""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

MEMORY = 10
LS_STEPS = 20
SLOPE_RTOL, CURV_RTOL, APPROX_DEC_RTOL = 1e-4, 0.9, 1e-6
INCREASE, INTERVAL_THRESHOLD = 2.0, 1e-5
_F = np.float32


class Objective:
    """f(θ) = Σ_i CE(x_i·w + b, y_i) + ½‖w‖²/C with θ = [w.flatten(), b]."""

    def __init__(self, features: torch.Tensor, labels: torch.Tensor, num_classes: int,
                 C: float):
        self.x, self.y = features, labels.long()
        self.D, self.K, self.C = features.shape[1], num_classes, C

    def split(self, theta: torch.Tensor):
        n = self.D * self.K
        return theta[:n].view(self.D, self.K), theta[n:]

    def value_and_grad(self, theta: torch.Tensor):
        w, b = self.split(theta)
        logits = self.x @ w + b
        lse = torch.logsumexp(logits, -1)
        ce = (lse - logits.gather(1, self.y[:, None])[:, 0]).sum()
        d = torch.exp(logits - lse[:, None])
        d[torch.arange(d.shape[0], device=d.device), self.y] -= 1.0
        gw = self.x.t() @ d + w / self.C
        return ce + 0.5 * (w * w).sum() / self.C, torch.cat([gw.reshape(-1), d.sum(0)])


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    C = fpa
    db, dc = b - a, c - a
    denom = (db * dc) ** 2 * (db - dc)
    r1, r2 = fb - fa - C * db, fc - fa - C * dc
    A = (dc ** 2 * r1 - db ** 2 * r2) / denom
    B = (-(dc ** 3) * r1 + db ** 3 * r2) / denom
    return a + (-B + np.sqrt(B * B - _F(3.0) * A * C)) / (_F(3.0) * A)


def _quadmin(a, fa, fpa, b, fb):
    db = b - a
    B = (fb - fa - fpa * db) / (db ** 2)
    return a - fpa / (_F(2.0) * B)


def _errors(step, value, slope, value_init, slope_init):
    """(decrease error, curvature error) of a trial step."""
    dec = value - value_init - _F(SLOPE_RTOL) * step * slope_init
    approx = max(slope - (_F(2 * SLOPE_RTOL) - _F(1.0)) * slope_init,
                 value - value_init - _F(APPROX_DEC_RTOL) * abs(value_init))
    dec = _F(np.inf) if np.isnan(dec) or np.isnan(approx) else max(min(approx, dec), _F(0.0))
    curv = abs(slope) - _F(CURV_RTOL) * abs(slope_init)
    curv = _F(np.inf) if np.isnan(curv) else max(curv, _F(0.0))
    return dec, curv


def zoom_linesearch(fn, theta, d, value, grad):
    """optax's zoom line search from θ, where f = `value` (fp32) and ∇f =
    `grad`, along d: (step size, value, gradient) at the step it returns. The scalars are numpy float32 (fp32 arithmetic
    as the JAX solver's, without a card round trip per operation); the
    trial points θ + η·d and their values and gradients are tensors."""
    with np.errstate(all="ignore"):
        return _zoom(fn, theta, d, value, grad)


def _trial(fn, theta, d, step):
    v, g = fn(theta + float(step) * d)
    return _F(v.item()), g, _F(torch.dot(g, d).item())


def _zoom(fn, theta, d, value, grad):
    zero = _F(0.0)
    slope0 = _F(torch.dot(d, grad).item())
    st = dict(stepsize=zero, value=value, grad=grad, slope=slope0, dec=_F(np.inf),
              low=zero, value_low=value, slope_low=slope0, high=zero, value_high=value,
              slope_high=slope0, cubic_ref=zero, value_cubic_ref=value, safe=zero,
              safe_value=value, safe_grad=grad)
    interval_found = False
    for count in range(LS_STEPS):
        if not interval_found:
            new = _F(1.0) if count == 0 else _F(INCREASE) * st["stepsize"]
            v, g, s = _trial(fn, theta, d, new)
            dec, curv = _errors(new, v, s, value, slope0)
            err = max(dec, curv)
            if dec <= 0.0:
                st.update(safe=new, safe_value=v, safe_grad=g)
            high_new = dec > 0.0 or (v >= st["value"] and count > 0)
            low_new = s >= 0.0 and not high_new
            prev = (st["stepsize"], st["value"], st["slope"])
            low, high = ((new, v, s), prev) if low_new else (prev, (new, v, s))
            st.update(low=low[0], value_low=low[1], slope_low=low[2], high=high[0],
                      value_high=high[1], slope_high=high[2], cubic_ref=low[0],
                      value_cubic_ref=low[1])
            done = err <= 0.0
            interval_found = high_new or low_new or done
            failed = count + 1 >= LS_STEPS and not done
        else:
            low, high = st["low"], st["high"]
            delta = abs(high - low)
            left, right = min(high, low), max(high, low)
            cubic = _cubicmin(low, st["value_low"], st["slope_low"], high, st["value_high"],
                              st["cubic_ref"], st["value_cubic_ref"])
            quad = _quadmin(low, st["value_low"], st["slope_low"], high, st["value_high"])
            if left + _F(0.2) * delta < cubic < right - _F(0.2) * delta:
                new = cubic
            elif left + _F(0.1) * delta < quad < right - _F(0.1) * delta:
                new = quad
            else:
                new = (low + high) / _F(2.0)
            v, g, s = _trial(fn, theta, d, new)
            dec, curv = _errors(new, v, s, value, slope0)
            done = max(dec, curv) <= 0.0
            if dec <= 0.0 and v < st["safe_value"]:
                st.update(safe=new, safe_value=v, safe_grad=g)
            high_mid = dec > 0.0 or v >= st["value_low"]
            high_low = s * (high - low) >= 0.0 and not high_mid
            cur_low = (low, st["value_low"], st["slope_low"])
            cur_high = (high, st["value_high"], st["slope_high"])
            ref = cur_high if (high_mid or high_low) else cur_low
            if high_mid:
                cur_high = (new, v, s)
            elif high_low:
                cur_high = cur_low
            if not high_mid:
                cur_low = (new, v, s)
            st.update(low=cur_low[0], value_low=cur_low[1], slope_low=cur_low[2],
                      high=cur_high[0], value_high=cur_high[1], slope_high=cur_high[2],
                      cubic_ref=ref[0], value_cubic_ref=ref[1])
            failed = (count + 1 >= LS_STEPS
                      or (delta <= INTERVAL_THRESHOLD and st["safe"] > 0.0)) and not done
        st.update(stepsize=new, value=v, grad=g, slope=s, dec=dec)
        if failed:
            if st["safe"] > 0.0 or np.isinf(st["dec"]):
                st.update(stepsize=st["safe"], value=st["safe_value"], grad=st["safe_grad"])
            break
        if done:
            break
    return st["stepsize"], st["value"], st["grad"]


def _ftz(v: torch.Tensor) -> torch.Tensor:
    """v with a subnormal value flushed to zero, as XLA's CPU arithmetic
    does (1/⟨s,y⟩ of a subnormal ⟨s,y⟩ would overflow to inf and make the
    direction NaN once the gradient vanishes)."""
    return torch.where(v.abs() < torch.finfo(v.dtype).tiny, torch.zeros_like(v), v)


class LBFGS:
    """optax `lbfgs()`'s direction: memory of `memory` (s, y) pairs."""

    def __init__(self, n: int, dtype, device, memory: int = MEMORY):
        self.m = memory
        self.s = torch.zeros((memory, n), dtype=dtype, device=device)
        self.y = torch.zeros((memory, n), dtype=dtype, device=device)
        self.rho = torch.zeros(memory, dtype=dtype, device=device)
        self.count = 0
        self.prev_theta = torch.zeros(n, dtype=dtype, device=device)
        self.prev_grad = torch.zeros(n, dtype=dtype, device=device)

    def direction(self, theta: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
        """−P·g after storing this step's (θ − θ_prev, g − g_prev)."""
        idx, prev = self.count % self.m, (self.count - 1) % self.m
        if self.count > 0:
            ds, dy = theta - self.prev_theta, grad - self.prev_grad
            sy = _ftz(torch.dot(dy, ds))
            self.s[prev], self.y[prev] = ds, dy
            self.rho[prev] = torch.where(sy == 0.0, torch.zeros_like(sy), 1.0 / sy)
            yy = _ftz(torch.dot(dy, dy))
            scale = torch.where(yy > 0.0, sy / yy, torch.ones_like(sy))
        else:
            self.s[prev], self.y[prev], self.rho[prev] = 0.0, 0.0, 0.0
            scale = torch.clamp(1.0 / torch.linalg.norm(grad), max=1.0)
        order = [(idx + j) % self.m for j in range(self.m)]
        vec, alphas = grad, {}
        for j in reversed(order):
            alphas[j] = self.rho[j] * torch.dot(self.s[j], vec)
            vec = vec - alphas[j] * self.y[j]
        vec = scale * vec
        for j in order:
            beta = self.rho[j] * torch.dot(self.y[j], vec)
            vec = vec + (alphas[j] - beta) * self.s[j]
        self.count += 1
        self.prev_theta, self.prev_grad = theta, grad
        return -vec


def fit_one(features: torch.Tensor, labels: torch.Tensor, num_classes: int, C: float,
            max_iter: int = 100) -> Tuple[torch.Tensor, torch.Tensor]:
    """(w (D, classes), b) after `max_iter` L-BFGS iterations from zero."""
    obj = Objective(features, labels, num_classes, C)
    n = obj.D * num_classes + num_classes
    theta = torch.zeros(n, dtype=features.dtype, device=features.device)
    solver = LBFGS(n, features.dtype, features.device)
    value = grad = None
    for _ in range(max_iter):
        # the line search's last value and gradient, unless it left none
        # finite (optax's `value_and_grad_from_state`)
        if value is None or not np.isfinite(value):
            value, grad = obj.value_and_grad(theta)
            value = _F(value.item())
        d = solver.direction(theta, grad)
        step, value, grad = zoom_linesearch(obj.value_and_grad, theta, d, value, grad)
        theta = theta + float(step) * d
    w, b = obj.split(theta)
    return w.clone(), b.clone()


def logreg_sweep(train_features, train_labels, val_features, val_labels, num_classes: int,
                 Cs: Sequence[float] = tuple(float(c) for c in np.logspace(-4, 4, 9)),
                 max_iter: int = 100) -> Tuple[float, Dict[float, float]]:
    """(best C, {C: validation accuracy}), fp32 on the features' device; the
    first of equal bests in the order of `Cs`."""
    f = torch.as_tensor(train_features).float()
    y = torch.as_tensor(train_labels).to(f.device)
    vf = torch.as_tensor(val_features).float().to(f.device)
    vy = torch.as_tensor(val_labels).to(f.device)
    accs: Dict[float, float] = {}
    for C in Cs:
        w, b = fit_one(f, y, num_classes, float(C), max_iter)
        accs[float(C)] = ((vf @ w + b).argmax(-1) == vy).float().mean().item()
    return max(accs, key=accs.get), accs
