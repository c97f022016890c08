"""Schedules (counterpart of the JAX package's `train/schedules.py`): the
trainer's per-epoch cosine learning rate, and the SSL step's per-iteration
cosine arrays with warm-up and a frozen prefix."""

from __future__ import annotations

import math
from typing import Callable

import numpy as np


def cosine_annealing(base_lr: float, total_epochs: int,
                     eta_min: float = 0.0) -> Callable[[int], float]:
    """torch's CosineAnnealingLR stepped once per epoch:
    lr(e) = eta_min + (base_lr − eta_min)·(1 + cos(π·e/T))/2."""

    def lr(epoch: int) -> float:
        return eta_min + (base_lr - eta_min) * (1 + math.cos(math.pi * epoch / total_epochs)) / 2

    return lr


def cosine_scheduler(base_value: float, final_value: float, epochs: int,
                     niter_per_ep: int, warmup_epochs: int = 0,
                     start_warmup_value: float = 0.0, freeze_iters: int = 0) -> np.ndarray:
    """Per-iteration values: `freeze_iters` zeros, a linear warm-up from
    start_warmup_value to base_value over warmup_epochs, then a cosine from
    base_value to final_value (DINOv2's CosineScheduler)."""
    total = epochs * niter_per_ep
    freeze_iters = min(freeze_iters, total)
    warmup_iters = min(warmup_epochs * niter_per_ep, total - freeze_iters)
    warmup = (np.linspace(start_warmup_value, base_value, warmup_iters) if warmup_iters
              else np.array([]))
    n_cos = total - warmup_iters - freeze_iters
    cos = (final_value + 0.5 * (base_value - final_value)
           * (1 + np.cos(np.pi * np.arange(n_cos) / max(n_cos, 1))))
    out = np.concatenate([np.zeros(freeze_iters), warmup, cos])
    assert len(out) == total
    return out
