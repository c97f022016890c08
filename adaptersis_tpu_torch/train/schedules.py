"""The learning-rate schedule of the trainer (counterpart of the JAX
package's `train/schedules.py:cosine_annealing`)."""

from __future__ import annotations

import math
from typing import Callable


def cosine_annealing(base_lr: float, total_epochs: int,
                     eta_min: float = 0.0) -> Callable[[int], float]:
    """torch's CosineAnnealingLR stepped once per epoch:
    lr(e) = eta_min + (base_lr − eta_min)·(1 + cos(π·e/T))/2."""

    def lr(epoch: int) -> float:
        return eta_min + (base_lr - eta_min) * (1 + math.cos(math.pi * epoch / total_epochs)) / 2

    return lr
