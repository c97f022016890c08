"""The validation losses and metrics of the main trainer (counterparts of the
JAX package's `losses/dice.py:dc_loss`, `losses/cross_entropy.py:
weighted_ce_pair` and `losses/iou_multi.py:pixel_accuracy`). Channel-last
logits (B, H, W, C), integer labels (B, H, W)."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def dc_loss(output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """DC loss: softmax → one-hot → per-(batch, class) dice over the spatial
    axes, 10e-20 in the denominator, 1 − mean."""
    C = output.shape[-1]
    p = torch.softmax(output, dim=-1)
    y = F.one_hot(target.long(), C).to(p.dtype)
    intersect = (p * y).sum(dim=(1, 2))
    dice = 2 * intersect / (p.sum(dim=(1, 2)) + y.sum(dim=(1, 2)) + 10e-20)
    return 1.0 - dice.mean()


def weighted_ce_pair(logits: torch.Tensor, labels: torch.Tensor,
                     weight: Sequence[float] = (0.1, 10.0)) -> torch.Tensor:
    """Cross-entropy with class weights [0.1, 10], mean weighted by the
    per-pixel target weight."""
    C = logits.shape[-1]
    w = torch.tensor(weight, dtype=torch.float32, device=logits.device)
    return F.cross_entropy(logits.reshape(-1, C).float(), labels.reshape(-1).long(),
                           weight=w)


def pixel_accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """mean(argmax == label)."""
    return (logits.argmax(dim=-1) == labels).float().mean()
