"""Lovász-softmax loss (counterpart of the JAX package's `losses/lovasz.py`):
per class, the errors |target − prob| sorted in descending order, dotted
with the Lovász extension's gradient of the sorted ground truth."""

from __future__ import annotations

import torch


def lovasz_grad(gt_sorted: torch.Tensor) -> torch.Tensor:
    """The Lovász extension's gradient at sorted errors."""
    gts = gt_sorted.sum()
    intersection = gts - torch.cumsum(gt_sorted, 0)
    union = gts + torch.cumsum(1.0 - gt_sorted, 0)
    jaccard = 1.0 - intersection / union
    if gt_sorted.shape[0] > 1:
        jaccard = torch.cat([jaccard[:1], jaccard[1:] - jaccard[:-1]])
    return jaccard


def lovasz_softmax(probs: torch.Tensor, labels: torch.Tensor,
                   reduction: str = "mean") -> torch.Tensor:
    """probs (B, H, W, C), labels (B, H, W); the batch and the pixels form
    one set, as in the reference. The sort is stable."""
    C = probs.shape[-1]
    p = probs.reshape(-1, C).float()
    lab = labels.reshape(-1)
    losses = []
    for c in range(C):
        target = (lab == c).float()
        errors = (target - p[:, 0 if C == 1 else c]).abs()
        order = torch.argsort(-errors, stable=True)
        losses.append(torch.dot(errors[order], lovasz_grad(target[order])))
    losses = torch.stack(losses)
    if reduction == "none":
        return losses
    if reduction == "sum":
        return losses.sum()
    return losses.mean()
